"""Batching inference server of the PyTorch port (port version of
`07_serving.py`): start it in-process, submit concurrent requests over
real HTTP, and read the npz responses.

In production, run `python -m accelerated_features_tpu_torch.apps.serve
--port 8500 --weights artifacts/run_md_ckpt13250.npz` in its own process
(one process owns the GPU) and talk to it from anywhere; this example
does the same round trip in-process on a free port.

    python examples/torch_07_serving.py [--device cpu]

Runs on the GPU unless given `--device cpu`.
"""
import argparse
import io
import json
import os
import sys
import threading
import urllib.request

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    from accelerated_features_tpu_torch.apps.serve import serve

    httpd = serve(host="127.0.0.1", port=0, weights=None, top_k=512,
                  max_batch=8, max_wait_ms=10.0, device=args.device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    print(f"server on 127.0.0.1:{port}")

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (480, 640, 3)).astype(np.uint8)
    buf = io.BytesIO()
    np.savez(buf, image=img)

    # concurrent same-shape requests are grouped into ONE batched device
    # call by the server's owner thread
    def detect(i, out):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/detect?threshold=0.012",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out[i] = np.load(io.BytesIO(r.read()))

    results = {}
    threads = [threading.Thread(target=detect, args=(i, results))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, out in sorted(results.items()):
        print(f"request {i}: {out['keypoints'].shape[0]} keypoints, "
              f"descriptors {out['descriptors'].shape}")

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as r:
        print("healthz:", json.loads(r.read()))
    httpd.service.stop()
    httpd.shutdown()
    httpd.server_close()
    thread.join(10)


if __name__ == "__main__":
    main()
