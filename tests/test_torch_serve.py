"""The port's batching inference server (`accelerated_features_tpu_torch/
apps/serve.py`) on the CPU: real HTTP round trips against an in-process
server with random weights, top_k=64, 64x96 images, mirroring
`tests/test_serve.py`. Responses are held to direct calls of the same
`XFeat` under np.array_equal (one process, one device, the same plain
torch path: no tolerance is needed)."""

import io
import json
import socket
import struct
import sys
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from accelerated_features_tpu_torch.apps import serve as serve_mod
from accelerated_features_tpu_torch.apps.serve import serve

THR = 0.012  # random weights: the untrained softmax mass is ~1/65


@pytest.fixture(scope="module")
def server():
    # a 1 s batching window: requests released together still share a
    # batch when the machine is loaded (a lone /detect waits it out)
    httpd = serve(host="127.0.0.1", port=0, weights=None, top_k=64,
                  max_batch=8, max_wait_ms=1000.0, lg_weights="random",
                  device="cpu")
    httpd.service.xfeat.detection_threshold = THR  # /match's threshold
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd
    httpd.service.stop()
    httpd.shutdown()
    httpd.server_close()
    t.join(10)
    assert not t.is_alive()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _status(port, path, body=None):
    """HTTP status of a request that may fail."""
    try:
        if body is None:
            urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   timeout=60).read()
        else:
            _post(port, path, body)
        return 200
    except urllib.error.HTTPError as e:
        return e.code


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _image(seed, shape=(64, 96, 3)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.uint8)


def _assert_equal(resp, direct):
    assert set(resp.files) == {"keypoints", "scores", "descriptors"}
    for k in resp.files:
        np.testing.assert_array_equal(resp[k], direct[k].numpy())


def _burst(port, bodies, path="/detect?threshold=0.012"):
    """Send every body at once (released together by a barrier); the
    responses in order."""
    results = [None] * len(bodies)
    gate = threading.Barrier(len(bodies))

    def call(i):
        gate.wait(30)
        results[i] = np.load(io.BytesIO(_post(port, path, bodies[i])))

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    return results


def test_listen_backlog_holds_a_burst(server):
    """http.server listens with a backlog of 5; a burst of more clients
    overflowed it on the card (the kernel dropped connection requests and
    the clients retried after 1 s), so the port's server asks for 128."""
    assert isinstance(server, serve_mod.Server)
    assert server.request_queue_size == 128
    assert server.socket.getsockopt(socket.SOL_SOCKET, socket.SO_ACCEPTCONN)


def test_detect_matches_direct_api(server):
    port = server.server_address[1]
    img = _image(0)
    out = np.load(io.BytesIO(_post(port, "/detect?threshold=0.012",
                                   _npz(image=img))))
    direct = server.service.xfeat.detectAndCompute(
        img, detection_threshold=THR)[0]
    assert out["keypoints"].shape == (64, 2)
    _assert_equal(out, direct)


def _record_batches(xf, monkeypatch):
    """Record every batch the owner thread hands to detectAndCompute."""
    batches = []
    real = xf.detectAndCompute

    def recorded(x, *a, **kw):
        batches.append(x.clone())
        return real(x, *a, **kw)

    monkeypatch.setattr(xf, "detectAndCompute", recorded)
    return batches


def _direct_by_image(xf, batches):
    """detectAndCompute of each recorded batch, keyed by each image's
    shape and bytes."""
    out = {}
    for b in batches:
        for im, res in zip(b, xf.detectAndCompute(b, detection_threshold=THR)):
            out[(tuple(im.shape), im.numpy().tobytes())] = res
    return out


def test_concurrent_requests_batched(server, monkeypatch):
    """Four requests released together are served by one batched
    detectAndCompute call; each answer equals that call's row for its
    image when the same stack is passed directly."""
    port = server.server_address[1]
    imgs = [_image(10 + i) for i in range(4)]
    xf = server.service.xfeat
    batches = _record_batches(xf, monkeypatch)
    served0 = server.service.served
    results = _burst(port, [_npz(image=im) for im in imgs])
    monkeypatch.undo()
    assert [tuple(b.shape) for b in batches] == [(4, 64, 96, 3)]
    assert server.service.served == served0 + 4
    direct = _direct_by_image(xf, batches)
    for res, im in zip(results, imgs):
        _assert_equal(res, direct[(im.shape, im.tobytes())])


def test_mixed_shapes_bucketed_apart(server, monkeypatch):
    """Concurrent requests of two shapes, interleaved, get one bucket a
    shape (the two of one shape one batch, also when the other shape was
    taken first and they waited in the backlog); each answer equals the
    direct call on its batch."""
    port = server.server_address[1]
    imgs = [_image(20, (64, 96, 3)), _image(21, (96, 64, 3)),
            _image(22, (64, 96, 3))]
    xf = server.service.xfeat
    batches = _record_batches(xf, monkeypatch)
    results = _burst(port, [_npz(image=im) for im in imgs])
    monkeypatch.undo()
    assert sorted(tuple(b.shape) for b in batches) == [(1, 96, 64, 3),
                                                       (2, 64, 96, 3)]
    direct = _direct_by_image(xf, batches)
    for res, im in zip(results, imgs):
        _assert_equal(res, direct[(im.shape, im.tobytes())])


def test_mixed_dtypes_not_cross_contaminated(server):
    """A float [0,1] image and a uint8 image of the same shape arriving
    together land in different buckets and give the same keypoints."""
    port = server.server_address[1]
    img8 = _image(4)
    imgf = img8.astype(np.float32) / 255.0
    r8, rf = _burst(port, [_npz(image=img8), _npz(image=imgf)])
    xf = server.service.xfeat
    _assert_equal(r8, xf.detectAndCompute(img8, detection_threshold=THR)[0])
    _assert_equal(rf, xf.detectAndCompute(imgf, detection_threshold=THR)[0])
    np.testing.assert_array_equal(rf["keypoints"], r8["keypoints"])


@pytest.mark.parametrize("mode", ["mnn", "star", "lighterglue"])
def test_match_modes_equal_direct_calls(server, mode):
    port = server.server_address[1]
    im0 = _image(5)
    im1 = np.roll(im0, 3, axis=1)
    out = np.load(io.BytesIO(_post(port, f"/match?mode={mode}&top_k=64",
                                   _npz(image0=im0, image1=im1))))
    xf = server.service.xfeat
    if mode == "mnn":
        ref = xf.match_xfeat(im0, im1, top_k=64)
    elif mode == "star":
        ref = xf.match_xfeat_star(im0, im1, top_k=64)
    else:
        d0 = xf.detectAndCompute(im0, top_k=64)[0]
        d1 = xf.detectAndCompute(im1, top_k=64)[0]
        d0["image_size"] = d1["image_size"] = (96, 64)
        ref = [m.numpy() for m in xf.match_lighterglue(d0, d1)[:2]]
    assert out["mkpts0"].shape[1] == 2
    if mode == "mnn":
        assert len(out["mkpts0"]) > 0
    np.testing.assert_array_equal(out["mkpts0"], ref[0])
    np.testing.assert_array_equal(out["mkpts1"], ref[1])


def test_healthz_counts_served_requests(server):
    port = server.server_address[1]
    before = server.service.served
    _post(port, "/detect?threshold=0.012", _npz(image=_image(6)))
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as r:
        health = json.loads(r.read())
    assert health == {"ok": True, "backend": "cpu", "served": before + 1}


@pytest.mark.parametrize("path,body,code", [
    ("/detect", b"not an image", 400),
    ("/detect", _npz(other=np.zeros(3)), 400),
    ("/match?mode=bogus", _npz(image0=np.zeros((8, 8), np.uint8),
                               image1=np.zeros((8, 8), np.uint8)), 400),
    ("/match", _npz(image0=np.zeros((8, 8), np.uint8)), 400),
    ("/detect?top_k=many", _npz(image=np.zeros((8, 8), np.uint8)), 400),
    ("/nowhere", b"", 404),
    ("GET /nowhere", None, 404),
], ids=["garbage", "no_image", "bad_mode", "one_image", "bad_query",
        "post_404", "get_404"])
def test_bad_requests(server, path, body, code):
    port = server.server_address[1]
    assert _status(port, path.replace("GET ", ""), body) == code


def _png(img):
    """A minimal 8-bit RGB PNG (filter 0 rows) of an (H,W,3) RGB array."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_body_is_decoded_without_cv2(server, monkeypatch):
    """A PNG body is read by `decode_png`, with cv2 not importable; its
    answer equals the direct call on the decoded BGR image. Another image
    format without cv2 is a 400 that names the accepted formats."""
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises
    port = server.server_address[1]
    rgb = _image(7)
    out = np.load(io.BytesIO(_post(port, "/detect?threshold=0.012",
                                   _png(rgb))))
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    _assert_equal(out, server.service.xfeat.detectAndCompute(
        bgr, detection_threshold=THR)[0])
    with pytest.raises(ValueError, match="npy, .npz or PNG"):
        serve_mod._decode_image(b"\xff\xd8\xff\xe0 a JPEG header")
    assert _status(port, "/detect", b"\xff\xd8\xff\xe0 a JPEG header") == 400


def test_inference_error_is_500(server, monkeypatch):
    """An exception on the owner thread answers 500, and the thread keeps
    serving."""
    port = server.server_address[1]
    xf = server.service.xfeat

    def broken(*a, **kw):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(xf, "match_xfeat", broken)
    monkeypatch.setattr(serve_mod.traceback, "print_exc", lambda **kw: None)
    body = _npz(image0=_image(8), image1=_image(9))
    assert _status(port, "/match", body) == 500
    monkeypatch.undo()
    assert _status(port, "/match", body) == 200


def test_serve_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(port=0, weights=None, top_k=64)
