"""The readings the limits of `check.py` and of a pipeline's `LIMITS` are
set from, for one cell, in one process on the card:

- the program on every seed of `--seeds`: each distinct request of the
  cell run once through the timed path's entries at the cell's size, and
  judged as a run judges it (the lower readings);
- the control on every seed of `--control-seeds`: the pipeline's
  `Control`, the reference at TF32 in the program's place (the upper
  readings).

    python3 xfeat_bench/readings.py --workload <name> --seeds 1,2,... \
        --control-seeds 21,22,23 [--out FILE]

Each reading is one JSON line on standard output (and in `--out`).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == BENCH:
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    from xfeat_bench import harness
    from xfeat_bench.trace import Tracer

    c = harness.open_cell(args.workload, ROOT)
    pipe, config, traffic = c.pipeline, c.config, c.traffic
    dev = torch.device(args.device)
    out = open(args.out, "a") if args.out else None

    def seeds(text):
        return [int(s) for s in text.split(",") if s.strip()]

    for side, cls, chosen in (("program", pipe.Program, seeds(args.seeds)),
                              ("control", pipe.Control,
                               seeds(args.control_seeds))):
        if not chosen:
            continue
        prog = cls(config, ROOT, dev)
        execute = pipe.Executor(prog, config, traffic, dev, Tracer(),
                                c.views.hw)
        for seed in chosen:
            t0 = time.perf_counter()
            requests = pipe.make_requests(traffic, config, c.views, seed,
                                          dev, ROOT)
            answers = []
            with torch.inference_mode():
                for req in requests:
                    got, extras = execute(req)
                    got = dict(got)
                    got.update({k: v.cpu().numpy()
                                for k, v in extras.items()})
                    answers.append(got)
            t1 = time.perf_counter()
            numbers, _ = pipe.judge(config, traffic, requests, answers,
                                    ROOT, dev)
            line = json.dumps({"workload": args.workload, "side": side,
                               "seed": seed, "numbers": numbers,
                               "answer_s": t1 - t0,
                               "judge_s": time.perf_counter() - t1})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del execute, prog
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if out:
        out.close()
    print(f"readings done in {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
