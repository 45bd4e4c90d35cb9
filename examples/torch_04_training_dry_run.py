"""Training-step sanity check without datasets (port version of
`04_training_dry_run.py`): ten steps of the XFeat trainer on one fixed
random batch, checkpoints on the way.

    python examples/torch_04_training_dry_run.py [--device cpu]

Runs on the GPU unless given `--device cpu`. Under `torchrun` the same
command trains over a mesh of ranks (`--mesh DxM`, see
`torch_06_multigpu_scaling.py`).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = ap.parse_known_args()
    from accelerated_features_tpu_torch.train.run import main as train
    ckpt = tempfile.mkdtemp(prefix="xfeat_dry_")
    history = train(["--ckpt_save_path", ckpt, "--dry_run", "--batch_size",
                     "4", "--training_res", "64,64", "--max_corrs", "64",
                     "--save_ckpt_every", "5", "--device", args.device,
                     *rest])
    print(f"{len(history)} steps, loss {history[0]['loss_total']:.4f} -> "
          f"{history[-1]['loss_total']:.4f}; checkpoints in {ckpt}: "
          f"{sorted(os.listdir(ckpt))}")


if __name__ == "__main__":
    main()
