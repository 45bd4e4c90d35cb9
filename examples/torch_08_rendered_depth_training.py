"""Depth-supervised training on a MegaDepth-layout dataset without any
download (port version of `08_rendered_depth_training.py`), with neither
h5py nor cv2: the committed fixture `tests/fixtures/megadepth_mini` (two
rendered scenes; JPEG and PNG images, HDF5 depth maps) by default, or any
MegaDepth-layout root, e.g. one written by
`python -m accelerated_features_tpu_torch.tools.make_megadepth_fixture`.

It trains the MegaDepth branch a few steps with the whole dataset held on
the device (`--md_resident`), then streamed through the prefetch thread,
and prints the losses.

    python examples/torch_08_rendered_depth_training.py [--device cpu] \\
        [--root MD_ROOT] [--res 256,192]

Runs on the GPU unless given `--device cpu` (at --res 256,192 on the CPU
it takes about a minute).
"""
import argparse
import os
import sys
import tempfile

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--root", default=os.path.join(
        REPO, "tests", "fixtures", "megadepth_mini"))
    ap.add_argument("--res", default="800,608", help="training W,H")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    sys.modules["h5py"] = None    # the depth path needs neither
    sys.modules["cv2"] = None
    from accelerated_features_tpu_torch.train.run import main as train
    for resident in (True, False):
        ckpt = tempfile.mkdtemp(prefix="xfeat_md_")
        history = train(["--ckpt_save_path", ckpt, "--megadepth_root_path",
                         args.root, "--training_type", "xfeat_megadepth",
                         "--batch_size", "6", "--n_steps", str(args.steps),
                         "--training_res", args.res, "--device",
                         args.device, "--save_ckpt_every", str(args.steps)]
                        + (["--md_resident"] if resident else []))
        print(f"{'resident' if resident else 'streamed'}: losses "
              f"{[round(h['loss_total'], 4) for h in history]}, step walls "
              f"s {[round(h['wall_s'], 3) for h in history]}")


if __name__ == "__main__":
    main()
