"""`mfu.images` (%, moves `images_per_s`): the model's operations done in the
traced window (the backbone's convolutions, MNN's similarity,
LighterGlue's linears, its attention over the kept keys and its
assignment; `counts.py`), over the window at the TF32 peak."""

from xfeat_bench.readers import mfu_pct


def read(run):
    return mfu_pct(run)
