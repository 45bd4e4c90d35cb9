"""PyTorch/CUDA port of `accelerated_features_tpu`: sparse XFeat, the
semi-dense XFeat* pipeline, the LighterGlue matcher, and the pose path
(`geometry`: the native posekit backend and a batched essential-matrix
RANSAC on the device; `eval`: the relative-pose benchmark harness), the
SfM/SLAM layer (`sfm`), training (`train`), and the batching HTTP server
(`apps/serve.py`) with hub entries (`hub.py`) and the config tree
(`config.py`).

The JAX package stays the reference; this package computes the same
functions with PyTorch and hand-written CUDA kernels for Hopper
(`csrc/`), and never imports JAX or the JAX package.
"""

from .api import XFeat
from .models.backbone import xfeat_forward
from .models.lighterglue import LighterGlue, lighterglue_forward
from .models.params import load_lighterglue_params, params_from_jax

__all__ = ["XFeat", "LighterGlue", "xfeat_forward", "lighterglue_forward",
           "params_from_jax", "load_lighterglue_params"]
