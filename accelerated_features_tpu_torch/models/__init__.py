from .backbone import XFeatModel, fine_matcher_forward, xfeat_forward
from .lighterglue import LighterGlue, lighterglue_forward
from .params import (fold_batchnorm, load_lighterglue_params, load_params,
                     params_from_jax)

__all__ = ["XFeatModel", "xfeat_forward", "fine_matcher_forward",
           "LighterGlue", "lighterglue_forward", "fold_batchnorm",
           "load_params", "load_lighterglue_params", "params_from_jax"]
