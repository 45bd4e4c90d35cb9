from .backbone import (XFeatModel, fine_matcher_forward, space_to_depth,
                       upsample_bilinear, xfeat_forward)
from .lighterglue import (LighterGlue, import_lighterglue_state_dict,
                          init_lighterglue_params, lighterglue_forward)
from .params import (count_params, export_torch_state_dict, fold_batchnorm,
                     import_torch_state_dict, init_xfeat_params,
                     load_lighterglue_params, load_params, params_from_jax)

__all__ = ["XFeatModel", "xfeat_forward", "fine_matcher_forward",
           "space_to_depth", "upsample_bilinear", "init_xfeat_params",
           "import_torch_state_dict", "export_torch_state_dict",
           "fold_batchnorm", "count_params", "LighterGlue",
           "lighterglue_forward", "init_lighterglue_params",
           "import_lighterglue_state_dict", "load_params",
           "load_lighterglue_params", "params_from_jax"]
