"""Hub-style entry points of the PyTorch port (counterpart of the
repository's root `hubconf.py`, which serves the JAX package).

    from accelerated_features_tpu_torch import hub
    xfeat = hub.XFeat(weights="artifacts/run_md_ckpt13250.npz")
    matcher = hub.LighterGlue(weights="artifacts/lighterglue_ft_ckpt7791.npz")

`torch.hub.load` reads the root `hubconf.py`, which stays the JAX
package's, so these entries are called as a module. `weights` takes every
format the port reads (`.npz`, `.pt`/`.pth` torch state dicts, in-memory
state dicts, checkpoint directories, numpy trees); None is random, as in
the JAX entries. `device=None` is the card, and raises without one.
"""

dependencies = ["torch", "numpy"]


def XFeat(weights=None, top_k=4096, detection_threshold=0.05, device=None,
          **kwargs):
    """The port's XFeat inference engine (`api.XFeat`)."""
    from .api import XFeat as _XFeat
    return _XFeat(weights=weights, top_k=top_k,
                  detection_threshold=detection_threshold, device=device,
                  **kwargs)


def LighterGlue(weights=None, device=None, **kwargs):
    """The port's LighterGlue matcher (`models.lighterglue.LighterGlue`)
    on `device`."""
    from .api import resolve_device
    from .models.lighterglue import LighterGlue as _LG
    return _LG(weights, resolve_device(device), **kwargs)
