"""The port's weights, loaded as a user loads them.

With `pipelines/*.py`, which hold the program's entries, this is the only
module of the benchmark that imports the port
(`accelerated_features_tpu_torch`).

A configuration's weight entry is either a path, relative to the
checkout, of committed weights, or `{"seed": n}`: a state dict in the
published layout drawn on the device by the benchmark's own
`reference/seeded.py`, which the port takes through its importer for that
layout, as a user loads a published checkpoint. The reference
(`reference/weights.py`) draws the same dict and reads it with its own
loader, so both sides hold the same float32 values. Drawing, like reading
a file, counts in set-up.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

import torch

from .reference import seeded

Entry = Union[str, Dict[str, int]]


def weight_path(entry: Entry, root: Path) -> str:
    """The file of a weight entry that has to be a path."""
    if not isinstance(entry, str):
        raise ValueError(f"these weights are read from a committed file; "
                         f"got {entry!r}")
    return str(Path(root) / entry)


def to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def xfeat_params(entry: Entry, root: Path, device) -> Dict[str, Any]:
    """XFeat's backbone from a committed `.npz`."""
    from accelerated_features_tpu_torch.models import params as P
    return to_device(P.load_params(weight_path(entry, root)),
                     torch.device(device))


def lighterglue_params(entry: Entry, conf: Dict[str, Any], root: Path,
                       device) -> Dict[str, Any]:
    """LighterGlue (or LightGlue) of `conf`'s widths: a committed `.npz`,
    or a seeded state dict in the published layout through
    `models.lighterglue.import_lighterglue_state_dict`."""
    from accelerated_features_tpu_torch.models import lighterglue
    from accelerated_features_tpu_torch.models import params as P
    dev = torch.device(device)
    if isinstance(entry, dict):
        sd = seeded.lighterglue_state_dict(conf, entry["seed"], dev)
        return to_device(lighterglue.import_lighterglue_state_dict(sd, conf),
                         dev)
    return to_device(P.load_lighterglue_params(weight_path(entry, root)),
                     dev)
