"""Read the committed `.npz` weights for the reference.

The files hold flat keys `a/b/0/w`; a training state keeps its weights
under `params/`. Convolutions are stored HWIO, linear layers (in, out).
XFeat's BatchNorm layers are affine-free and carry their running `mean`
and `var`; `load_xfeat` folds them into the convolution before them:
w' = w / sqrt(var + eps), b' = -mean / sqrt(var + eps), in float64, then
rounded to float32.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

BN_EPS = 1e-5


def read_tree(path: str) -> Dict[str, Any]:
    """Nested dicts of numpy arrays; keys made of digits become lists."""
    with np.load(path, allow_pickle=False) as data:
        keys = list(data.keys())
        if any(k.startswith("params/") for k in keys):
            flat = {k[len("params/"):]: data[k] for k in keys
                    if k.startswith("params/")}
        else:
            flat = {k: data[k] for k in keys}
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def _conv(layer: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """HWIO weight (and BatchNorm stats or a bias) -> OIHW weight and a
    bias, the BatchNorm folded in."""
    w = layer["w"].astype(np.float64).transpose(3, 2, 0, 1)
    if "mean" in layer:
        inv = 1.0 / np.sqrt(layer["var"].astype(np.float64) + BN_EPS)
        w = w * inv[:, None, None, None]
        b = -layer["mean"].astype(np.float64) * inv
    else:
        b = layer["b"].astype(np.float64)
    return {"w": torch.tensor(w, dtype=torch.float32, device=device),
            "b": torch.tensor(b, dtype=torch.float32, device=device)}


def load_xfeat(path: str, device) -> Dict[str, Any]:
    """XFeat's backbone: {'skip1': conv, 'block1': [conv, ...], ...} with
    each conv {'w' OIHW, 'b'}, BatchNorm folded."""
    tree = read_tree(path)
    out: Dict[str, Any] = {"skip1": _conv(tree["skip1"], device)}
    for name, layers in tree.items():
        if name in ("skip1", "fine_matcher"):
            continue
        out[name] = [_conv(layer, device) for layer in layers]
    return out


def load_lighterglue(path: str, device) -> Dict[str, Any]:
    """LighterGlue's tree as stored: linear weights (in, out), the
    self-attention projection's outputs ordered [q | k | v], the
    positional encoding's `posenc_wr` (2, head_dim / 2)."""
    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_torch(v) for v in node]
        return torch.tensor(np.asarray(node, np.float32), device=device)

    return to_torch(read_tree(path))
