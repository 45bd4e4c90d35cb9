"""Read the weights for the reference: committed `.npz` files, or a
state dict in the published layout drawn from a seed (`seeded.py`).

The files hold flat keys `a/b/0/w`; a training state keeps its weights
under `params/`. Convolutions are stored HWIO, linear layers (in, out).
XFeat's BatchNorm layers are affine-free and carry their running `mean`
and `var`; `load_xfeat` folds them into the convolution before them:
w' = w / sqrt(var + eps), b' = -mean / sqrt(var + eps), in float64, then
rounded to float32.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

from . import seeded

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


def qkv_rows(dim: int, heads: int) -> torch.Tensor:
    """The published self-attention unflattens `Wqkv`'s outputs as
    (heads, head_dim, 3): output h * 3 * head_dim + 3 * j + t is feature j
    of head h of q (t = 0), k (1) or v (2). -> for each output of
    [q | k | v] (each with its heads side by side) its row of `Wqkv`."""
    hd = dim // heads
    return torch.tensor([h * 3 * hd + 3 * j + t for t in range(3)
                         for h in range(heads) for j in range(hd)])


def lighterglue_from_state_dict(sd: Dict[str, torch.Tensor],
                                conf: Dict[str, Any]) -> Dict[str, Any]:
    """A state dict in the published layout (`seeded.py` names its keys)
    -> the tree `load_lighterglue` gives: linear weights (in, out),
    `posenc_wr` (2, head_dim / 2), the projection's outputs [q | k | v].
    `token_confidence` is not read (depth confidence is off)."""
    def lin(name, rows=None):
        w, b = sd[name + ".weight"], sd[name + ".bias"]
        if rows is not None:
            w, b = w[rows], b[rows]
        return {"w": w.T.contiguous(), "b": b}

    def ln(name):
        return {"w": sd[name + ".weight"], "b": sd[name + ".bias"]}

    rows = qkv_rows(conf["descriptor_dim"], conf["num_heads"])
    tree: Dict[str, Any] = {
        "input_proj": lin("input_proj"),
        "posenc_wr": sd["posenc.Wr.weight"].T.contiguous(),
        "layers": [], "assignments": []}
    for i in range(conf["n_layers"]):
        s, c = f"self_attn.{i}", f"cross_attn.{i}"
        tree["layers"].append({
            "self": {"qkv": lin(s + ".Wqkv", rows),
                     "out": lin(s + ".out_proj"), "ffn0": lin(s + ".ffn.0"),
                     "ln": ln(s + ".ffn.1"), "ffn1": lin(s + ".ffn.3")},
            "cross": {"to_qk": lin(c + ".to_qk"), "to_v": lin(c + ".to_v"),
                      "to_out": lin(c + ".to_out"),
                      "ffn0": lin(c + ".ffn.0"), "ln": ln(c + ".ffn.1"),
                      "ffn1": lin(c + ".ffn.3")}})
        tree["assignments"].append({
            "matchability": lin(f"log_assignment.{i}.matchability"),
            "final_proj": lin(f"log_assignment.{i}.final_proj")})
    return tree


def lighterglue(entry: Union[str, Dict[str, int]], conf: Dict[str, Any],
                root: Path, device) -> Dict[str, Any]:
    """A configuration's matcher weights: a committed `.npz` (a path
    relative to `root`) or `{"seed": n}`."""
    if isinstance(entry, dict):
        return lighterglue_from_state_dict(
            seeded.lighterglue_state_dict(conf, entry["seed"], device), conf)
    return load_lighterglue(str(Path(root) / entry), device)
