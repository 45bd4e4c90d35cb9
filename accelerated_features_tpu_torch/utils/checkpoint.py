"""Training checkpoints with resume, in the JAX package's `.npz` layout, so
each package reads the other's.

A checkpoint `ckpt_<step:08d>.npz` holds the whole train state flattened
by key path: `params/...` in the JAX layout (conv weights HWIO, linear
weights (in, out); `models.params.params_to_jax`), the optimizer state
under `opt_state/<i>/...` with NamedTuple fields by position (Adam's count,
mu and nu at `opt_state/1/0`, `/1/1/...`, `/1/2/...` for the XFeat
trainer's clip-Adam-schedule chain), and `step`. Restoring also accepts
the field-name keys (`opt_state/0/mu/...`) and the pickled `None`
placeholders of empty optax states that other exports write, as the JAX
package's `restore_checkpoint` does. Tensors come back on the devices and
in the dtypes of the target state.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.params import (_leaf_to_jax, _leaf_to_torch, load_npz_tree,
                             params_from_jax)


def _flatten(tree: Any, prefix: str = "", key: str = "") -> Dict[str, Any]:
    """{key path: JAX-layout numpy leaf}; tuples and lists by position."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/", k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/", str(i)))
    else:
        out[prefix[:-1]] = _leaf_to_jax(key, tree)
    return out


def _name_alias_map(tree: Any, prefix: str = "", nprefix: str = ""
                    ) -> Dict[str, str]:
    """{field-name path: positional path} of every leaf."""
    out: Dict[str, str] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_name_alias_map(v, f"{prefix}{k}/", f"{nprefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            name = fields[i] if fields else str(i)
            out.update(_name_alias_map(v, f"{prefix}{i}/",
                                       f"{nprefix}{name}/"))
    else:
        out[nprefix[:-1]] = prefix[:-1]
    return out


def _list_ckpts(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = re.match(r"ckpt_(\d+)\.npz$", name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out)


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any], step: int,
                    keep: int = 5) -> str:
    """Write the whole train state to `ckpt_dir/ckpt_<step>.npz` and keep
    only the newest `keep` checkpoints. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(state))
    os.replace(tmp, path)  # a kill mid-write leaves no half checkpoint
    for _, old in _list_ckpts(ckpt_dir)[:-keep]:
        os.remove(old)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = _list_ckpts(ckpt_dir)
    return ckpts[-1][1] if ckpts else None


def restore_checkpoint(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """The checkpoint at `path` in the structure of `target`, a train state
    of tensors (which gives each leaf's dtype and device)."""
    with np.load(path, allow_pickle=True) as data:
        flat = {k: data[k] for k in data.keys()}
    flat_target = _flatten(target)
    if set(flat) != set(flat_target):
        alias = _name_alias_map(target)
        flat = {alias.get(k, k): v for k, v in flat.items()}
        flat = {k: v for k, v in flat.items()
                if not (v.dtype == object and v.ndim == 0
                        and v.item() is None)}
    missing = set(flat_target) - set(flat)
    extra = set(flat) - set(flat_target)
    if missing or extra:
        raise KeyError(f"checkpoint/state key mismatch: "
                       f"missing={sorted(missing)[:5]} "
                       f"extra={sorted(extra)[:5]}")

    def rebuild(t, prefix="", key=""):
        if isinstance(t, dict):
            return {k: rebuild(v, f"{prefix}{k}/", k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            seq = [rebuild(v, f"{prefix}{i}/", str(i))
                   for i, v in enumerate(t)]
            return type(t)(*seq) if hasattr(t, "_fields") else type(t)(seq)
        val = _leaf_to_torch(key, flat[prefix[:-1]]) if key == "w" else \
            torch.as_tensor(np.asarray(flat[prefix[:-1]]))
        return val.to(dtype=t.dtype, device=t.device)

    return rebuild(target)


def load_params_from_checkpoint(ckpt_dir_or_path: str) -> Dict[str, Any]:
    """The parameter tree (the port's tensors, BatchNorm unfolded) of a
    checkpoint file, or of the newest checkpoint in a directory."""
    path = ckpt_dir_or_path
    if os.path.isdir(path):
        path = latest_checkpoint(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir_or_path}")
    return params_from_jax(load_npz_tree(path))


def resume_or_init(ckpt_dir: str, init_state: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], bool]:
    """(the newest checkpoint in `ckpt_dir` restored into `init_state`'s
    structure, True), or (init_state, False) when there is none."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return init_state, False
    return restore_checkpoint(path, init_state), True
