"""Weights drawn from a seed, in the published layout, for a configuration
whose weight entry is `{"seed": n}`.

`lighterglue_state_dict` is the state dict of cvg/LightGlue's `LightGlue`
module (`lightglue/lightglue.py`; kornia's copy keeps the names) at the
configuration's widths, as PyTorch initialises that module: every linear
layer's weight and bias uniform within +-1/sqrt(fan_in), LayerNorm's
weight 1 and bias 0, the Fourier encoding's `Wr` normal with standard
deviation 1 (`gamma` 1). Keys: `input_proj`, `posenc.Wr`, per layer
`self_attn.{i}` (`Wqkv`, `out_proj`, `ffn.0`, `ffn.1` the LayerNorm,
`ffn.3`) and `cross_attn.{i}` (`to_qk`, `to_v`, `to_out`, `ffn.*`), per
layer `log_assignment.{i}` (`matchability`, `final_proj`), and
`token_confidence.{i}.token.0` for all layers but the last. Linear
weights are (out, in).

The draw is two calls of a generator on `device` seeded with the seed,
so the same seed on the same kind of device gives the same float32
values to whoever draws them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch


def _linears(conf: Dict[str, Any]) -> List[Tuple[str, int, int]]:
    """(name, in, out) of every linear layer, in the order drawn."""
    d, n = conf["descriptor_dim"], conf["n_layers"]
    out = [("input_proj", conf["input_dim"], d)]
    for i in range(n):
        s, c = f"self_attn.{i}", f"cross_attn.{i}"
        out += [(f"{s}.Wqkv", d, 3 * d), (f"{s}.out_proj", d, d),
                (f"{s}.ffn.0", 2 * d, 2 * d), (f"{s}.ffn.3", 2 * d, d),
                (f"{c}.to_qk", d, d), (f"{c}.to_v", d, d),
                (f"{c}.to_out", d, d),
                (f"{c}.ffn.0", 2 * d, 2 * d), (f"{c}.ffn.3", 2 * d, d)]
    for i in range(n):
        out += [(f"log_assignment.{i}.matchability", d, 1),
                (f"log_assignment.{i}.final_proj", d, d)]
    for i in range(n - 1):
        out.append((f"token_confidence.{i}.token.0", d, 1))
    return out


def lighterglue_state_dict(conf: Dict[str, Any], seed: int, device
                           ) -> Dict[str, torch.Tensor]:
    """LightGlue's state dict at `conf`'s widths (`input_dim`,
    `descriptor_dim`, `n_layers`, `num_heads`), drawn from `seed`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    lins = _linears(conf)
    total = sum(i * o + o for _, i, o in lins)
    flat = torch.rand(total, generator=gen, device=dev) * 2 - 1
    head_dim = conf["descriptor_dim"] // conf["num_heads"]
    sd = {"posenc.Wr.weight": torch.randn((head_dim // 2, 2), generator=gen,
                                          device=dev)}
    at = 0
    for name, fan_in, fan_out in lins:
        bound = 1.0 / math.sqrt(fan_in)
        w = flat[at:at + fan_in * fan_out].view(fan_out, fan_in) * bound
        at += fan_in * fan_out
        sd[f"{name}.weight"] = w
        sd[f"{name}.bias"] = flat[at:at + fan_out] * bound
        at += fan_out
    width = 2 * conf["descriptor_dim"]
    for i in range(conf["n_layers"]):
        for block in ("self_attn", "cross_attn"):
            sd[f"{block}.{i}.ffn.1.weight"] = torch.ones(width, device=dev)
            sd[f"{block}.{i}.ffn.1.bias"] = torch.zeros(width, device=dev)
    return sd
