"""Sequence-parallel LighterGlue: keypoint-sharded attention matching, the
counterpart of the JAX package's `parallel/lighterglue_sp.py`.

Both keypoint sets are split over the mesh's 'model' axis. Every
pointwise op (projections, rotary encoding, the feed-forward nets) runs
on the rank's own keypoints; per layer the keys and values are
all-gathered, so each rank's query rows attend over every key. That
attention is `models.lighterglue._attention`: kernel D
(`ops/cuda/attention.py`) on the card, the same function as the JAX
package's dense `_attend`, and its plain version on the CPU.

The assignment head runs on (M/n, N) slabs: the row softmax is local
(whole rows), the column log-sum-exp is the all-reduced max and sum of
exponentials, and the mutual argmax takes the column maxima and argmaxes
all-gathered, the first rank holding the maximum winning, as
`parallel.matching.mnn_match_sp` does. The (M+1, N+1) log-assignment is
never built; the entry point returns matches and confidences, gathered
on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.lighterglue import (NEG, _apply, _attention, _ffn,
                                  apply_rotary, normalize_keypoints,
                                  rotary_encoding)
from ..ops.precision import full_fp32_matmuls
from .mesh import Mesh, shard_on


@full_fp32_matmuls()
def lighterglue_forward_sp(mesh: Mesh, params: Dict[str, Any],
                           kpts0: torch.Tensor, kpts1: torch.Tensor,
                           descs0: torch.Tensor, descs1: torch.Tensor,
                           size0: torch.Tensor, size1: torch.Tensor,
                           mask0: Optional[torch.Tensor] = None,
                           mask1: Optional[torch.Tensor] = None,
                           heads: int = 1, axis: str = "model",
                           filter_threshold: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keypoint-sharded LighterGlue forward. kpts0 (B,M,2), kpts1 (B,N,2),
    descs (B,.,64), whole on every rank; M and N divisible by the size of
    `axis`. Returns (matches0 (B,M) int64, -1 where unmatched; mscores0
    (B,M)) on every rank: `lighterglue_forward`'s matches0 and mscores0
    (without pruning), with the confidence gate `filter_threshold`."""
    b, m, _ = kpts0.shape
    n = kpts1.shape[1]
    nd, me = mesh.size(axis), mesh.index(axis)
    if m % nd or n % nd:
        raise ValueError(f"M={m} and N={n} must divide over {nd} ranks")
    dev = kpts0.device
    if mask0 is None:
        mask0 = torch.ones((b, m), dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones((b, n), dtype=torch.bool, device=dev)
    k0, d0, v0 = shard_on(mesh, (kpts0, descs0, mask0), axis, dim=1)
    k1, d1, v1 = shard_on(mesh, (kpts1, descs1, mask1), axis, dim=1)
    m_loc = k0.shape[1]

    def gather(x):
        return mesh.all_gather(x.contiguous(), axis, dim=1)

    x0 = _apply(params["input_proj"], d0.float())
    x1 = _apply(params["input_proj"], d1.float())
    cos0, sin0 = rotary_encoding(normalize_keypoints(k0.float(), size0),
                                 params["posenc_wr"])
    cos1, sin1 = rotary_encoding(normalize_keypoints(k1.float(), size1),
                                 params["posenc_wr"])

    def self_block(p, x, cos, sin, vmask):
        q, k, v = _apply(p["qkv"], x).chunk(3, dim=-1)
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        ctx = _attention(q, gather(k), gather(v), vmask, heads)
        return _ffn(p, x, _apply(p["out"], ctx))

    def cross_block(p, x0, x1):
        qk0, qk1 = _apply(p["to_qk"], x0), _apply(p["to_qk"], x1)
        vv0, vv1 = _apply(p["to_v"], x0), _apply(p["to_v"], x1)
        msg0 = _attention(qk0, gather(qk1), gather(vv1), mask1, heads)
        msg1 = _attention(qk1, gather(qk0), gather(vv0), mask0, heads)
        return (_ffn(p, x0, _apply(p["to_out"], msg0)),
                _ffn(p, x1, _apply(p["to_out"], msg1)))

    for layer in params["layers"]:
        x0 = self_block(layer["self"], x0, cos0, sin0, mask0)
        x1 = self_block(layer["self"], x1, cos1, sin1, mask1)
        x0, x1 = cross_block(layer["cross"], x0, x1)

    asg = params["assignments"][-1]
    dim = x0.shape[-1]
    md0 = _apply(asg["final_proj"], x0) / dim ** 0.25          # (B,m_loc,D)
    md1 = gather(_apply(asg["final_proj"], x1) / dim ** 0.25)  # (B,N,D)
    sim = torch.matmul(md0, md1.transpose(1, 2))               # (B,m_loc,N)
    sim = torch.where(mask1[:, None, :], sim, NEG)
    sim = torch.where(v0[:, :, None], sim, NEG)
    z0 = _apply(asg["matchability"], x0)[..., 0]
    z1 = gather(_apply(asg["matchability"], x1)[..., 0])

    scores0 = torch.log_softmax(sim, dim=2)                    # rows: local
    gmax = mesh.all_reduce(sim.max(dim=1).values, axis, op="max")  # (B,N)
    loc_sum = torch.exp(sim - gmax[:, None, :]).sum(dim=1)
    lse = torch.log(mesh.all_reduce(loc_sum, axis)) + gmax
    inner = (scores0 + (sim - lse[:, None, :])
             + F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :])

    best0, m0 = inner.max(dim=2).values, inner.argmax(dim=2)   # (B,m_loc)
    col_max = inner.max(dim=1).values                           # (B,N)
    col_arg = inner.argmax(dim=1) + me * m_loc
    all_max = mesh.all_gather(col_max, axis, tiled=False)       # (nd,B,N)
    all_arg = mesh.all_gather(col_arg, axis, tiled=False)
    m1 = torch.gather(all_arg, 0, all_max.argmax(dim=0)[None])[0]

    rows = me * m_loc + torch.arange(m_loc, device=dev)[None]
    mutual = torch.gather(m1, 1, m0) == rows
    mscores = torch.where(mutual, torch.exp(best0), 0.0)
    ok = mutual & v0
    if filter_threshold > 0.0:
        ok = ok & (mscores >= filter_threshold)
    matches0 = torch.where(ok, m0, -1)
    mscores = torch.where(ok, mscores, 0.0)
    return gather(matches0), gather(mscores)


__all__ = ["lighterglue_forward_sp"]
