"""Distributed bundle adjustment over the mesh: the counterpart of the
JAX package's `parallel/ba.py`.

`sfm/ba.bundle_adjust` is written in per-observation products and
segment sums, with hooks `reduce_cam` and `reduce_pt` applied after every
camera- and point-space sum. Two layouts:

* `bundle_adjust_sharded`: the observation table split over 'data',
  cameras and points replicated; both hooks are an all-reduce sum.
* `bundle_adjust_point_sharded`: the map split (`partition_by_point`,
  owner computes): each rank owns every n-th point, its V^-1 blocks and
  all its observations; only camera-space sums are all-reduced
  (`reduce_pt` is the identity).

A rank's partial sums run through fixed padded tables, so they are
deterministic; the all-reduce adds the ranks' partials in the order of
NCCL or gloo, so a sharded solve agrees with one device within float
rounding amplified by the LM loop, not bit for bit. The accounting
functions (`collective_accounting`, `flops_accounting`,
`hbm_accounting`, `predicted_weak_scaling`) are the JAX package's
arithmetic.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..sfm.ba import BAProblem, bundle_adjust
from .mesh import Mesh, shard_on


def pad_observations(p: BAProblem, multiple: int) -> BAProblem:
    """Pad the observation table to a multiple of `multiple` rows
    (masked rows)."""
    n = p.obs_cam.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return p

    def pad(t):
        return torch.cat([t, t.new_zeros((rem,) + tuple(t.shape[1:]))])
    return p._replace(obs_cam=pad(p.obs_cam), obs_pt=pad(p.obs_pt),
                      obs_uv=pad(p.obs_uv), obs_mask=pad(p.obs_mask))


def _summer(mesh: Mesh, axis: str):
    return lambda t: mesh.all_reduce(t, axis)


def bundle_adjust_sharded(p: BAProblem, mesh: Mesh, iters: int = 20,
                          lam0: float = 1e-3, cg_iters: int = 50,
                          axis: str = "data"
                          ) -> Tuple[BAProblem, Dict[str, torch.Tensor]]:
    """LM-BA with the observations split over `axis`: every rank holds
    the whole problem and solves on its share of the (padded) table, the
    partial sums all-reduced. Returns the solved problem (its table the
    padded one) and the 0-d costs and lambda, on every rank."""
    p = pad_observations(p, mesh.size(axis))
    obs = shard_on(mesh, (p.obs_cam, p.obs_pt, p.obs_uv, p.obs_mask), axis)
    local = p._replace(obs_cam=obs[0], obs_pt=obs[1], obs_uv=obs[2],
                       obs_mask=obs[3])
    solved, stats = bundle_adjust(local, iters=iters, lam0=lam0,
                                  cg_iters=cg_iters,
                                  reduce_fn=_summer(mesh, axis))
    return p._replace(cams=solved.cams, points=solved.points), stats


def partition_by_point(p: BAProblem, ndev: int
                       ) -> Tuple[BAProblem, torch.Tensor]:
    """Reorder the problem so that points AND their observations shard
    over `ndev` ranks (owner computes).

    Point i goes to rank i % ndev, local slot i // ndev; every observation
    moves to its point's owner shard and its obs_pt becomes the LOCAL
    point index. A rank's memory is then O(P/ndev + C): the V^-1 blocks,
    b_p and the back-substitution stay on the owner, and only C-sized
    camera sums cross the interconnect.

    Returns the reordered, padded problem (leading dimensions divisible by
    ndev; shard s is the contiguous block s) and the index that maps the
    reordered points back to the original order."""
    dev = p.points.device
    n_pts = int(p.points.shape[0])
    ppad = (-n_pts) % ndev
    ploc = (n_pts + ppad) // ndev

    pts = p.points.detach().cpu().numpy()
    pts = np.concatenate([pts, np.zeros((ppad, 3), pts.dtype)])
    owner = np.arange(n_pts + ppad) % ndev
    slot = np.arange(n_pts + ppad) // ndev
    new_index = owner * ploc + slot                  # old id -> new row
    pts_sh = np.empty_like(pts)
    pts_sh[new_index] = pts

    obs_cam = p.obs_cam.cpu().numpy()
    obs_pt = p.obs_pt.cpu().numpy()
    obs_uv = p.obs_uv.cpu().numpy()
    obs_mask = p.obs_mask.cpu().numpy()
    obs_owner = np.where(obs_mask, obs_pt % ndev, -1)

    counts = [int(np.sum(obs_owner == d)) for d in range(ndev)]
    nloc = max(max(counts), 1)
    nloc += (-nloc) % 8

    oc = np.zeros((ndev, nloc), obs_cam.dtype)
    op = np.zeros((ndev, nloc), obs_pt.dtype)
    ouv = np.zeros((ndev, nloc, 2), obs_uv.dtype)
    om = np.zeros((ndev, nloc), bool)
    for d in range(ndev):
        sel = obs_owner == d
        n = counts[d]
        oc[d, :n] = obs_cam[sel]
        op[d, :n] = obs_pt[sel] // ndev              # LOCAL point index
        ouv[d, :n] = obs_uv[sel]
        om[d, :n] = True

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    q = p._replace(points=t(pts_sh), obs_cam=t(oc.reshape(-1)),
                   obs_pt=t(op.reshape(-1)), obs_uv=t(ouv.reshape(-1, 2)),
                   obs_mask=t(om.reshape(-1)))
    return q, t(new_index)


def collective_accounting(n_cams: int, cg_iters: int = 50,
                          dtype_bytes: int = 4,
                          precond: bool = True) -> Dict[str, float]:
    """Analytic per-LM-iteration interconnect traffic of
    `bundle_adjust_point_sharded`.

    With point-owner sharding only CAMERA-space accumulators ride the
    interconnect (reduce_pt is the identity — V blocks, b_p, and
    back-substitution never leave the owning device). Per LM iteration
    the all-reduced arrays are, in program order (sfm/ba.py):

      build_normal_blocks: U (C,6,6), b_c (C,6), cost ()
      ba_step S_diag:      (C,6,6) block-Jacobi Schur diagonal
                           (precond=True default)
      ba_step rhs:         (C,6)
      cg_solve:            cg_iters x schur_matvec back-reduce (C,6)
      accept test:         ba_cost () scalar

    A ring all-reduce moves ~2*(n-1)/n ~= 2 bytes per payload byte per
    device, independent of device count — which is WHY the layout weak-
    scales: per-device compute grows with the local observation count
    while wire traffic stays O(C).

    Returns bytes per LM iteration (payload, not wire) and the breakdown.
    """
    C = n_cams
    u_bytes = C * 36 * dtype_bytes
    sdiag_bytes = C * 36 * dtype_bytes if precond else 0
    bc_bytes = C * 6 * dtype_bytes
    rhs_bytes = C * 6 * dtype_bytes
    cg_bytes = cg_iters * C * 6 * dtype_bytes
    scalar_bytes = 2 * dtype_bytes
    total = (u_bytes + sdiag_bytes + bc_bytes + rhs_bytes + cg_bytes
             + scalar_bytes)
    return {
        "U": u_bytes, "S_diag": sdiag_bytes, "b_c": bc_bytes,
        "rhs": rhs_bytes, "cg_matvecs": cg_bytes,
        "cost_scalars": scalar_bytes,
        "per_lm_iteration": total,
    }


def flops_accounting(n_obs_local: int, n_cams: int, n_pts_local: int,
                     cg_iters: int = 50) -> float:
    """Approximate per-device FLOPs per LM iteration (principal terms;
    sfm/ba.py):

      residuals + forward-mode Jacobians  ~ 650 flops/obs
      normal-block builds (U, V, W, b_*)  ~ 290 flops/obs
      per CG iter: W/W^T products 72/obs + U x 72/cam + Vinv z 36/pt
      back-substitution                   ~ 110 flops/obs
    """
    N, C, Ploc = n_obs_local, n_cams, n_pts_local
    fixed = N * (650 + 290 + 110)
    per_cg = 72 * N + 72 * C + 36 * Ploc
    return float(fixed + cg_iters * per_cg)


def hbm_accounting(n_obs_local: int, n_pts_local: int,
                   cg_iters: int = 50) -> float:
    """Approximate per-device HBM bytes per LM iteration — the binding
    resource for this op mix (per-observation einsums and segment-sums
    stream (N,2,6)/(N,6,3) tensors; arithmetic intensity is ~1-2
    flops/byte, far below the TPU's ~25 flops/byte ridge):

      residual+Jacobian build: write r/Jc/Jp     ~ 100 B/obs
      normal blocks U,V,W,b_*: read Jc/Jp, write ~ 220 B/obs
      per CG iter (schur_matvec): re-read W (72) + gathers/writes
                                                 ~ 170 B/obs
      back-substitution + cost                   ~ 120 B/obs
      point-space V/Vinv traffic                 ~ 150 B/pt (once)
    """
    N, Ploc = n_obs_local, n_pts_local
    return float(N * (100 + 220 + 120) + 150 * Ploc
                 + cg_iters * 170 * N)


def predicted_weak_scaling(n_cams: int, n_pts_per_dev: int,
                           obs_per_pt: float, ndev: int,
                           cg_iters: int = 50,
                           ici_bandwidth: float = 4.5e10,
                           flops_rate: float = 2.0e13,
                           hbm_bandwidth: float = 8.1e11,
                           hop_latency: float = 1e-6,
                           precond: bool = True) -> Dict[str, float]:
    """Predicted weak-scaling efficiency of point-sharded BA: per-device
    problem size FIXED (n_pts_per_dev points with obs_per_pt
    observations each), camera set shared.

    The defaults are the JAX package's, a model of a TPU v5e slice, so
    that both packages return the same numbers from the same arguments;
    they are not rates of any GPU. For an H100 pass its own (NVLink
    450 GB/s each way, HBM 3.35 TB/s) and a measured op-mix rate. Model
    parameters:
      * `ici_bandwidth`: one-way per-chip all-reduce payload bandwidth,
        bytes/s. 4.5e10 is a conservative v5e figure.
      * `flops_rate`: achieved f32 rate for this op mix. Segment-sums
        and (N,2,6)-shaped einsums run far below matmul peak; 20
        Tflop/s (~10% of bf16 peak) is the measured ballpark for
        gather/scatter-heavy TPU kernels.
      * `hop_latency`: per-ICI-hop launch+traversal latency. A ring
        all-reduce over n chips serializes ~2(n-1) hops, so each
        collective costs 2(n-1)*hop_latency + payload-bytes*2/BW.

      * `hbm_bandwidth`: per-chip HBM bandwidth (v5e: ~819 GB/s).

    t_compute = max(FLOPs time, HBM time): this op mix (segment-sums,
    small einsums, gathers) has ~1-2 flops/byte arithmetic intensity,
    so HBM is the binding resource — the FLOPs-only estimate would
    understate per-device time ~30x and with it the scaling efficiency.
    The comm latency term is what a bandwidth-only model hides: each CG
    iteration all-reduces only 24*C bytes (24 KB at C=1000), so the ~53
    collectives/LM-iteration cost more in hops than in bytes. The two
    levers that move the break-even left are fewer CG iterations
    (linear in the latency term) and communication-avoiding s-step CG
    (s iterations per all-reduce).

    efficiency = t_compute / (t_compute + t_comm); compute stays
    constant under weak scaling while comm grows only through the ring
    factor.
    """
    n_obs_local = n_pts_per_dev * obs_per_pt
    fl = flops_accounting(int(n_obs_local), n_cams, n_pts_per_dev, cg_iters)
    hbm = hbm_accounting(int(n_obs_local), n_pts_per_dev, cg_iters)
    t_compute = max(fl / flops_rate, hbm / hbm_bandwidth)
    acct = collective_accounting(n_cams, cg_iters, precond=precond)
    payload = acct["per_lm_iteration"]
    # collectives per LM iteration: U, b_c, rhs, 2 cost scalars,
    # cg_iters matvecs, plus the S_diag sum the block-Jacobi
    # preconditioner adds
    n_collectives = 5 + cg_iters + (1 if precond else 0)
    ring = 2.0 * (ndev - 1) / max(ndev, 1)
    wire = ring * payload
    t_comm = n_collectives * 2 * (ndev - 1) * hop_latency \
        + wire / ici_bandwidth
    eff = t_compute / (t_compute + t_comm)
    return {
        "ndev": ndev,
        "flops_per_dev_per_iter": fl,
        "hbm_bytes_per_dev_per_iter": hbm,
        "payload_bytes_per_iter": payload,
        "wire_bytes_per_iter": wire,
        "n_collectives_per_iter": n_collectives,
        "t_compute_s": t_compute,
        "t_comm_s": t_comm,
        "efficiency": eff,
    }


def bundle_adjust_point_sharded(p: BAProblem, mesh: Mesh, iters: int = 20,
                                lam0: float = 1e-3, cg_iters: int = 50,
                                axis: str = "data"
                                ) -> Tuple[BAProblem, Dict[str, torch.Tensor]]:
    """LM-BA with the MAP split over `axis` (`partition_by_point`): each
    rank owns P/n points, their V^-1 blocks and all their observations;
    cameras are replicated and their sums all-reduced. Every rank passes
    the whole problem and gets the whole solution (points all-gathered,
    in the original order) and the 0-d costs and lambda."""
    n = mesh.size(axis)
    q, inverse = partition_by_point(p, n)
    pts, oc, op, ouv, om = shard_on(
        mesh, (q.points, q.obs_cam, q.obs_pt, q.obs_uv, q.obs_mask), axis)
    local = q._replace(points=pts, obs_cam=oc, obs_pt=op, obs_uv=ouv,
                       obs_mask=om)
    solved, stats = bundle_adjust(local, iters=iters, lam0=lam0,
                                  cg_iters=cg_iters,
                                  reduce_cam=_summer(mesh, axis))
    points = mesh.all_gather(solved.points.contiguous(), axis)
    return p._replace(cams=solved.cams,
                      points=points[inverse][:p.points.shape[0]]), stats


__all__ = ["pad_observations", "bundle_adjust_sharded", "partition_by_point",
           "collective_accounting", "flops_accounting", "hbm_accounting",
           "predicted_weak_scaling", "bundle_adjust_point_sharded"]
