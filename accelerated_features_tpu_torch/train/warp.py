"""Depth-based ground-truth correspondences of the port: the JAX
package's `train/warp.py` in torch, batched and fixed-shape.

`warp_kpts` carries pixels from one view to the other through dense depth,
`spvs_coarse` gives the /8-grid correspondences that pass a mutual
reprojection check (one per source cell, the highest index winning),
`spvs_full` the full-resolution ones from a jittered grid, and
`corr_to_fixed` packs valid rows first and cuts to a fixed budget. Where
the JAX package takes a key, the port takes a `torch.Generator` on the
data's device, or the draw itself.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def warp_kpts(kpts0: torch.Tensor, depth0: torch.Tensor,
              depth1: torch.Tensor, T_0to1: torch.Tensor, K0: torch.Tensor,
              K1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp (B, L, 2) pixels of view 0 into view 1 through depth0 (B,H,W).
    T_0to1 (B,4,4) or (B,3,4), K (B,3,3). Returns (valid (B,L), warped
    (B,L,2)); depth row 0 and column 0 count as no depth. depth1 is not
    read (the JAX signature)."""
    b, _, _ = kpts0.shape
    h, w = depth0.shape[1:3]
    xi = torch.round(kpts0[..., 0]).long().clamp(0, w - 1)
    yi = torch.round(kpts0[..., 1]).long().clamp(0, h - 1)
    d = torch.gather(depth0.reshape(b, h * w), 1, yi * w + xi)
    d = torch.where((xi == 0) | (yi == 0), 0.0, d)
    valid = d > 0
    pts_h = torch.cat([kpts0, torch.ones_like(kpts0[..., :1])], -1) \
        * d[..., None]
    cam = torch.einsum("bij,blj->bli", torch.linalg.inv(K0), pts_h)
    cam1 = torch.einsum("bij,blj->bli", T_0to1[:, :3, :3], cam) \
        + T_0to1[:, :3, 3][:, None, :]
    proj = torch.einsum("bij,blj->bli", K1, cam1)
    return valid, proj[..., :2] / (proj[..., 2:3] + 1e-5)


def _grid(h: int, w: int, device) -> torch.Tensor:
    """(h*w, 2) xy of a raster grid, x fastest."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([gx, gy], -1).reshape(h * w, 2)


def _mutual(pts1_i: torch.Tensor, data: Dict[str, torch.Tensor]):
    """View-1 points in intrinsics pixels -> (their warp into view 0, the
    mutual reprojection mask: both warps have depth and the round trip
    lands within 1.5 px)."""
    valid1, w_pt1 = warp_kpts(pts1_i, data["depth1"], data["depth0"],
                              data["T_1to0"], data["K1"], data["K0"])
    valid2, w_back = warp_kpts(w_pt1, data["depth0"], data["depth1"],
                               data["T_0to1"], data["K0"], data["K1"])
    dist = torch.linalg.norm(pts1_i - w_back, dim=-1)
    return w_pt1, (dist < 1.5) & valid1 & valid2


def spvs_coarse(data: Dict[str, torch.Tensor], scale: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """/`scale`-grid correspondences with the mutual reprojection check and
    one correspondence per source cell. data: image0/image1 (B,H,W,C),
    depth0/depth1 (B,Hd,Wd), T_0to1/T_1to0 (B,4,4), K0/K1 (B,3,3),
    optional scale0/scale1 (B,2). Returns corrs (B, h1*w1, 4) (x0, y0, x1,
    y1) in grid coordinates and their mask (B, h1*w1)."""
    b, H0, W0 = data["image0"].shape[:3]
    H1, W1 = data["image1"].shape[1:3]
    h0, w0 = H0 // scale, W0 // scale
    h1, w1 = H1 // scale, W1 // scale
    dev = data["depth0"].device
    s0 = scale * (data["scale0"][:, None, :] if data.get("scale0")
                  is not None else 1.0)
    s1 = scale * (data["scale1"][:, None, :] if data.get("scale1")
                  is not None else 1.0)

    grid_c = _grid(h1, w1, dev)[None].expand(b, -1, -1)
    w_pt1, mutual = _mutual(grid_c * s1, data)
    pts0 = w_pt1 / s0
    inb = ((pts0[..., 0] >= 0) & (pts0[..., 0] < w0)
           & (pts0[..., 1] >= 0) & (pts0[..., 1] < h0))
    mask = mutual & inb

    # one correspondence per source cell: the highest candidate index wins
    n = h1 * w1
    cand = torch.arange(n, device=dev)[None].expand(b, -1)
    cell = (pts0[..., 1].long().clamp(0, h0 - 1) * w0
            + pts0[..., 0].long().clamp(0, w0 - 1))
    slots = h0 * w0 + 1
    base = torch.arange(b, device=dev)[:, None] * slots
    lut = torch.full((b * slots,), -1, dtype=torch.int64, device=dev)
    lut = lut.scatter_reduce(
        0, (base + torch.where(mask, cell, h0 * w0)).reshape(-1),
        torch.where(mask, cand, -1).reshape(-1), reduce="amax")
    mask = mask & (lut[(base + cell).reshape(-1)].reshape(b, n) == cand)

    corrs = torch.cat([pts0, grid_c], -1)
    return torch.where(mask[..., None], corrs, 0.0), mask


def spvs_full(data: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None, scale: int = 8,
              jitter: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-resolution correspondences from a grid jittered uniformly in
    [0, scale) (the draw from `generator`, or given as `jitter` (B, h1*w1,
    2)), with the mutual reprojection check and no dedup. Returns
    corrs_full (B, h1*w1, 4) (x0, y0, x1, y1) in resized-image pixels and
    their mask."""
    b, H0, W0 = data["image0"].shape[:3]
    H1, W1 = data["image1"].shape[1:3]
    h1, w1 = H1 // scale, W1 // scale
    dev = data["depth0"].device
    one = torch.ones((1, 1, 2), device=dev)
    s0 = data["scale0"][:, None, :] if data.get("scale0") is not None \
        else one
    s1 = data["scale1"][:, None, :] if data.get("scale1") is not None \
        else one
    if jitter is None:
        jitter = torch.rand((b, h1 * w1, 2), generator=generator,
                            device=dev) * float(scale)
    pts1_px = _grid(h1, w1, dev)[None] * scale + jitter
    w_pt1, mutual = _mutual(pts1_px * s1, data)
    pts0_px = w_pt1 / s0
    inb = ((pts0_px[..., 0] >= 0) & (pts0_px[..., 0] < W0)
           & (pts0_px[..., 1] >= 0) & (pts0_px[..., 1] < H0)
           & (pts1_px[..., 0] < W1) & (pts1_px[..., 1] < H1))
    mask = mutual & inb
    corrs = torch.cat([pts0_px, pts1_px], -1)
    return torch.where(mask[..., None], corrs, 0.0), mask


def corr_to_fixed(corrs: torch.Tensor, mask: torch.Tensor, max_corrs: int,
                  generator: Optional[torch.Generator] = None,
                  priority: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack valid rows first and pad or cut to `max_corrs`. With a
    `generator` (or a uniform `priority` (B, N) drawn by the caller) the
    valid rows come in random order, so a cut samples them uniformly;
    without, they keep raster order."""
    if priority is None and generator is not None:
        priority = torch.rand(mask.shape, generator=generator,
                              device=mask.device)
    if priority is not None:
        order = torch.argsort(torch.where(mask, priority, 2.0), dim=1,
                              stable=True)
    else:
        order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    corrs = torch.gather(corrs, 1, order[..., None].expand(-1, -1,
                                                           corrs.shape[-1]))
    mask = torch.gather(mask, 1, order)
    return corrs[:, :max_corrs], mask[:, :max_corrs]
