"""Synthetic pair augmentation of the port: the JAX package's
`train/augmentation.py` in torch, batched on the device.

Each view is a coordinate map, out pixel -> [TPS deform in out
coordinates] -> crop and scale to the warp resolution -> H^-1 -> source
pixel, so the image (one bilinear sample) and its correspondences (the
same map evaluated at points) agree exactly. View 2 -> view 1 is
p1 = C^-1(H1(H2^-1(C(tps2(p2))))). Photometric augmentation follows:
colour jitter, equalization, 7x7 blur, correlated noise, shadows.

The JAX package `vmap`s per-item functions; here every function takes a
leading batch dimension (the geometry also takes unbatched points, as the
JAX functions do). Draws come from a `torch.Generator` on the data's
device; `homography_from_draws` and `tps_from_draws` build the transforms
from given uniform and normal draws, so tests can hand both packages the
same ones. Resizes compute `jax.image.resize`'s weights (Keys cubic with
a = -0.5, renormalized at the borders), so both packages resize alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AugConfig:
    warp_resolution: Tuple[int, int] = (800, 608)   # (W, H)
    out_resolution: Tuple[int, int] = (800, 608)
    sides_crop: float = 0.1
    tps_grid: Tuple[int, int] = (8, 6)
    photometric: bool = True

    @property
    def crop_low(self):
        w, h = self.warp_resolution
        return (int(w * self.sides_crop), int(h * self.sides_crop))

    @property
    def crop_high(self):
        w, h = self.warp_resolution
        return (int(w * (1 - self.sides_crop)), int(h * (1 - self.sides_crop)))

    @property
    def dims_t(self):
        """Cropped extent - 1."""
        (lx, ly), (hx, hy) = self.crop_low, self.crop_high
        return (hx - lx - 1, hy - ly - 1)

    @property
    def dims_s(self):
        """out-res -> cropped-res point scale."""
        tw, th = self.dims_t
        ow, oh = self.out_resolution
        return (tw / ow, th / oh)


def _rand(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def _randn(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


# --------------------------------------------------------------- homography

def homography_from_draws(theta_deg: torch.Tensor, scale: torch.Tensor,
                          txn: torch.Tensor, sxy: torch.Tensor,
                          p12: torch.Tensor, shape_hw: Tuple[int, int]
                          ) -> torch.Tensor:
    """(B,3,3) homographies H_b H_s H_p H_a H_r H_t from their draws:
    rotation (B,) degrees, scale (B,2), translation (B,2), shear (B,2),
    projective (B,2), the last three already times their spread."""
    h, w = shape_hw
    b, dev = theta_deg.shape[0], theta_deg.device
    tx, ty = -w / 2.0, -h / 2.0
    th = torch.deg2rad(theta_deg)
    c, s = torch.cos(th), torch.sin(th)
    one, zero = torch.ones_like(c), torch.zeros_like(c)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    eye = torch.eye(3, device=dev).expand(b, 3, 3)
    H_t = eye.clone()
    H_t[:, 0, 2], H_t[:, 1, 2] = tx, ty
    H_r = mat([[c, -s, zero], [s, c, zero], [zero, zero, one]])
    H_a = mat([[one, sxy[:, 1], zero], [sxy[:, 0], one, zero],
               [zero, zero, one]])
    H_p = mat([[one, zero, zero], [zero, one, zero],
               [p12[:, 0], p12[:, 1], one]])
    H_s = torch.diag_embed(torch.stack([scale[:, 0], scale[:, 1], one], -1))
    H_b = mat([[one, zero, -tx + txn[:, 0]], [zero, one, -ty + txn[:, 1]],
               [zero, zero, one]])
    return H_b @ H_s @ H_p @ H_a @ H_r @ H_t


def random_homography(gen: Optional[torch.Generator], batch: int,
                      shape_hw: Tuple[int, int], difficulty: float = 0.3,
                      device=None) -> torch.Tensor:
    """(B,3,3) random rotation (+-30 deg), scale (0.35-1.2), shear,
    projective and translation homographies."""
    theta = _rand(gen, (batch,), device) * 60.0 - 30.0
    scale = 0.35 + _rand(gen, (batch, 2), device) * 0.85
    txn = _randn(gen, (batch, 2), device) * 120.0 * difficulty
    sxy = _randn(gen, (batch, 2), device) * 0.6 * difficulty
    p12 = _randn(gen, (batch, 2), device) * 0.006 * difficulty
    return homography_from_draws(theta, scale, txn, sxy, p12, shape_hw)


def apply_h(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., P, 2) points through (..., 3, 3) homographies."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    out = ph @ H.transpose(-1, -2)
    return out[..., :2] / (out[..., 2:3] + 1e-12)


# --------------------------------------------------------------------- TPS

def _tps_kernel(r2: torch.Tensor) -> torch.Tensor:
    return r2 * torch.log(torch.sqrt(r2) + 1e-9)


def solve_tps(ctrl: torch.Tensor, target: torch.Tensor):
    """TPS interpolating ctrl -> target, (..., N, 2) each in normalized
    coordinates. Returns (weights (..., N, 2), affine (..., 3, 2))."""
    n = ctrl.shape[-2]
    lead = ctrl.shape[:-2]
    K = _tps_kernel(((ctrl[..., :, None, :] - ctrl[..., None, :, :]) ** 2)
                    .sum(-1))
    P = torch.cat([torch.ones_like(ctrl[..., :1]), ctrl], -1)
    A = ctrl.new_zeros(lead + (n + 3, n + 3))
    A[..., :n, :n] = K
    A[..., :n, n:] = P
    A[..., n:, :n] = P.transpose(-1, -2)
    rhs = ctrl.new_zeros(lead + (n + 3, 2))
    rhs[..., :n, :] = target
    sol = torch.linalg.solve(A + 1e-8 * torch.eye(n + 3, device=ctrl.device),
                             rhs)
    return sol[..., :n, :], sol[..., n:, :]


def tps_apply(pts: torch.Tensor, ctrl: torch.Tensor, weights: torch.Tensor,
              affine: torch.Tensor) -> torch.Tensor:
    """The TPS map at (..., P, 2) points; ctrl (..., N, 2)."""
    U = _tps_kernel(((pts[..., :, None, :] - ctrl[..., None, :, :]) ** 2)
                    .sum(-1))
    ph = torch.cat([torch.ones_like(pts[..., :1]), pts], -1)
    return ph @ affine + U @ weights


def _tps_ctrl(grid: Tuple[int, int], device) -> torch.Tensor:
    gy, gx = grid
    ys = torch.linspace(-1.0, 1.0, gy + 1, device=device)
    xs = torch.linspace(-1.0, 1.0, gx + 1, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], -1).reshape(-1, 2)


def tps_from_draws(offs_u: torch.Tensor, apply_u: torch.Tensor,
                   grid: Tuple[int, int] = (8, 6), difficulty: float = 0.3,
                   prob: float = 0.5) -> Tps:
    """(ctrl, dst, weights, affine), each with a leading batch dim, from
    uniform draws: offs_u (B, N, 2) for the control-point jitter, apply_u
    (B,) against `prob`. The map solved is the backward one, dst -> ctrl."""
    gy, gx = grid
    b, dev = offs_u.shape[0], offs_u.device
    ctrl = _tps_ctrl(grid, dev)[None].expand(b, -1, -1)
    cell = torch.tensor([2.0 / gx, 2.0 / gy], device=dev) / 2.0
    offs = (offs_u - 0.5) * cell * min(0.97, 2.0 * difficulty)
    apply_it = (apply_u < prob).float()[:, None, None]
    dst = ctrl + apply_it * offs
    weights, affine = solve_tps(dst, ctrl)
    return ctrl, dst, weights, affine


def random_tps(gen: Optional[torch.Generator], batch: int,
               grid: Tuple[int, int] = (8, 6), difficulty: float = 0.3,
               prob: float = 0.5, device=None) -> Tps:
    """Random TPS in [-1,1] coordinates: grid control points jittered by up
    to ~half a cell, applied with probability `prob`."""
    n = (grid[0] + 1) * (grid[1] + 1)
    return tps_from_draws(_rand(gen, (batch, n, 2), device),
                          _rand(gen, (batch,), device), grid, difficulty,
                          prob)


# ----------------------------------------------------------------- warping

def _bilinear_sample_hw(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img (B,H,W,C); xy (B,...,2) pixel coordinates -> (B,...,C), zeros
    outside the image."""
    b, h, w, c = img.shape
    lead = xy.shape[1:-1]
    xy = xy.reshape(b, -1, 2)
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    tx, ty = (x - x0)[..., None], (y - y0)[..., None]
    flat = img.reshape(b, h * w, c)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return v * inb[..., None]

    v00, v01 = tap(x0, y0), tap(x0 + 1, y0)
    v10, v11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    out = ((v00 * (1 - tx) + v01 * tx) * (1 - ty)
           + (v10 * (1 - tx) + v11 * tx) * ty)
    return out.reshape((b,) + lead + (c,))


def _out_to_src(pts_out: torch.Tensor, H: torch.Tensor, cfg: AugConfig,
                tps: Optional[Tps]) -> torch.Tensor:
    """Out-res pixels (..., P, 2) -> source pixels (the view's backward
    map); H (..., 3, 3)."""
    ow, oh = cfg.out_resolution
    size = torch.tensor([ow, oh], dtype=torch.float32, device=pts_out.device)
    if tps is not None:
        ctrl, _, weights, affine = tps
        norm = tps_apply(pts_out / size * 2.0 - 1.0, ctrl, weights, affine)
        pts_out = (norm + 1.0) / 2.0 * size
    sx, sy = cfg.dims_s
    lx, ly = cfg.crop_low
    warp_pts = pts_out * torch.tensor([sx, sy], device=pts_out.device) \
        + torch.tensor([lx, ly], dtype=torch.float32, device=pts_out.device)
    return apply_h(torch.linalg.inv(H), warp_pts)


def _pixel_grid(ow: int, oh: int, device) -> torch.Tensor:
    """(oh*ow, 2) xy of every out-res pixel, x fastest."""
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32,
                                         device=device),
                            torch.arange(ow, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([gx, gy], -1).reshape(-1, 2)


def render_view(img: torch.Tensor, H: torch.Tensor, cfg: AugConfig,
                tps: Optional[Tps] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The warped out-res views (B,oh,ow,C) of source images (B,h,w,C) and
    their masks (B,oh,ow), the pixels whose source lies in the image."""
    ow, oh = cfg.out_resolution
    b, h, w = img.shape[:3]
    grid = _pixel_grid(ow, oh, img.device)[None].expand(b, -1, -1)
    src = _out_to_src(grid, H, cfg, tps)
    out = _bilinear_sample_hw(img, src).reshape(b, oh, ow, -1)
    mask = ((src[..., 0] >= 0) & (src[..., 0] <= w - 1)
            & (src[..., 1] >= 0) & (src[..., 1] <= h - 1))
    return out, mask.reshape(b, oh, ow)


def view2_to_view1(pts2: torch.Tensor, H1: torch.Tensor, H2: torch.Tensor,
                   cfg: AugConfig, tps2: Optional[Tps]) -> torch.Tensor:
    """Out-res points (..., P, 2) of view 2 -> out-res points of view 1."""
    warp1 = apply_h(H1, _out_to_src(pts2, H2, cfg, tps2))
    sx, sy = cfg.dims_s
    lx, ly = cfg.crop_low
    dev = pts2.device
    return (warp1 - torch.tensor([lx, ly], dtype=torch.float32, device=dev)) \
        / torch.tensor([sx, sy], device=dev)


# ------------------------------------------------------------------ resize

def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp_min(0.0)


def _resize_matrix(n_in: int, n_out: int, method: str, antialias: bool,
                   device) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize` along one axis."""
    kernel = {"bilinear": _triangle, "bicubic": _keys_cubic}[method]
    inv_scale = n_in / n_out
    kscale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() / kscale
    wts = kernel(x)
    tot = wts.sum(0, keepdim=True)
    wts = torch.where(tot.abs() > 1000.0 * 1.1920929e-07,
                      wts / torch.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "bilinear",
           antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize` of (B,h,w,C) to (B,H,W,C) by "bilinear" or
    "bicubic" (its separable weights, float32)."""
    wy = _resize_matrix(x.shape[1], out_hw[0], method, antialias, x.device)
    wx = _resize_matrix(x.shape[2], out_hw[1], method, antialias, x.device)
    return torch.einsum("bhwc,hH,wW->bHWc", x, wy, wx)


# ------------------------------------------------------------- photometric

def color_jitter(gen: Optional[torch.Generator], img: torch.Tensor,
                 strength: float = 0.15) -> torch.Tensor:
    """Brightness, contrast and saturation jitter of (B,H,W,C) images, one
    factor of each in [1-s, 1+s] an image."""
    b, dev = img.shape[0], img.device

    def factor():
        return (1 - strength + 2 * strength * _rand(gen, (b,), dev)) \
            .reshape(b, 1, 1, 1)
    fb, fc, fs = factor(), factor(), factor()
    img = img * fb
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    img = (img - mean) * fc + mean
    gray = img.mean(dim=-1, keepdim=True)
    img = (img - gray) * fs + gray
    return img.clamp(0.0, 1.0)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """Histogram equalization of each channel of (..., H, W, C) images in
    [0, 1] (torchvision's `equalize` rule, as the JAX package has it)."""
    *lead, h, w, c = img.shape
    v = (img * 255.0).clamp(0, 255).long()
    vv = v.movedim(-1, -3).reshape(-1, h * w)
    hist = torch.zeros((vv.shape[0], 256), dtype=torch.float32,
                       device=img.device)
    hist.scatter_add_(1, vv, torch.ones_like(vv, dtype=torch.float32))
    cdf = hist.cumsum(1)
    cdf_min = torch.where(hist > 0, cdf, math.inf).min(1, keepdim=True).values
    lut = ((cdf - cdf_min) / (h * w - cdf_min).clamp_min(1.0)).clamp(0.0, 1.0)
    out = torch.gather(lut, 1, vv)
    return out.reshape(*lead, c, h, w).movedim(-3, -1)


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """7x7 separable Gaussian of (H,W,C) or (B,H,W,C), zero padding."""
    x = torch.arange(-3, 4, dtype=torch.float32, device=img.device)
    g = torch.exp(-x ** 2 / (2 * sigma ** 2))
    g = g / g.sum()
    img4 = img[None] if img.dim() == 3 else img
    c = img4.shape[-1]
    t = img4.permute(0, 3, 1, 2)
    t = F.conv2d(t, g.reshape(1, 1, 1, 7).expand(c, 1, 1, 7), padding=(0, 3),
                 groups=c)
    t = F.conv2d(t, g.reshape(1, 1, 7, 1).expand(c, 1, 7, 1), padding=(3, 0),
                 groups=c)
    out = t.permute(0, 2, 3, 1)
    return out[0] if img.dim() == 3 else out


def correlated_noise(gen: Optional[torch.Generator], shape_bhwc,
                     amp: float = 10.0 / 255.0, device=None) -> torch.Tensor:
    """Half-resolution Gaussian noise, bilinearly upsampled."""
    b, h, w, c = shape_bhwc
    n = _randn(gen, (b, h // 2, w // 2, c), device) * amp
    return resize(n, (h, w), "bilinear", antialias=False)


def random_shadows(gen: Optional[torch.Generator], shape_bhwc,
                   lo: float = 0.25, hi: float = 1.0,
                   device=None) -> torch.Tensor:
    """Low-frequency multiplicative shadow field (B,H,W,1)."""
    b, h, w, _ = shape_bhwc
    n = _rand(gen, (b, max(h // 64, 1), max(w // 64, 1), 1), device) * 1.3
    return resize(n.clamp(lo, hi), (h, w), "bicubic").clamp(lo, hi)


def photometric_augment(gen: Optional[torch.Generator], img: torch.Tensor,
                        p_blur: float = 0.3, p_noise: float = 0.5,
                        p_shadow: float = 0.4,
                        p_equalize: float = 0.4) -> torch.Tensor:
    """Jitter, then equalization, blur, correlated noise and shadows, each
    with its probability, chosen per image of (B,H,W,C)."""
    b, dev = img.shape[0], img.device

    def coin(p):
        return (_rand(gen, (b,), dev) < p).reshape(b, 1, 1, 1)
    img = color_jitter(gen, img)
    img = torch.where(coin(p_equalize), equalize(img), img)
    img = torch.where(coin(p_blur), gaussian_blur7(img), img)
    noisy = (img + correlated_noise(gen, img.shape, device=dev)).clamp(0, 1)
    img = torch.where(coin(p_noise), noisy, img)
    shaded = img * random_shadows(gen, img.shape, device=dev)
    img = torch.where(coin(p_shadow), shaded, img)
    return img.clamp(0.0, 1.0)


# ------------------------------------------------------------ full pipeline

def images_to_out(images: torch.Tensor, cfg: AugConfig) -> torch.Tensor:
    ow, oh = cfg.out_resolution
    if tuple(images.shape[1:3]) == (oh, ow):
        return images
    return resize(images, (oh, ow), "bilinear", antialias=False)


def make_pair(gen: Optional[torch.Generator], images: torch.Tensor,
              cfg: AugConfig, difficulty: float = 0.1, tps_prob: float = 0.7,
              transforms: Optional[Dict[str, object]] = None
              ) -> Dict[str, object]:
    """Two warped, photometrically augmented views of each image of
    (B,H,W,C) in [0,1], with their masks and transforms (H1, H2, tps2) for
    the correspondences. `transforms` gives H1, H2 and tps2 instead of
    drawing them."""
    b, h, w = images.shape[:3]
    dev = images.device
    if transforms is None:
        transforms = {
            "H1": random_homography(gen, b, (h, w), difficulty, dev),
            "H2": random_homography(gen, b, (h, w), difficulty, dev),
            "tps2": random_tps(gen, b, cfg.tps_grid, difficulty, tps_prob,
                               dev)}
    H1, H2, tps2 = transforms["H1"], transforms["H2"], transforms["tps2"]
    v1, m1 = render_view(images, H1, cfg)
    v2, m2 = render_view(images, H2, cfg, tps2)
    # pixels without a source take the texture of another image of the
    # batch
    out = images_to_out(images, cfg)
    v1 = torch.where(m1[..., None], v1, torch.roll(out, 1, dims=0))
    v2 = torch.where(m2[..., None], v2, torch.roll(out, 2, dims=0))
    if cfg.photometric:
        v1 = photometric_augment(gen, v1)
        v2 = photometric_augment(gen, v2)
    return {"view1": v1, "view2": v2, "mask1": m1, "mask2": m2,
            "H1": H1, "H2": H2, "tps2": tps2}


def pair_correspondences(pair: Dict[str, object], cfg: AugConfig,
                         grid_scale: int = 8, pad: int = 2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """/8-grid correspondences view 2 -> view 1: corrs (B, n, 4) (x1, y1,
    x2, y2) in /8 coordinates and their mask (B, n), at most one a source
    cell (the highest index wins)."""
    ow, oh = cfg.out_resolution
    gw, gh = ow // grid_scale, oh // grid_scale
    H1, H2 = pair["H1"], pair["H2"]
    dev = H1.device
    b = H1.shape[0]
    tgt_out = (_pixel_grid(gw, gh, dev) * grid_scale)[None].expand(b, -1, -1)
    src_out = view2_to_view1(tgt_out, H1, H2, cfg, pair["tps2"])
    inb = ((src_out[..., 0] >= 0) & (src_out[..., 0] < ow)
           & (src_out[..., 1] >= 0) & (src_out[..., 1] < oh))
    xi = src_out[..., 0].long().clamp(0, ow - 1)
    yi = src_out[..., 1].long().clamp(0, oh - 1)
    ti = tgt_out[..., 0].long().clamp(0, ow - 1)
    tj = tgt_out[..., 1].long().clamp(0, oh - 1)
    m1 = pair["mask1"].reshape(b, -1)
    m2 = pair["mask2"].reshape(b, -1)
    vmask = inb & torch.gather(m1, 1, yi * ow + xi) \
        & torch.gather(m2, 1, tj * ow + ti)
    src_g, tgt_g = src_out / grid_scale, tgt_out / grid_scale

    def inside(p):
        return ((p[..., 0] >= pad) & (p[..., 0] < gw - pad)
                & (p[..., 1] >= pad) & (p[..., 1] < gh - pad))
    good = vmask & inside(src_g) & inside(tgt_g)

    n = src_g.shape[1]
    cell = (src_g[..., 1].long().clamp(0, gh - 1) * gw
            + src_g[..., 0].long().clamp(0, gw - 1))
    idxs = torch.arange(n, device=dev)[None].expand(b, -1)
    slots = gh * gw + 1
    base = torch.arange(b, device=dev)[:, None] * slots
    lut = torch.full((b * slots,), -1, dtype=torch.int64, device=dev)
    lut = lut.scatter_reduce(
        0, (base + torch.where(good, cell, gh * gw)).reshape(-1),
        torch.where(good, idxs, -1).reshape(-1), reduce="amax")
    good = good & (lut[(base + cell).reshape(-1)].reshape(b, n) == idxs)
    corr = torch.cat([src_g, tgt_g], -1)
    return torch.where(good[..., None], corr, 0.0), good


def pair_correspondences_full(pair: Dict[str, object], cfg: AugConfig,
                              generator: Optional[torch.Generator] = None,
                              grid_scale: int = 8,
                              jitter: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-resolution correspondences from a grid jittered uniformly in
    [0, grid_scale) (drawn, or given as `jitter` (B, n, 2)), no dedup:
    corrs_full (B, n, 4) (x1, y1, x2, y2) and their mask."""
    ow, oh = cfg.out_resolution
    gw, gh = ow // grid_scale, oh // grid_scale
    H1, H2 = pair["H1"], pair["H2"]
    dev, b = H1.device, H1.shape[0]
    mesh = _pixel_grid(gw, gh, dev)
    if jitter is None:
        jitter = _rand(generator, (b, mesh.shape[0], 2), dev) \
            * float(grid_scale)
    tgt = mesh[None] * grid_scale + jitter
    src = view2_to_view1(tgt, H1, H2, cfg, pair["tps2"])
    inb = ((src[..., 0] >= 0) & (src[..., 0] < ow) & (src[..., 1] >= 0)
           & (src[..., 1] < oh) & (tgt[..., 0] < ow) & (tgt[..., 1] < oh))
    xi = src[..., 0].long().clamp(0, ow - 1)
    yi = src[..., 1].long().clamp(0, oh - 1)
    ti = tgt[..., 0].long().clamp(0, ow - 1)
    tj = tgt[..., 1].long().clamp(0, oh - 1)
    good = inb & torch.gather(pair["mask1"].reshape(b, -1), 1, yi * ow + xi) \
        & torch.gather(pair["mask2"].reshape(b, -1), 1, tj * ow + ti)
    corr = torch.cat([src, tgt], -1)
    return torch.where(good[..., None], corr, 0.0), good
