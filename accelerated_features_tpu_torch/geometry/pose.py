"""ctypes wrapper of the native posekit library (`native/posekit.cpp`):
5-point LO-RANSAC relative pose, 4-point LO-RANSAC homography, the minimal
5-point solver, the squared Sampson error and the Faugeras decomposition
of a homography (counterpart of the JAX package's `geometry/pose.py`, with
its signatures, defaults and numpy types).

posekit is host code: numpy in, numpy out, no device. The library is
compiled at first use with g++ from the repository's `native/posekit.cpp`
by `utils/native.py`, into the port's git-ignored `_build/` (nothing is
written under `native/`, and no prebuilt library is ever loaded in its
place: a failed build raises the compiler's output).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils import native

SOURCE = native.PKG_DIR.parent / "native" / "posekit.cpp"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_DOUBLES = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    """Where the library of this source, compiler, flags and CPU lives."""
    return native.library_path(SOURCE, "posekit")


def _build(path: Path) -> None:
    native.build(path, SOURCE, "posekit")


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            d, i, u = _DOUBLES, ctypes.c_int, ctypes.c_uint
            dbl, mask = ctypes.c_double, ctypes.POINTER(ctypes.c_ubyte)
            for fn, args, res in (
                    (lib.pk_estimate_relative_pose,
                     [d, d, i, d, d, dbl, dbl, i, u, d, d, mask], i),
                    (lib.pk_estimate_homography,
                     [d, d, i, dbl, i, u, d, mask, dbl], i),
                    (lib.pk_five_point, [d, d, d], i),
                    (lib.pk_sampson_sq, [d, d, d], dbl)):
                fn.argtypes, fn.restype = args, res
            _LIB = lib
        return _LIB


def posekit_available() -> bool:
    """Whether the library builds (or is built) and loads."""
    try:
        _lib()
        return True
    except Exception:
        return False


def _cptr(a: np.ndarray):
    return a.ctypes.data_as(_DOUBLES)


def _points(pts0, pts1) -> Tuple[np.ndarray, np.ndarray]:
    """Two (N,2) float64 C-contiguous arrays of one length (or empty), or
    raise."""
    pts0 = np.ascontiguousarray(pts0, np.float64)
    pts1 = np.ascontiguousarray(pts1, np.float64)
    if len(pts0) != len(pts1):
        raise ValueError(f"pts0/pts1 length mismatch: "
                         f"{len(pts0)} != {len(pts1)}")
    if pts0.size and (pts0.ndim != 2 or pts0.shape[1:] != (2,)
                      or pts1.shape[1:] != (2,)):
        raise ValueError(f"need (N,2) points, got {pts0.shape} and "
                         f"{pts1.shape}")
    return pts0, pts1


def estimate_relative_pose(pts0: np.ndarray, pts1: np.ndarray,
                           K0: np.ndarray, K1: np.ndarray,
                           max_epipolar_error: float = 2.5,
                           success_prob: float = 0.99999,
                           max_iters: int = 10_000,
                           seed: int = 0
                           ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]]:
    """5-point + LO-RANSAC relative pose from pixel correspondences ->
    (R (3,3), t (3,), inlier mask (N,) bool), or None."""
    pts0, pts1 = _points(pts0, pts1)
    n = len(pts0)
    if n < 5:
        return None
    K0 = np.ascontiguousarray(K0, np.float64)
    K1 = np.ascontiguousarray(K1, np.float64)
    if K0.shape != (3, 3) or K1.shape != (3, 3):
        raise ValueError(f"need (3,3) intrinsics, got {K0.shape} and "
                         f"{K1.shape}")
    R = np.zeros((3, 3), np.float64)
    t = np.zeros((3,), np.float64)
    mask = np.zeros((n,), np.uint8)
    ninl = _lib().pk_estimate_relative_pose(
        _cptr(pts0), _cptr(pts1), ctypes.c_int(n), _cptr(K0), _cptr(K1),
        ctypes.c_double(max_epipolar_error), ctypes.c_double(success_prob),
        ctypes.c_int(max_iters), ctypes.c_uint(seed), _cptr(R), _cptr(t),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if ninl <= 0:
        return None
    return R, t, mask.astype(bool)


def estimate_homography(pts0: np.ndarray, pts1: np.ndarray,
                        thresh: float = 4.0, max_iters: int = 700,
                        seed: int = 0, success_prob: float = 0.99999
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """4-point DLT + LO-RANSAC homography -> (H (3,3), inlier mask (N,)
    bool), or None."""
    pts0, pts1 = _points(pts0, pts1)
    n = len(pts0)
    if n < 4:
        return None
    H = np.zeros((3, 3), np.float64)
    mask = np.zeros((n,), np.uint8)
    ninl = _lib().pk_estimate_homography(
        _cptr(pts0), _cptr(pts1), ctypes.c_int(n), ctypes.c_double(thresh),
        ctypes.c_int(max_iters), ctypes.c_uint(seed), _cptr(H),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_double(success_prob))
    if ninl <= 0:
        return None
    return H, mask.astype(bool)


def five_point(x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    """Minimal 5-point solver on normalized coordinates -> (N<=10, 3, 3)
    stack of essential matrices."""
    x0 = np.ascontiguousarray(x0, np.float64)
    x1 = np.ascontiguousarray(x1, np.float64)
    if len(x0) < 5 or len(x1) < 5:
        raise ValueError("five_point needs exactly 5 correspondences "
                         f"(got {len(x0)}, {len(x1)})")
    if x0.shape[1:] != (2,) or x1.shape[1:] != (2,):
        raise ValueError(f"five_point needs (5,2) points, got {x0.shape} "
                         f"and {x1.shape}")
    out = np.zeros((10, 3, 3), np.float64)
    cnt = _lib().pk_five_point(_cptr(x0), _cptr(x1), _cptr(out))
    return out[:cnt]


def sampson_sq(E: np.ndarray, p0: np.ndarray, p1: np.ndarray) -> float:
    """Squared Sampson error of one normalized correspondence under E."""
    E = np.ascontiguousarray(E, np.float64)
    p0 = np.ascontiguousarray(p0, np.float64)
    p1 = np.ascontiguousarray(p1, np.float64)
    if E.shape != (3, 3) or p0.size < 2 or p1.size < 2:
        raise ValueError(f"sampson_sq needs a (3,3) E and two points, got "
                         f"{E.shape}, {p0.shape}, {p1.shape}")
    return float(_lib().pk_sampson_sq(_cptr(E), _cptr(p0), _cptr(p1)))


def decompose_homography(H: np.ndarray, K0: np.ndarray, K1: np.ndarray,
                         pts0: Optional[np.ndarray] = None,
                         pts1: Optional[np.ndarray] = None
                         ) -> list:
    """Faugeras SVD decomposition of a pixel homography into rigid-motion
    candidates [(R, t_unit_or_zero, n), ...].

    For a planar scene the essential matrix is degenerate, so SLAM front
    ends also fit a homography and decompose H = d*R + t*n^T (Faugeras &
    Lustman 1988). `pts0/pts1` (pixel coordinates, a few inliers) fix the
    sign of the calibrated homography (x1^T Hn x0 > 0 for points in
    front). The translation is returned unit-normalized (|t|/d cannot be
    recovered from H alone); a near-pure rotation returns one candidate
    with t = 0.
    """
    Hn = np.linalg.inv(np.asarray(K1, np.float64)) \
        @ np.asarray(H, np.float64) @ np.asarray(K0, np.float64)
    if pts0 is not None and len(pts0):
        x0 = np.concatenate([np.asarray(pts0, np.float64)[:8],
                             np.ones((min(len(pts0), 8), 1))], axis=1)
        x1 = np.concatenate([np.asarray(pts1, np.float64)[:8],
                             np.ones((min(len(pts1), 8), 1))], axis=1)
        x0n = x0 @ np.linalg.inv(K0).T
        x1n = x1 @ np.linalg.inv(K1).T
        sgn = np.sign(np.median(np.sum(x1n * (x0n @ Hn.T), axis=1)))
        if sgn != 0:
            Hn = Hn * sgn

    U, S, Vt = np.linalg.svd(Hn)
    d1, d2, d3 = S
    if d1 / max(d2, 1e-12) < 1.0001 or d2 / max(d3, 1e-12) < 1.0001:
        # (near-)pure rotation: H/d2 is (near) orthogonal; project to SO(3)
        Un, _, Vtn = np.linalg.svd(Hn / d2)
        Rr = Un @ np.diag([1.0, 1.0,
                           np.sign(np.linalg.det(Un @ Vtn))]) @ Vtn
        return [(Rr, np.zeros(3), np.array([0.0, 0.0, 1.0]))]

    s = np.linalg.det(U) * np.linalg.det(Vt)
    x1_ = np.sqrt((d1 ** 2 - d2 ** 2) / (d1 ** 2 - d3 ** 2))
    x3_ = np.sqrt((d2 ** 2 - d3 ** 2) / (d1 ** 2 - d3 ** 2))
    sin_t = np.sqrt((d1 ** 2 - d2 ** 2) * (d2 ** 2 - d3 ** 2)) \
        / ((d1 + d3) * d2)
    cos_t = (d2 ** 2 + d1 * d3) / ((d1 + d3) * d2)
    out = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = np.array([[cos_t, 0.0, -st],
                           [0.0, 1.0, 0.0],
                           [st, 0.0, cos_t]])
            tp = (d1 - d3) * np.array([e1 * x1_, 0.0, -e3 * x3_])
            np_ = np.array([e1 * x1_, 0.0, e3 * x3_])
            R = s * (U @ Rp @ Vt)
            t = U @ tp
            n = Vt.T @ np_
            tn = np.linalg.norm(t)
            if tn > 1e-12:
                t = t / tn
            # report the normal on the +z (visible) side
            if n[2] < 0:
                n, t = -n, -t if tn > 1e-12 else t
            out.append((R, t, n))
    return out
