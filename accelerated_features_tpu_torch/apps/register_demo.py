"""Image-registration demo (counterpart of the JAX package's
`apps/register_demo.py`): match a reference and a target image, fit a
robust homography, and draw the inlier matches and the reference frame's
outline projected into the target.

Offline:   python -m accelerated_features_tpu_torch.apps.register_demo \\
               --ref a.png --tgt b.png [--out out.png] [--device cpu]
Webcam:    ... --webcam [--cam 0]
Method:    --method {XFeat, XFeat*, ORB, SIFT}

The homography is posekit's LO-RANSAC (threshold 4 px, at most 700
iterations, at least 50 inliers). The XFeat methods read and write PNG
and JPEG files and draw without cv2: the matches and the outline with
`utils/draw` (cv2's lines, pixel for pixel), the label (inliers, fps)
with `utils/text.put_text` (cv2 5.0.0's text). ORB, SIFT and `--webcam`
are cv2's and exit with a message naming it when cv2 does not import.
The device defaults to the GPU and the run raises without one.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np

from ..api import DEFAULT_WEIGHTS, XFeat, resolve_device
from ..geometry.pose import estimate_homography
from ..utils import draw as drawing
from ..utils.imageio import imread, write_png
from ..utils.text import put_text


def _cv2():
    """cv2, or a SystemExit that names it."""
    try:
        import cv2
    except ImportError:
        raise SystemExit("ORB, SIFT and --webcam need OpenCV (cv2), which "
                         "does not import here; the XFeat methods run "
                         "without it") from None
    return cv2


def build_method(name: str, top_k: int, weights, device=None):
    """A matcher (ref, tgt) -> (points (N,2), points (N,2)) of the named
    method. XFeat and XFeat* run the port on `device`."""
    if name in ("XFeat", "XFeat*"):
        xf = XFeat(weights, top_k=top_k, device=device)
        if name == "XFeat":
            return lambda a, b: xf.match_xfeat(a, b)
        return lambda a, b: xf.match_xfeat_star(a, b)
    if name in ("ORB", "SIFT"):
        cv2 = _cv2()
        det = (cv2.ORB_create(top_k, fastThreshold=10) if name == "ORB"
               else cv2.SIFT_create(top_k, contrastThreshold=-1,
                                    edgeThreshold=1000))
        norm = cv2.NORM_HAMMING if name == "ORB" else cv2.NORM_L2

        def fn(a, b):
            k0, d0 = det.detectAndCompute(a, None)
            k1, d1 = det.detectAndCompute(b, None)
            if d0 is None or d1 is None:
                return np.zeros((0, 2)), np.zeros((0, 2))
            matches = cv2.BFMatcher(norm, crossCheck=True).match(d0, d1)
            p0 = np.float32([k0[m.queryIdx].pt for m in matches])
            p1 = np.float32([k1[m.trainIdx].pt for m in matches])
            return p0, p1
        return fn
    raise ValueError(name)


def register(matcher, im_ref, im_tgt, min_inliers: int = 50):
    """(H or None, p0, p1, inlier mask) of one pair: H when posekit finds
    one with at least `min_inliers` inliers."""
    p0, p1 = matcher(im_ref, im_tgt)
    if len(p0) < 4:
        return None, p0, p1, np.zeros((0,), bool)
    res = estimate_homography(np.asarray(p0, np.float64),
                              np.asarray(p1, np.float64),
                              thresh=4.0, max_iters=700)
    if res is None or res[1].sum() < min_inliers:
        return None, p0, p1, np.zeros((len(p0),), bool)
    return res[0], p0, p1, res[1]


def _project_corners(H, w: int, h: int) -> np.ndarray:
    """The reference frame's corners mapped by H, as
    `cv2.perspectiveTransform` maps float32 points: (x m0 + y m1 + m2)
    times 1 / (x m6 + y m7 + m8) in float64, rounded to float32."""
    m = np.asarray(H, np.float64).reshape(-1)
    out = np.zeros((4, 2), np.float32)
    for i, (x, y) in enumerate([(0.0, 0.0), (w, 0.0), (w, h), (0.0, h)]):
        d = x * m[6] + y * m[7] + m[8]
        if abs(d) > np.finfo(np.float32).eps:
            d = 1.0 / d
            out[i] = ((x * m[0] + y * m[1] + m[2]) * d,
                      (x * m[3] + y * m[4] + m[5]) * d)
    return out


def draw(im_ref, im_tgt, H, p0, p1, inl, fps=None) -> np.ndarray:
    """The reference beside the target: a green 1-px line for each inlier
    match and, with H, the reference's outline projected into the target
    in red, 3 px wide, and the label (inliers, fps) in white, as the JAX
    app draws them with cv2."""
    vis = np.concatenate([im_ref, im_tgt], axis=1)
    off = im_ref.shape[1]
    for a, b, ok in zip(np.asarray(p0).astype(int),
                        np.asarray(p1).astype(int), inl):
        if ok:
            drawing.line(vis, (a[0], a[1]), (b[0] + off, b[1]), (0, 255, 0))
    if H is not None:
        h, w = im_ref.shape[:2]
        quad = _project_corners(H, w, h)
        quad[:, 0] += off
        drawing.polylines(vis, quad.astype(np.int32), (0, 0, 255), 3)
    label = f"inliers: {int(np.sum(inl))}"
    if fps is not None:
        label += f"  fps: {fps:.1f}"
    put_text(vis, label, (10, 30), 0, 1, (255, 255, 255), 2)
    return vis


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="XFeat",
                    choices=["XFeat", "XFeat*", "ORB", "SIFT"])
    ap.add_argument("--ref", type=str, default=None)
    ap.add_argument("--tgt", type=str, default=None)
    ap.add_argument("--out", type=str, default="registration.png")
    ap.add_argument("--webcam", action="store_true")
    ap.add_argument("--cam", type=int, default=0)
    ap.add_argument("--top_k", type=int, default=4096)
    ap.add_argument("--weights", type=str, default=DEFAULT_WEIGHTS,
                    help="extractor weights (default: the trained "
                         "extractor); 'random' for a random one")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    args = ap.parse_args(argv)

    xfeat_method = args.method in ("XFeat", "XFeat*")
    device = resolve_device(args.device) if xfeat_method else None
    if args.webcam:
        cv2 = _cv2()
    matcher = build_method(args.method, args.top_k,
                           None if args.weights == "random" else args.weights,
                           device)

    if args.webcam:
        cap = cv2.VideoCapture(args.cam)
        ok, ref = cap.read()
        if not ok:
            raise SystemExit("no camera frame")
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            t0 = time.time()
            H, p0, p1, inl = register(matcher, ref, frame)
            vis = draw(ref, frame, H, p0, p1, inl,
                       fps=1 / (time.time() - t0))
            cv2.imshow("register", vis)
            k = cv2.waitKey(1)
            if k == ord("s"):
                ref = frame
            elif k == ord("q"):
                break
        return {}

    if not (args.ref and args.tgt):
        raise SystemExit("--ref and --tgt required (or --webcam)")
    im_ref, im_tgt = imread(args.ref), imread(args.tgt)
    t0 = time.time()
    H, p0, p1, inl = register(matcher, im_ref, im_tgt)
    dt = time.time() - t0
    vis = draw(im_ref, im_tgt, H, np.asarray(p0), np.asarray(p1), inl)
    write_png(args.out, vis)
    print(f"{args.method}: {len(p0)} matches, {int(inl.sum())} inliers, "
          f"{dt*1000:.0f} ms -> {args.out}")
    if H is not None:
        print("H =\n", np.round(H, 4))
    return {"H": H, "n_matches": len(p0), "n_inliers": int(inl.sum()),
            "image": vis, "ms": dt * 1e3}


if __name__ == "__main__":
    main()
