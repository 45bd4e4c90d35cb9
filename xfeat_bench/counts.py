"""Operations and bytes of the work a request asks for, from the
configuration's published widths and the inputs' valid counts: each
function's own work, counted once (not the three products of 3xTF32, nor
what an implementation computes again or on padding). A multiply-add
counts two operations."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# XFeat's convolutions: (block, kernel, in, out, stride, /scale of the
# output); the keypoint head runs on the 8x8 unfold of the gray image
XFEAT_CONVS = [
    ("block1", 3, 1, 4, 1, 1), ("block1", 3, 4, 8, 2, 2),
    ("block1", 3, 8, 8, 1, 2), ("block1", 3, 8, 24, 2, 4),
    ("skip1", 1, 1, 24, 1, 4),
    ("block2", 3, 24, 24, 1, 4), ("block2", 3, 24, 24, 1, 4),
    ("block3", 3, 24, 64, 2, 8), ("block3", 3, 64, 64, 1, 8),
    ("block3", 1, 64, 64, 1, 8),
    ("block4", 3, 64, 64, 2, 16), ("block4", 3, 64, 64, 1, 16),
    ("block4", 3, 64, 64, 1, 16),
    ("block5", 3, 64, 128, 2, 32), ("block5", 3, 128, 128, 1, 32),
    ("block5", 3, 128, 128, 1, 32), ("block5", 1, 128, 64, 1, 32),
    ("block_fusion", 3, 64, 64, 1, 8), ("block_fusion", 3, 64, 64, 1, 8),
    ("block_fusion", 1, 64, 64, 1, 8),
    ("heatmap_head", 1, 64, 64, 1, 8), ("heatmap_head", 1, 64, 64, 1, 8),
    ("heatmap_head", 1, 64, 1, 1, 8),
    ("keypoint_head", 1, 64, 64, 1, 8), ("keypoint_head", 1, 64, 64, 1, 8),
    ("keypoint_head", 1, 64, 64, 1, 8), ("keypoint_head", 1, 64, 65, 1, 8),
]


def xfeat_flops(h: int, w: int) -> float:
    """The backbone's convolutions on one h x w image."""
    return float(sum(2 * k * k * cin * cout * (h // s) * (w // s)
                     for _, k, cin, cout, _, s in XFEAT_CONVS))


def detect_bytes(h: int, w: int, top_k: int) -> float:
    """Kernel A on one image: the full-resolution keypoint heatmap and the
    /8 reliability read once, int64 (x, y) keypoints and float32 scores
    written."""
    return float(4 * h * w + 4 * (h // 8) * (w // 8) + top_k * (16 + 4))


def mnn_flops(n0: int, n1: int, dim: int = 64) -> float:
    """The similarity of n0 valid rows against n1 valid columns."""
    return float(2 * n0 * n1 * dim)


def mnn_bytes(k0: int, k1: int, dim: int = 64) -> float:
    """Kernel C on one pair of K0 and K1 slots: both descriptor sets and
    valid masks read, int64 idx1 and the bool mask written."""
    return float(4 * dim * (k0 + k1) + k0 + k1 + 9 * k0)


def attention_flops(nq: int, keys: int, dim: int) -> float:
    """q k^T and the weighted sum of v, over the kept keys."""
    return float(4 * nq * keys * dim)


def attention_bytes(nq: int, keys: int, dim: int) -> float:
    """q read and the output written over the kept queries, k and v and
    the key mask read over the kept keys, float32."""
    return float(4 * dim * (2 * nq + 2 * keys) + keys)


def attention_launches(counts: Sequence[Tuple[int, int]]
                       ) -> Sequence[Tuple[int, int]]:
    """(queries, keys) of every attention of one pair, in the order the
    layers run them: per layer, self-attention on either side, then
    cross-attention both ways. `counts` are the kept points at each
    layer's input."""
    out = []
    for m, n in counts:
        out += [(m, m), (n, n), (m, n), (n, m)]
    return out


def lighterglue_flops(conf: Dict, counts: Sequence[Tuple[int, int]],
                      pruned_layers: Sequence[Tuple[bool, bool]]) -> float:
    """LighterGlue on one pair: the input projection and positional
    encoding, every layer's linears over its kept points, its attention
    over the kept keys, the matchability heads of the pruning decisions
    taken, and the last assignment (final projection, similarity,
    matchability). `counts` as in `attention_launches`; `pruned_layers`
    says, per layer, on which sides a pruning decision was taken after it
    (on the points that entered it)."""
    d_in, d = conf["input_dim"], conf["descriptor_dim"]
    m0, n0 = counts[0]
    total = 2.0 * (m0 + n0) * (d_in * d + 2 * d // 2)
    for m, n in counts:
        pts = m + n
        total += 2.0 * pts * (d * 3 * d + d * d + 2 * d * 2 * d + 2 * d * d)
        total += 2.0 * pts * (d * d + d * d + d * d + 2 * d * 2 * d
                              + 2 * d * d)
    for q, k in attention_launches(counts):
        total += attention_flops(q, k, d)
    for (m, n), (p0, p1) in zip(counts, pruned_layers):
        total += 2.0 * d * (m * p0 + n * p1)
    m, n = counts[-1]
    total += 2.0 * (m + n) * (d * d + d) + 2.0 * m * n * d
    return total
