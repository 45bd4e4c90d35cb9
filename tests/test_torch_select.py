"""The exact top-k selection of kernel A (`csrc/detect_fused.cu`,
`select_kernel`), emulated step by step in numpy on the CPU: the histogram
of the keys' top 11 bits, the boundary bin, its refinement by 11 and 10
more bits while the bin holds more keys than are wanted, the collect pass
(keys above the boundary, then the first boundary keys, both in index
order: the cluster's slices are contiguous and each is ranked by ballots
and scans), the bitonic sort of the keys padded to a power of two, the
decode and the pad for k > N.

The emulation is held to the port's `_padded_top_k` and the JAX package's
`_padded_top_k` (`lax.top_k`) on adversarial rows, and, through the
candidates, to `topk_keypoints(score_map(...))`, all bit for bit: the
kernel's gate on the card is `torch.equal`. Also: the CPU branches of the
wrappers, and the host copy of the stem kernel's packed weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.ops import detect as jdetect
from accelerated_features_tpu_torch.ops import detect
from accelerated_features_tpu_torch.ops.cuda import detect_fused
from accelerated_features_tpu_torch.ops.cuda import stem_fused as stem

from select_cases import CASES

LEVELS = ((11, 21), (11, 10), (10, 0))   # (bits, shift) of the radix levels


def ukey(v: np.ndarray) -> np.ndarray:
    """float32 -> uint32 key in the value's order (-0.0 below +0.0)."""
    b = np.asarray(v, np.float32).view(np.int32)
    o = np.where(b < 0, b ^ np.int32(0x7FFFFFFF), b).astype(np.int32)
    return o.view(np.uint32) ^ np.uint32(0x80000000)


def from_ukey(u: np.ndarray) -> np.ndarray:
    o = (np.asarray(u, np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    return np.where(o < 0, o ^ np.int32(0x7FFFFFFF), o).astype(
        np.int32).view(np.float32)


def boundary(hist: np.ndarray, want: int):
    """The one bin whose count with the counts above it first reaches
    `want`, and the count above it (the kernel's find_boundary)."""
    suffix = np.cumsum(hist[::-1])[::-1]
    above = suffix - hist
    hit = np.nonzero((above < want) & (suffix >= want))[0]
    assert len(hit) == 1
    return int(hit[0]), int(above[hit[0]])


def bitonic_desc(a: np.ndarray) -> None:
    """The kernel's bitonic network, in place, on a power-of-two array."""
    p, size = len(a), 2
    while size <= p:
        stride = size // 2
        while stride:
            t = np.arange(p // 2)
            lo = 2 * t - (t & (stride - 1))
            hi = lo + stride
            x, y = a[lo].copy(), a[hi].copy()
            swap = (x < y) == ((lo & size) == 0)
            a[lo], a[hi] = np.where(swap, y, x), np.where(swap, x, y)
            stride //= 2
        size *= 2


def select_row(values: np.ndarray, k: int, stats=None):
    """One image's selection as the kernel does it -> (values, indices)."""
    n = len(values)
    kk = min(k, n)
    u = ukey(values)
    hist = np.bincount(u >> 21, minlength=2048)
    prefix, shift, remaining = 0, 21, kk
    for level, (bits, _) in enumerate(LEVELS):
        b, above = boundary(hist, remaining)
        remaining -= above
        prefix = (prefix << bits) | b
        if hist[b] == remaining or level == 2:
            break
        nbits, nshift = LEVELS[level + 1]
        inside = (u >> np.uint32(shift)) == prefix
        hist = np.bincount((u[inside] >> np.uint32(nshift))
                           & ((1 << nbits) - 1), minlength=1 << nbits)
        shift = nshift
    if stats is not None:
        stats.append(level)
    hi = (u >> np.uint32(shift)).astype(np.int64)
    up = np.nonzero(hi > prefix)[0]
    assert len(up) == kk - remaining
    ties = np.nonzero(hi == prefix)[0][:remaining]   # the block scan's order
    p2 = detect_fused.sort_width(n, k)
    keys = np.zeros(p2, np.uint64)

    def key(i):
        return (u[i].astype(np.uint64) << np.uint64(32)) \
            | (n - 1 - i).astype(np.uint64)
    keys[:len(up)] = key(up)
    keys[len(up):kk] = key(ties)
    bitonic_desc(keys)
    idx = np.zeros(k, np.int64)
    val = np.full(k, -1.0, np.float32)
    idx[:kk] = (n - 1) - (keys[:kk] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    val[:kk] = from_ukey((keys[:kk] >> np.uint64(32)).astype(np.uint32))
    return val, idx


def emulate(values: np.ndarray, k: int, stats=None):
    out = [select_row(row, k, stats) for row in values]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_selection_equals_padded_top_k(name):
    values, k = CASES[name]
    val, idx = emulate(values, k)
    ref_v, ref_i = detect._padded_top_k(torch.from_numpy(values), k)
    np.testing.assert_array_equal(idx, ref_i.numpy())
    np.testing.assert_array_equal(bits(val), bits(ref_v.numpy()))


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_selection_equals_jax_top_k(name):
    values, k = CASES[name]
    val, idx = emulate(values, k)
    ref_v, ref_i = jdetect._padded_top_k(jnp.asarray(values), k)
    np.testing.assert_array_equal(idx, np.asarray(ref_i))
    np.testing.assert_array_equal(bits(val), bits(np.asarray(ref_v)))


def test_cases_reach_every_refinement_level():
    """The cases stop after level 1, 2 and 3 of the radix select, so each
    branch of the kernel is emulated."""
    stats = []
    for values, k in CASES.values():
        emulate(values, k, stats=stats)
    assert set(stats) == {0, 1, 2}
    values, k = CASES["large k, global sort"]
    assert detect_fused.sort_width(values.shape[1], k) \
        > detect_fused.SEL_SMEM_KEYS


def test_bitonic_network_sorts_descending():
    rng = np.random.default_rng(3)
    for p in (1, 2, 8, 4096):
        a = rng.integers(0, 50, p).astype(np.uint64)
        want = np.sort(a)[::-1]
        bitonic_desc(a)
        np.testing.assert_array_equal(a, want)


def test_keys_order_like_lax_top_k():
    v = np.float32([-np.inf, -1.0, -1e-30, -0.0, 0.0, 1e-30, 0.5, np.inf])
    u = ukey(v)
    assert (np.diff(u.astype(np.int64)) > 0).all()
    np.testing.assert_array_equal(bits(from_ukey(u)), bits(v))


@pytest.mark.parametrize("seed,b,h,w,k", [(0, 2, 16, 20, 4096),
                                          (1, 1, 30, 40, 100),
                                          (2, 3, 12, 16, 1)])
def test_emulated_keypoints_equal_plain(seed, b, h, w, k):
    """Candidates -> emulated selection -> xy decode, against
    `topk_keypoints(score_map(...))` on every slot, the tail included."""
    rng = np.random.default_rng(seed)
    logits = torch.tensor(rng.normal(size=(b, h, w, 65)) * 3,
                          dtype=torch.float32)
    kheat = detect.heatmap_decode(logits)
    rel = torch.tensor(rng.uniform(0.1, 1, (b, h, w)), dtype=torch.float32)
    best, sub = detect.tile_candidates(detect.score_map(kheat, rel, 0.012))
    w2 = best.shape[2]
    val, idx = emulate(best.reshape(b, -1).numpy(), k)
    s = np.take_along_axis(sub.reshape(b, -1).numpy(), idx, 1).astype(
        np.int64)
    xy = np.stack([(idx % w2) * 2 + s % 2, (idx // w2) * 2 + s // 2], -1)
    ref_xy, ref_s = detect.topk_keypoints(
        detect.score_map(kheat, rel, 0.012), k)
    np.testing.assert_array_equal(xy, ref_xy.numpy())
    np.testing.assert_array_equal(bits(val), bits(ref_s.numpy()))


def test_wrappers_on_cpu_run_plain_and_count_nothing():
    rng = np.random.default_rng(4)
    values = torch.tensor(rng.normal(size=(2, 300)), dtype=torch.float32)
    before = detect_fused.topk_exact.launches
    for k in (1, 300, 500):
        got = detect_fused.topk_exact(values, k)
        ref = detect._padded_top_k(values, k)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    feats = torch.tensor(rng.normal(size=(2, 300, 8)), dtype=torch.float32)
    idx, f = detect.dense_topk(feats, values, 20, detect_fused.topk_exact)
    assert torch.equal(idx, detect._padded_top_k(values, 20)[1])
    assert torch.equal(f, torch.gather(feats, 1,
                                       idx[..., None].expand(-1, -1, 8)))
    assert detect_fused.topk_exact.launches == before
    kheat = detect.heatmap_decode(torch.tensor(
        rng.normal(size=(1, 4, 6, 65)), dtype=torch.float32))
    rel = torch.tensor(rng.uniform(size=(1, 4, 6)), dtype=torch.float32)
    n = detect_fused.topk_keypoints_fused.launches
    got = detect_fused.topk_keypoints_fused(kheat, rel, 64, 0.01)
    ref = detect.topk_keypoints(detect.score_map(kheat, rel, 0.01), 64)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert detect_fused.topk_keypoints_fused.launches == n


def test_sort_width():
    assert [detect_fused.sort_width(n, k) for n, k in
            ((10, 1), (10, 2), (10, 3), (121600, 4096), (300, 4096),
             (5, 5))] == [1024, 1024, 1024, 4096, 1024, 1024]


def _stem_params(seed):
    rng = np.random.default_rng(seed)
    chans = [(1, 4), (4, 8), (8, 8), (8, 24)]
    block1 = [{"w": torch.tensor(rng.normal(size=(co, ci, 3, 3)),
                                 dtype=torch.float32),
               "b": torch.tensor(rng.normal(size=co), dtype=torch.float32)}
              for ci, co in chans]
    skip = {"w": torch.tensor(rng.normal(size=(24, 1, 1, 1)),
                              dtype=torch.float32),
            "b": torch.tensor(rng.normal(size=24), dtype=torch.float32)}
    return {"block1": block1, "skip1": skip}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_pack_params_is_a_cached_host_vector(dtype):
    """The stem kernel takes its weights by value from `pack_params`' host
    vector: the weights rounded to `dtype` in the kernel's layout, cached,
    and packed anew after a weight is written."""
    params = _stem_params(1)
    host = stem.pack_params(params, dtype)
    assert host.device.type == "cpu" and host.dtype == torch.float32
    assert host.is_contiguous() and host.shape == (stem.N_PARAMS,)
    layers, (ws, bs) = stem.stem_weights(params, dtype)
    want = torch.cat([w.permute(1, 2, 3, 0).reshape(-1) for w, _ in layers]
                     + [b for _, b in layers] + [ws.reshape(-1), bs])
    assert torch.equal(host, want)
    assert stem.pack_params(params, dtype) is host               # cached
    params["block1"][2]["w"].mul_(2.0)                            # written
    host2 = stem.pack_params(params, dtype)
    assert host2 is not host and not torch.equal(host2, host)
    layers, _ = stem.stem_weights(params, dtype)
    w3 = layers[2][0].permute(1, 2, 3, 0).reshape(-1)
    assert torch.equal(host2[36 + 288:36 + 288 + 576], w3)
