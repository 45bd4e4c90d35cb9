"""LightGlue at its published widths on the port's LighterGlue path
(`models.lighterglue.LIGHTGLUE_CONF`: 256-D, 9 layers, 4 heads of 64,
depth confidence 0.95, width confidence 0.99), held on the CPU to the
benchmark's plain reference `xfeat_bench/reference/lightglue.py`, which
runs one pair at a time as the published code does. Weights are drawn in
the published layout by `xfeat_bench/reference/seeded.py`; the port takes
them through `import_lighterglue_state_dict`, the reference through its
own loader. The exit and the confidence term of the pruning gate are
driven by constructed `token_confidence` weights (seeded weights never
exit). Pairs of 40-56 points, padded to 56 slots."""

import math

import numpy as np
import pytest
import torch

from accelerated_features_tpu_torch import XFeat
from accelerated_features_tpu_torch.models import lighterglue as lg
from xfeat_bench.reference import lightglue as ref
from xfeat_bench.reference import seeded
from xfeat_bench.reference.precision import Products

CONF = lg.LIGHTGLUE_CONF
K = 56
COUNTS = ((56, 48), (40, 56), (50, 44))     # valid points of each pair
SIZE = (640.0, 480.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state_dict():
    return seeded.lighterglue_state_dict(CONF, 5, "cpu")


def _inputs(seed=4):
    """Three pairs: the second image's points a jittered, shuffled subset
    of the first's, with noisy descriptors, so pairs have true matches."""
    rng = np.random.default_rng(seed)
    b = len(COUNTS)
    k0 = rng.uniform(0, SIZE, (b, K, 2)).astype(np.float32)
    d0 = rng.normal(size=(b, K, 64)).astype(np.float32)
    perm = rng.permutation(K)
    k1 = (k0[:, perm] + rng.normal(size=(b, K, 2)) * 2).astype(np.float32)
    d1 = (d0[:, perm] + 0.3 * rng.normal(size=(b, K, 64))).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    ar = np.arange(K)[None]
    return {"kpts": (torch.from_numpy(k0), torch.from_numpy(k1)),
            "descs": (torch.from_numpy(d0), torch.from_numpy(d1)),
            "masks": (torch.from_numpy(ar < np.array(COUNTS)[:, :1]),
                      torch.from_numpy(ar < np.array(COUNTS)[:, 1:])),
            "size": torch.tensor([SIZE] * b)}


def _port(params, x, conf):
    with torch.inference_mode():
        return lg.lighterglue_forward(
            params, *x["kpts"], *x["descs"], x["size"], x["size"],
            *x["masks"], heads=conf["num_heads"],
            width_confidence=conf["width_confidence"], pruning_min_kpts=0,
            depth_confidence=conf["depth_confidence"])


def _valid(x, i):
    return [torch.nonzero(m[i])[:, 0] for m in x["masks"]]


def _reference(rparams, x, i, conf):
    s = _valid(x, i)
    return ref.forward_pair(
        rparams, dict(conf, pruning_min_kpts=0),
        *(t[i][s[j]] for j, t in enumerate(x["kpts"])),
        *(t[i][s[j]] for j, t in enumerate(x["descs"])),
        x["size"][i], x["size"][i])


def _assert_pair_equal(out, x, i, r):
    """Pair i of a batched port call against the reference run on that
    pair alone: layers run, kept points, the log assignment over the kept
    points and its dustbins within 1e-4 (float32 in two orders of
    operations through nine layers), matches on valid rows equal, scores
    within 1e-5."""
    s0, s1 = _valid(x, i)
    if "layers" in out:
        assert int(out["layers"][i]) == r["layers"]
    else:
        assert r["layers"] == CONF["n_layers"]
    k0, k1 = s0[r["ind"][0]], s1[r["ind"][1]]
    assert torch.equal(torch.nonzero(out["keep0"][i])[:, 0], k0)
    assert torch.equal(torch.nonzero(out["keep1"][i])[:, 0], k1)
    la = out["log_assignment"][i]
    rows = torch.cat([k0, torch.tensor([K])])
    cols = torch.cat([k1, torch.tensor([K])])
    got = la[rows][:, cols]
    want = r["scores"].clone()
    want[-1, -1] = got[-1, -1]          # the corner: -inf against 0
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    m0 = out["matches0"][i][s0]
    want_m0 = torch.where(r["matches0"] >= 0,
                          s1[r["matches0"].clamp(min=0)], -1)
    assert torch.equal(m0, want_m0)
    assert (m0 >= 0).sum() >= 10
    torch.testing.assert_close(out["mscores0"][i][s0], r["mscores0"],
                               atol=1e-5, rtol=0)


def _params(state_dict, token=None):
    """The port's and the reference's trees of `state_dict`, with
    `token` (layer -> (weight (256,), bias)) in place of those layers'
    token-confidence heads."""
    sd = dict(state_dict)
    for i, (w, b) in (token or {}).items():
        sd[f"token_confidence.{i}.token.0.weight"] = w[None].clone()
        sd[f"token_confidence.{i}.token.0.bias"] = torch.tensor([float(b)])
    return (lg.import_lighterglue_state_dict(sd, CONF),
            ref.weights_from_state_dict(sd, CONF))


def _hidden(rparams, x, i, layers):
    """Pair i's descriptors of both sides (valid points, nothing pruned)
    after each of the first `layers` layers, by the reference's layer."""
    prod = Products("full")
    s = _valid(x, i)
    h = [ref._lin(prod, rparams["input_proj"], x["descs"][j][i][s[j]])
         for j in (0, 1)]
    enc = [ref._encode(prod, rparams["posenc_wr"], x["kpts"][j][i][s[j]],
                       x["size"][i]) for j in (0, 1)]
    out = []
    for layer in rparams["layers"][:layers]:
        h = ref.run_layer(prod, layer, h, enc, CONF["num_heads"])
        out.append(torch.cat(h))
    return out


def _logit(p):
    return math.log(p / (1 - p))


@pytest.mark.parametrize("depth,width", [(-1.0, -1.0), (0.95, 0.99)],
                         ids=["off", "published"])
def test_published_widths_match_the_reference(state_dict, depth, width):
    """Seeded weights: no pair exits (token confidences sit near 0.5,
    under every layer's threshold) and matchability stays above 0.01, so
    with depth and width on every pair runs 9 layers and keeps every
    point, as without them."""
    conf = dict(CONF, depth_confidence=depth, width_confidence=width)
    pp, rp = _params(state_dict)
    x = _inputs()
    out = _port(pp, x, conf)
    assert ("layers" in out) == (depth > 0)
    for i in range(len(COUNTS)):
        r = _reference(rp, x, i, conf)
        assert r["layers"] == 9 and len(r["exits"]) == (8 if depth > 0
                                                         else 0)
        _assert_pair_equal(out, x, i, r)


def test_an_exit_takes_that_layers_assignment_head(state_dict):
    """Token confidence 1 after layer 2 and 0 after every other layer:
    every pair stops after its third layer, keeps that layer's
    descriptors and is scored by that layer's assignment head."""
    zero = torch.zeros(CONF["descriptor_dim"])
    token = {i: (zero, 12.0 if i == 2 else -12.0)
             for i in range(CONF["n_layers"] - 1)}
    pp, rp = _params(state_dict, token)
    x = _inputs()
    out = _port(pp, x, CONF)
    assert out["layers"].tolist() == [3, 3, 3]
    full = _port(pp, x, dict(CONF, depth_confidence=-1.0))
    assert not torch.allclose(out["log_assignment"], full["log_assignment"])
    for i in range(len(COUNTS)):
        r = _reference(rp, x, i, CONF)
        assert r["layers"] == 3 and [e[1] for e in r["exits"]] == \
            [False, False, True]
        _assert_pair_equal(out, x, i, r)


def _stop_bias(t, thr, points, depth):
    """The least bias at which the exit decision on logits `t` (the kept
    points of a pair) turns to stop: the share of points with
    sigmoid(t + bias) >= thr has to exceed `depth`."""
    need = math.floor(points * (1 - depth)) + 1     # confident points
    while not 1 - (points - need) / points > depth:
        need += 1
    top = torch.sort(t, descending=True).values
    return _logit(thr) - float(top[need - 1])


def test_pairs_of_one_batch_exit_at_their_own_layers(state_dict):
    """Constructed token heads make pair 0 stop after layer 1, pair 1
    after layer 4 and pair 2 run all 9 layers, inside one batched call;
    each pair equals the reference run on that pair alone."""
    _, rp = _params(state_dict)
    x = _inputs()
    n = CONF["n_layers"]
    hidden = [_hidden(rp, x, i, 5) for i in range(len(COUNTS))]
    gen = torch.Generator().manual_seed(0)
    token = {i: (torch.zeros(256), -12.0) for i in range(n - 1)}
    for layer, first in ((1, 0), (4, 1)):
        thr = lg.confidence_threshold(layer, n)
        for _ in range(200):
            w = torch.randn(256, generator=gen) * 0.5
            need = [_stop_bias(hidden[p][layer] @ w, thr, sum(COUNTS[p]),
                               CONF["depth_confidence"])
                    for p in range(len(COUNTS))]
            rest = min(need[p] for p in range(first + 1, len(COUNTS)))
            if need[first] < rest - 0.5:
                token[layer] = (w, (need[first] + rest) / 2)
                break
        assert layer in token and token[layer][1] != -12.0
    pp, rp = _params(state_dict, token)
    out = _port(pp, x, CONF)
    assert out["layers"].tolist() == [2, 5, 9]
    for i in range(len(COUNTS)):
        _assert_pair_equal(out, x, i, _reference(rp, x, i, CONF))


def test_low_confidence_keeps_a_point_matchability_would_prune(state_dict):
    """Width confidence set so that layer 0's matchability prunes half the
    points, and a token head of layer 0 under which half the points are
    below the confidence threshold (the other layers': none above it):
    with depth confidence on, a point that matchability alone prunes
    stays when its confidence is low, as `get_pruning_mask` keeps it."""
    _, rp = _params(state_dict)
    x = _inputs()
    prod = Products("full")
    h0 = torch.cat([_hidden(rp, x, i, 1)[0] for i in range(len(COUNTS))])
    z = torch.sigmoid(ref._lin(prod, rp["assignments"][0]["matchability"],
                               h0)[:, 0])
    zs = torch.sort(z).values
    mid = len(zs) // 2
    width = 1 - float(zs[mid - 1] + zs[mid]) / 2
    w = torch.randn(256, generator=torch.Generator().manual_seed(1)) * 0.5
    t = torch.sort(h0 @ w).values
    thr = lg.confidence_threshold(0, CONF["n_layers"])
    bias = _logit(thr) - float(t[mid - 1] + t[mid]) / 2
    token = {i: (w, bias) if i == 0 else (torch.zeros(256), -12.0)
             for i in range(CONF["n_layers"] - 1)}
    pp, rp = _params(state_dict, token)
    conf = dict(CONF, width_confidence=width)
    out = _port(pp, x, conf)
    alone = _port(pp, x, dict(conf, depth_confidence=-1.0))
    assert out["layers"].tolist() == [9, 9, 9]
    saved = out["keep0"] & ~alone["keep0"] | out["keep1"] & ~alone["keep1"]
    assert saved.any()
    assert (out["keep0"] & ~alone["keep0"]).sum() < x["masks"][0].sum()
    for i in range(len(COUNTS)):
        r = _reference(rp, x, i, conf)
        assert r["decisions"][0] and not r["decisions"][0][0][3].all()
        _assert_pair_equal(out, x, i, r)


def _one_head_forward(params, kpts0, kpts1, descs0, descs1, size0, size1,
                      mask0, mask1, width_confidence, pruning_min_kpts):
    """LighterGlue's forward as written for one head and no depth exit:
    the expression `lighterglue_forward` keeps to the bit on that path."""
    b, m, _ = kpts0.shape
    n = kpts1.shape[1]
    x0 = lg._apply(params["input_proj"], descs0.float())
    x1 = lg._apply(params["input_proj"], descs1.float())
    cos0, sin0 = lg.rotary_encoding(lg.normalize_keypoints(kpts0, size0),
                                    params["posenc_wr"])
    cos1, sin1 = lg.rotary_encoding(lg.normalize_keypoints(kpts1, size1),
                                    params["posenc_wr"])

    def self_block(p, x, cos, sin, mask):
        q, k, v = lg._apply(p["qkv"], x).chunk(3, dim=-1)
        ctx = lg._attention(lg.apply_rotary(q, cos, sin),
                            lg.apply_rotary(k, cos, sin), v, mask, 1)
        return lg._ffn(p, x, lg._apply(p["out"], ctx))

    do_prune = width_confidence > 0 and max(m, n) > pruning_min_kpts
    keep = [mask0, mask1]
    margin = [torch.full((b, m), float("inf")), torch.full((b, n),
                                                            float("inf"))]
    n_layers = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x0 = self_block(layer["self"], x0, cos0, sin0, keep[0])
        x1 = self_block(layer["self"], x1, cos1, sin1, keep[1])
        x0, x1 = lg._cross_block(layer["cross"], x0, x1, keep[0], keep[1], 1)
        if do_prune and i < n_layers - 1:
            for side, x in enumerate((x0, x1)):
                over = lg.get_matchability(params["assignments"][i], x) \
                    - (1.0 - width_confidence)
                margin[side] = torch.where(
                    keep[side], torch.minimum(margin[side], over.abs()),
                    margin[side])
                keep[side] = keep[side] & (over > 0)
    asg = params["assignments"][-1]
    dim = x0.shape[-1]
    md0 = lg._apply(asg["final_proj"], x0) / dim ** 0.25
    md1 = lg._apply(asg["final_proj"], x1) / dim ** 0.25
    sim = torch.matmul(md0, md1.transpose(1, 2))
    z0 = lg._apply(asg["matchability"], x0)[..., 0]
    z1 = lg._apply(asg["matchability"], x1)[..., 0]
    scores = lg.sigmoid_log_double_softmax(sim, z0, z1, keep[0], keep[1])
    m0, ms0 = lg.filter_matches_from_scores(scores, m, n)
    if do_prune:
        m0 = torch.where(keep[0], m0, -1)
        ms0 = torch.where(keep[0], ms0, 0.0)
    return {"log_assignment": scores, "matches0": m0, "mscores0": ms0,
            "keep0": keep[0], "keep1": keep[1],
            "prune_margin0": margin[0], "prune_margin1": margin[1]}


@pytest.mark.parametrize("width", [-1.0, 0.55], ids=["unpruned", "pruned"])
def test_one_head_without_depth_keeps_its_expression(width):
    """LighterGlue (one head, 96-D, 6 layers; random weights), depth
    confidence off: every output equal to the bit to the one-head
    expression, with pruning off and on (0.55 prunes some points here)."""
    params = lg.init_lighterglue_params(torch.Generator().manual_seed(3))
    x = _inputs(5)
    args = (*x["kpts"], *x["descs"], x["size"], x["size"], *x["masks"])
    with torch.inference_mode(), torch.no_grad():
        got = lg.lighterglue_forward(params, *args, heads=1,
                                     width_confidence=width,
                                     pruning_min_kpts=0)
        want = _one_head_forward(params, *args, width, 0)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert bool((~got["keep0"] & x["masks"][0]).any()) == (width > 0)


def test_lighterglue_wrapper_and_xfeat_run_lightglue(state_dict):
    """`LighterGlue(..., conf=LIGHTGLUE_CONF).forward_padded` and
    `XFeat.set_lighterglue(..., conf=...)` with `match_lighterglue` run
    the published widths on one unpadded pair, as the reference does."""
    _, rp = _params(state_dict)
    x = _inputs()
    s0, s1 = _valid(x, 1)
    d = [{"keypoints": x["kpts"][j][1][s], "descriptors": x["descs"][j][1][s],
          "image_size": SIZE} for j, s in enumerate((s0, s1))]
    r = _reference(rp, x, 1, dict(CONF, width_confidence=-1.0))
    matcher = lg.LighterGlue(state_dict, "cpu", conf=CONF)
    out = matcher.forward_padded(d[0], d[1])
    assert int(out["layers"][0]) == 9
    assert torch.equal(out["matches0"][0][:len(s0)], r["matches0"])
    xf = XFeat(weights=None, device="cpu")
    xf.set_lighterglue(state_dict, conf=CONF)
    _, _, idx = xf.match_lighterglue(d[0], d[1], min_conf=0.0)
    rows = torch.nonzero(r["matches0"] >= 0)[:, 0]
    assert torch.equal(idx, torch.stack([rows, r["matches0"][rows]], -1))
