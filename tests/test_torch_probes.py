"""The card's A/B probes (`accelerated_features_tpu_torch/tools/
measure_select.py`, `measure_stem.py`, `probe_int8.py`) at tiny sizes with
`--device cpu`, where the kernels' plain versions run in their place: each
prints its JSON lines with every field, its own checks pass (the decodes
hold the reshape form's bits, kernel A's route equals the plain chain, the
composed extraction equals `detect_and_compute`, the int8 product is
exact), and without `--device` each refuses to run on a machine with no
card. Kernel A's candidate entry (`detect_candidates`) runs its plain
version on CPU tensors."""

import json

import numpy as np
import pytest
import torch

from accelerated_features_tpu_torch.ops import detect
from accelerated_features_tpu_torch.ops.cuda.detect_fused import \
    detect_candidates
from accelerated_features_tpu_torch.tools import (measure_select,
                                                  measure_stem, probe_int8)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_measure_select_prints_every_stage(capsys):
    out = measure_select.main(["--device", "cpu", "--batch", "2", "--iters",
                               "1", "--top_k", "32", "--shapes", "64x48"])
    lines = _lines(capsys)
    assert lines == out and all(x["device"] == "cpu" for x in lines)
    got = {(x["stage"], x["variant"]) for x in lines}
    assert got == {("decode", v) for v in ("reshape", "convt", "planes")} | {
        ("select", v) for v in ("a_candidates", "a_stage",
                                "a_candidates+torch.topk", "plain_chain")} | {
        ("e2e", v) for v in ("decode=reshape", "decode=convt",
                             "decode=planes", "select=plain_chain",
                             "sample=plain")}
    assert all(x["ms_per_batch"] > 0 for x in lines)


def test_measure_stem_prints_both_stems(capsys):
    out = measure_stem.main(["--device", "cpu", "--batch", "1", "--iters",
                             "1", "--top_k", "32", "--res", "64x64"])
    lines = _lines(capsys)
    assert lines[0] == out[0] and len(lines) == 2
    for k in ("stem_cudnn_ms", "stem_fused_ms", "full_unfused_ms",
              "full_fused_ms", "full_fps_unfused", "full_fps_fused"):
        assert out[0][k] > 0
    assert "fused_stem_wins_in_context_at_all_sizes" in lines[1]


def test_probe_int8_prints_its_line(capsys):
    out = probe_int8.main(["--device", "cpu", "--batch", "1", "--res",
                           "64x64", "--iters", "2"])
    assert _lines(capsys) == [out]
    assert (out["M"], out["K"], out["N"]) == (16, 576, 64)
    assert out["int8_ms"] > 0 and out["bf16_ms"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("probe", [measure_select, measure_stem, probe_int8])
def test_probes_refuse_the_cpu_without_device(probe):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--iters", "1"])


def test_detect_candidates_plain_on_the_cpu():
    rng = np.random.default_rng(2)
    kheat = torch.from_numpy(rng.uniform(0, 0.2, (2, 16, 24)).astype(
        np.float32))
    rel = torch.from_numpy(rng.uniform(0, 1, (2, 2, 3)).astype(np.float32))
    best, sub = detect_candidates(kheat, rel, 0.05)
    ref = detect.tile_candidates(detect.score_map(kheat, rel, 0.05))
    assert torch.equal(best, ref[0]) and torch.equal(sub, ref[1])
    assert detect_candidates.launches == 0
