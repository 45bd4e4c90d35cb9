"""The `xfeat-lightglue` configuration: its pipeline, reference, metric and
limits are found by the names `BENCHMARK.json` and the configuration give;
one tiny run of its cell on the CPU comes out `correct` and reads
`layers.pairs`; the control (the reference at TF32) and a program whose
weights differ from the reference's (an exit the reference does not take,
a changed layer) come out not correct."""

import pytest
import torch

from xfeat_bench import check, harness, program, spec

CELL = "lightglue.pairs-k4096-b8"
TINY = {"traffic": {"pairs_per_request": 2, "distinct_requests": 2,
                    "top_k": 64},
        "crop_hw": (96, 128)}
SEED = 2 ** 31 + 5


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(trace=False, program_class="Program"):
    return harness.run_cell(CELL, SEED, 0.05, trace, "cpu",
                            overrides=TINY, program=program_class)


def test_the_configuration_names_its_pipeline_and_metric():
    b = spec.load()
    cell = spec.cell(b, CELL)
    config = spec.config(b, cell["config"])
    assert config["pipeline"] == "lightglue" and config["reduced"] == []
    assert set(config["assumed"]) == {"input_dim", "pruning_min_kpts"}
    pipe = spec.pipeline(config["pipeline"])
    for name in ("make_requests", "Executor", "Program", "Control",
                 "judge", "LIMITS"):
        assert hasattr(pipe, name), name
    assert set(pipe.LIMITS) == {"lightglue_gap", "lightglue_log_mscore_gap"}
    assert not set(pipe.LIMITS) & set(check.LIMITS)
    assert [m["name"] for m in spec.per_layer(b, CELL)
            if m["name"] == "layers.pairs"] == ["layers.pairs"]
    reader = spec.metric_reader("layers.pairs")

    class Run:
        work = [{"pairs": 8, "layers": 72}, {"pairs": 8, "layers": 60}]
    assert reader.read(Run) == 8.25
    Run.work = [{"pairs": 8}]
    assert reader.read(Run) is None


def test_one_tiny_request_is_correct_and_reads_its_layers():
    r = _run(trace=True)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"select_gap", "score_gap", "desc_gap",
                                "lightglue_gap", "lightglue_log_mscore_gap"}
    assert r["metrics"]["layers.pairs"]["value"] == 9.0


def test_the_control_is_not_correct():
    r = _run(program_class="Control")
    assert not r["correct"], r["checks"]
    assert r["checks"]["lightglue_log_mscore_gap"]["value"] > \
        r["checks"]["lightglue_log_mscore_gap"]["limit"]


def _early_exit(params):
    """Token confidence 1 after the second layer: every pair stops there."""
    tc = params["token_confidence"][1]
    params["token_confidence"][1] = {"w": torch.zeros_like(tc["w"]),
                                     "b": torch.full_like(tc["b"], 12.0)}


def _changed_layer(params):
    """A layer's output projection slightly scaled."""
    out = params["layers"][4]["self"]["out"]
    out["w"] = out["w"] * 1.01


@pytest.mark.parametrize("fault,number", [
    (_early_exit, "lightglue_gap"),
    (_changed_layer, "lightglue_log_mscore_gap")])
def test_weights_other_than_the_references_are_not_correct(monkeypatch,
                                                           fault, number):
    load = program.lighterglue_params

    def altered(*a, **k):
        params = load(*a, **k)
        fault(params)
        return params

    monkeypatch.setattr(program, "lighterglue_params", altered)
    r = _run()
    assert not r["correct"], r["checks"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]
