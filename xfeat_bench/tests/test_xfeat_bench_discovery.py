"""A configuration, a traffic mix and a per-layer metric are found by
the name `BENCHMARK.json` gives them: adding them in a copy of the
benchmark adds files and entries and edits no file that is there. Also
holds `BENCHMARK.json` to the shape its readers expect."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import torch

from xfeat_bench import harness, spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_benchmark_json_shape():
    b = spec.load(ROOT)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["xfeat_bench"]
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert spec.traffic(w["traffic"], ROOT)["request"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "xfeat_bench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            reported = {x["name"] for x in spec.end_to_end(b, cell)}
            assert m["moves"] in reported, (m["name"], cell)
    for cell in cells:
        assert spec.per_layer(b, cell), cell


def test_an_addition_is_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "xfeat_bench", tmp_path / "xfeat_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    (tmp_path / "artifacts").symlink_to(ROOT / "artifacts")
    before = _digests(tmp_path / "xfeat_bench")

    bench = tmp_path / "xfeat_bench"
    cfg = json.loads((bench / "configs" / "xfeat-sparse.json").read_text())
    cfg["name"] = "xfeat-sparse-t12"
    cfg["extractor"]["detection_threshold"] = 0.012
    (bench / "configs" / "xfeat-sparse-t12.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "extract-b64.json").read_text())
    mix.update(views_per_request=2, distinct_requests=2, top_k=48)
    (bench / "traffic" / "extract-b2.json").write_text(json.dumps(mix))
    (bench / "metrics" / "requests.images.py").write_text(
        "def read(run):\n    return float(len(run.work))\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "xfeat-sparse-t12", "source": "test",
                         "file": "xfeat_bench/configs/xfeat-sparse-t12.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "t12.extract-b2",
                           "config": "xfeat-sparse-t12",
                           "traffic": "extract-b2", "chips": 1,
                           "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("t12.extract-b2")
    b["per_layer"].append({"name": "requests.images", "unit": "requests",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "images_per_s",
                           "workloads": ["t12.extract-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before

    got = spec.load(tmp_path)
    assert spec.config(got, "xfeat-sparse-t12", tmp_path)[
        "extractor"]["detection_threshold"] == 0.012
    assert spec.traffic("extract-b2", tmp_path)["views_per_request"] == 2
    assert [m["name"] for m in spec.per_layer(got, "t12.extract-b2")] == \
        ["requests.images"]
    torch.set_num_threads(2)
    result = harness.run_cell("t12.extract-b2", 7, 0.05, True, "cpu",
                              root=tmp_path, overrides={"crop_hw": (64, 96)})
    assert result["correct"]
    assert result["metrics"]["requests.images"]["value"] == \
        result["attempted"]
