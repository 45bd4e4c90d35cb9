"""`BENCHMARK.json` and the files it names.

A cell names its configuration and its traffic mix; a configuration's
`file` is its JSON, a traffic mix is `traffic/<name>.json`, a per-layer
metric is `metrics/<name>.py`, and the pipeline a configuration names
(`"pipeline"`, `xfeat` where it names none) is `pipelines/<name>.py`.
Adding a configuration, a traffic mix, a metric or a pipeline adds files
and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
DEFAULT_PIPELINE = "xfeat"


def load(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(spec: Dict[str, Any], name: str, root: Path = ROOT
           ) -> Dict[str, Any]:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((Path(root) / BENCH_DIR.name / "traffic"
                       / f"{name}.json").read_text())


def end_to_end(spec: Dict[str, Any], cell_name: str) -> List[Dict]:
    return [m for m in spec["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(spec: Dict[str, Any], cell_name: str) -> List[Dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those that list no cells and move an end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if cell_name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in reported)]


def _load(kind: str, name: str, root: Path) -> ModuleType:
    """`<kind>/<name>.py` of the benchmark under `root`, loaded by its path
    (names hold dots and dashes) and registered in `sys.modules`, as the
    dataclasses it defines need."""
    path = Path(root) / BENCH_DIR.name / kind / f"{name}.py"
    mod_name = f"xfeat_bench_{kind}_" + name.replace(".", "_").replace("-",
                                                                      "_")
    loaded = importlib.util.spec_from_file_location(mod_name, path)
    if loaded is None or not path.exists():
        raise FileNotFoundError(f"no file {path} for {kind} {name!r}")
    module = importlib.util.module_from_spec(loaded)
    sys.modules[mod_name] = module
    loaded.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """`metrics/<name>.py`: `read(run)` -> the metric, or None."""
    return _load("metrics", name, root)


def pipeline(name: str, root: Path = ROOT) -> ModuleType:
    """`pipelines/<name>.py`: a configuration's request kinds, the
    program's entries and their control, and the check (see
    `pipelines/xfeat.py`)."""
    return _load("pipelines", name, root)
