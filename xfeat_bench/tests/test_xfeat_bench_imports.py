"""No module of the benchmark imports JAX, Flax or the JAX package, and
no module of its reference imports the program under test. Imports are
compared by their top-level name (the part before the first dot), whole:
`accelerated_features_tpu_torch` is not `accelerated_features_tpu`."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "accelerated_features_tpu"}
PORT = "accelerated_features_tpu_torch"


def top_level_imports(source: str):
    """Top-level names of every absolute import in `source`."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules():
    return sorted(p for p in BENCH.rglob("*.py") if "_cache" not in p.parts)


def test_the_check_compares_whole_names():
    assert top_level_imports("import accelerated_features_tpu_torch.api") \
        & NEVER == set()
    assert top_level_imports("from accelerated_features_tpu.ops import x") \
        & NEVER == {"accelerated_features_tpu"}
    assert top_level_imports("import jax.numpy as jnp") & NEVER == {"jax"}
    assert top_level_imports("from . import check") == set()


def test_nothing_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): top_level_imports(p.read_text())
             & NEVER for p in modules()}
    assert len(found) > 20
    assert {k: v for k, v in found.items() if v} == {}


def test_the_reference_imports_nothing_of_the_program():
    ref = [p for p in modules() if "reference" in p.relative_to(BENCH).parts]
    assert len(ref) >= 5
    for p in ref:
        names = top_level_imports(p.read_text())
        assert PORT not in names and not names & NEVER, p
        # and nothing of the benchmark outside the reference
        text = p.read_text()
        assert "xfeat_bench" not in names, p
        assert "from .." not in text, p


def test_only_the_program_module_imports_the_port():
    """Of the harness, `program.py` alone; of the tests, the comparison
    with the reference and the runs that break the port's entries."""
    users = {str(p.relative_to(BENCH)) for p in modules()
             if PORT in top_level_imports(p.read_text())}
    assert users == {"program.py", "tests/test_xfeat_bench_reference.py",
                     "tests/test_xfeat_bench_cells.py"}
