"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: compared by whole top-level
module names (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ppqsflhe_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_no_program(path):
    assert "ppqsflhe_tpu_torch" not in imported(path)


def test_the_check_sees_whole_names(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import ppqsflhe_tpu_torch.ckks\nfrom ppqsflhe_tpu.ckks import eval\n"
                   "import jaxtyping\nimportlib.import_module('jax.numpy')\n")
    assert imported(src) == {"ppqsflhe_tpu_torch", "ppqsflhe_tpu", "jaxtyping", "jax"}
    assert imported(src) & FORBIDDEN == {"ppqsflhe_tpu", "jax"}
