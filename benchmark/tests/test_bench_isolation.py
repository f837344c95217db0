"""The run's check for JAX compares top-level names whole, and nothing
of the harness or the reference loads JAX, the JAX package or (for the
reference) the port."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness.isolation import forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


def test_port_passes_jax_fails():
    ok = ["svt_av1_psyex_tpu_torch", "svt_av1_psyex_tpu_torch.api.encoder",
          "torch", "jaxtyping", "flaxen"]
    assert forbidden_modules(ok) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "svt_av1_psyex_tpu", "svt_av1_psyex_tpu.api"]
    assert forbidden_modules(bad + ok) == sorted(bad)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "svt_av1_psyex_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "svt_av1_psyex_tpu_torch" not in _imports(path), path


def test_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "import benchmark.harness.runner, benchmark.harness.check;"
            "import benchmark.reference.intra;"
            "from benchmark.harness.isolation import forbidden_modules;"
            "print(forbidden_modules(sys.modules))") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
