"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the plain
reference imports nothing of the program."""
import ast
import subprocess
import sys

from fedbench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = ROOT / "fedbench"


def imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 20
    for path in files:
        tops = {m.split(".")[0] for m in imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for mod in imports(path):
            top = mod.split(".")[0]
            assert top != "repro_torch", (path, mod)
            if top == "fedbench":
                assert mod.startswith("fedbench.reference"), (path, mod)


def test_a_run_loads_neither_in_its_process():
    code = ("import sys\n"
            f"sys.path[:0] = [{str(ROOT / 'fedbench' / 'tests')!r}]\n"
            "from fedbench_tiny import CELLS, run_tiny\n"
            "from fedbench import harness\n"
            "for c in CELLS: assert run_tiny(c, seconds=0.2)['correct']\n"
            "bad = harness.forbidden_modules()\n"
            "assert not bad, bad\n"
            "assert 'repro_torch' in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_forbidden_names_are_compared_whole(monkeypatch):
    from fedbench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert not set(harness.forbidden_modules()) & {"repro_torch_like", "jaxfoo"}
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax" in harness.forbidden_modules()
