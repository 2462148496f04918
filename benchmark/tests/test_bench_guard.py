"""Nothing the benchmark runs imports JAX, the JAX package, the repo's
scripts or tools; the reference imports nothing of the port."""

import ast
import subprocess
import sys

from benchmark.harness import guard
from benchmark.harness.spec import BENCH, ROOT


def test_forbidden_compares_whole_top_level_names():
    mods = {"ndp_nmpc_qd_tpu_torch": 1, "ndp_nmpc_qd_tpu_torch.solver.rti": 1,
            "jaxtyping": 1, "numpy": 1, "jax": 1, "jax.numpy": 1, "jaxlib.xla": 1,
            "flax.linen": 1, "ndp_nmpc_qd_tpu": 1, "ndp_nmpc_qd_tpu.solver": 1}
    assert guard.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "ndp_nmpc_qd_tpu",
        "ndp_nmpc_qd_tpu.solver"]
    assert guard.forbidden_modules({"ndp_nmpc_qd_tpu_torch": 1}) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_sources_import_nothing_forbidden():
    banned = guard.FORBIDDEN | {"bench_torch", "chip_smoke", "tools", "bench"}
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert guard.top_level(name) not in banned, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert guard.top_level(name) not in ("ndp_nmpc_qd_tpu_torch", "benchmark"), (
                path, name)


def test_what_run_loads_holds_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.drivers.scenario_batch, benchmark.drivers.formation\n"
        "from benchmark.harness import spec, guard, roofline\n"
        "import ndp_nmpc_qd_tpu_torch.sim.swarm_scale, ndp_nmpc_qd_tpu_torch.solver.rti\n"
        "s = spec.load_spec()\n"
        "[spec.reader(m['name']) for m in s['end_to_end'] + s['per_layer']]\n"
        "print(guard.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout
