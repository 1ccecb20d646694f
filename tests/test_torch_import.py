"""The port and ``chip_smoke.py`` import nothing of JAX or of the JAX
package, not even a module of it that is free of JAX."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = "llm_fine_tune_distributed_tpu_torch"
JAX_PKG = "llm_fine_tune_distributed_tpu"


def _port_modules():
    """Every module of the port, subpackages' modules included."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return [PORT] + [m.name for m in pkgutil.walk_packages([str(ROOT / PORT)], prefix=f"{PORT}.")]


def _sources():
    files = sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or name == JAX_PKG or name.startswith(JAX_PKG + ".")


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    modules = _port_modules()
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib') "
        f"or n == {JAX_PKG!r} or n.startswith({JAX_PKG + '.'!r}))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_have_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(n) for n in names), f"{path}: imports {names}"
    assert "import jax" not in path.read_text()


def test_guard_tells_the_port_from_the_jax_package():
    assert _is_forbidden("llm_fine_tune_distributed_tpu.models")
    assert _is_forbidden("llm_fine_tune_distributed_tpu")
    assert not _is_forbidden("llm_fine_tune_distributed_tpu_torch.models")


@pytest.mark.parametrize("module", ["infer.errors", "infer.golden", "eval_golden",
                                    "infer.engine", "infer.server", "observe.slo",
                                    "observe.capacity", "observe.flops", "observe.profiler",
                                    "observe.tracing", "infer.routing", "infer.fleet",
                                    "infer.paged", "infer.adapters", "parallel.lora",
                                    "infer.multihost", "parallel.sharding", "runtime.mesh",
                                    "runtime.failure", "runtime.native"])
def test_the_overload_and_golden_modules_are_covered(module):
    """The import check reaches the modules of the golden eval, of overload
    control, of serving observability and of the fleet and its host KV
    tier, not only the top-level ones."""
    assert f"{PORT}.{module}" in _port_modules()
    assert ROOT / PORT / (module.replace(".", "/") + ".py") in _sources()
