"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py``, no script under ``tools/`` and not the port sides of
the multi-rank tests (``tests/torch_multidev_port.py``,
``tests/torch_train_mesh_port.py``, ``tests/torch_dryrun_ranks.py``,
``tests/torch_serve_mesh_port.py``)
imports ``jax``
or the reference package ``repro`` (``repro_torch`` itself is allowed);
the reference side (``tests/torch_multidev_ref.py``) imports nothing of
the port."""
import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) \
    + [ROOT / "tests" / "torch_multidev_port.py",
       ROOT / "tests" / "torch_train_mesh_port.py",
       ROOT / "tests" / "torch_dryrun_ranks.py",
       ROOT / "tests" / "torch_serve_mesh_port.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_package_and_the_smoke_script():
    names = {p.name for p in FILES}
    assert {"vector.py", "fused.py", "ops.py", "ssm.py", "engine.py",
            "cc.py", "messages.py", "faults.py", "chip_smoke.py",
            "adamw.py", "compression.py", "pipeline.py", "ckpt.py",
            "steps.py", "loop.py", "train.py", "_tree.py", "sharding.py",
            "collectives.py", "compat.py", "mesh.py",
            "torch_multidev_port.py", "torch_train_mesh_port.py",
            "torch_dryrun_ranks.py", "torch_serve_mesh_port.py"} <= names
    assert (ROOT / "chip_smoke.py").is_file()


def test_reference_side_of_the_multirank_tests_imports_no_port():
    mods = {m.split(".")[0] for m in _imports(
        ROOT / "tests" / "torch_multidev_ref.py")}
    assert "repro" in mods and "repro_torch" not in mods


def test_detector_flags_banned_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.fabric import "
                     "vector\nfrom repro_torch import fabric\n"
                     "import importlib\nimportlib.import_module('repro')\n")
    found = [m.split(".")[0] for m in _imports(probe)]
    assert found.count("jax") == 1 and found.count("repro") == 2
    assert "repro_torch" in found


@pytest.mark.parametrize("module", ["fabric.cc", "fabric.messages",
                                    "fabric.faults", "fabric.vector",
                                    "train.loop", "launch.train",
                                    "parallel.collectives",
                                    "parallel.pipeline", "models.moe",
                                    "launch.mesh", "launch.dryrun",
                                    "launch.inspect_hlo"])
def test_fabric_layers_load_without_jax(module):
    """Importing each fabric layer in a fresh interpreter loads neither
    ``jax`` nor the reference package."""
    import os
    import subprocess
    import sys
    code = (f"import sys; import repro_torch.{module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
