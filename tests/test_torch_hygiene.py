"""The port stands alone: no JAX, no flax/optax/orbax, nothing of
``msha_gnn_tpu``.

One test imports every module of ``msha_gnn_torch`` (and the port's
scripts, ``chip_smoke``, ``scripts_torch_profile``,
``scripts_torch_epoch_drift`` and ``scripts_torch_kernel_ab``) in a
fresh interpreter in which a ``sys.meta_path`` finder refuses those packages;
another scans the sources for such imports.
"""

import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msha_gnn_tpu")
SCRIPTS = ("chip_smoke", "scripts_torch_profile", "scripts_torch_epoch_drift",
           "scripts_torch_kernel_ab")


def _port_sources():
    return sorted((ROOT / "msha_gnn_torch").rglob("*.py")) + [
        ROOT / f"{name}.py" for name in SCRIPTS]


def test_every_module_imports_with_jax_blocked():
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys

        BLOCKED = {BLOCKED!r}

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Refuse())
        import msha_gnn_torch
        names = ["msha_gnn_torch", *{SCRIPTS!r}] + [
            m.name for m in pkgutil.walk_packages(
                msha_gnn_torch.__path__, "msha_gnn_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    visited = set(out.stdout.split())
    assert len(visited) >= 20  # every module was visited
    assert {"msha_gnn_torch.models.msha", "msha_gnn_torch.ops.dense",
            "msha_gnn_torch.ops.grouped", "msha_gnn_torch.ops.cuda"
            } <= visited


def test_sources_name_no_jax_package():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:%s)\b" % "|".join(BLOCKED), re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _port_sources()
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert len(_port_sources()) >= 20
