"""The port stands alone: no JAX, no flax/optax/orbax, nothing of
``msha_gnn_tpu``.

One test imports every module of ``msha_gnn_torch`` (and the port's
scripts, ``chip_smoke``, ``scripts_torch_profile``,
``scripts_torch_epoch_drift``, ``scripts_torch_kernel_ab`` and
``scripts_torch_step_ab``) in a fresh interpreter in which a ``sys.meta_path`` finder refuses those packages;
another scans the sources for such imports.  A third reads the package
data that ``pyproject.toml`` ships: every file a kernel source includes,
and the raw pipeline's asset.
"""

import fnmatch
import pathlib
import re
import subprocess
import sys
import textwrap
import tomllib

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msha_gnn_tpu")
SCRIPTS = ("chip_smoke", "scripts_torch_profile", "scripts_torch_epoch_drift",
           "scripts_torch_kernel_ab", "scripts_torch_step_ab")


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
            "msha_gnn_torch.ops.grouped", "msha_gnn_torch.ops.cuda",
            "msha_gnn_torch.training.temporal", "msha_gnn_torch.explain",
            "msha_gnn_torch.export", "msha_gnn_torch.data.raw",
            "msha_gnn_torch.utils.debug"} <= visited


def test_sources_name_no_jax_package():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:%s)\b" % "|".join(BLOCKED), re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _port_sources()
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert len(_port_sources()) >= 20


def test_package_data_ships_every_kernel_include_and_asset():
    """An installed wheel holds what the kernels' build reads: each
    ``#include "..."`` of ``csrc/*.cu`` (and of the headers) names a file
    that a pattern of ``msha_gnn_torch``'s package data matches, as do the
    package's data assets."""
    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    patterns = conf["tool"]["setuptools"]["package-data"]["msha_gnn_torch"]
    pkg = ROOT / "msha_gnn_torch"

    def shipped(path):
        rel = path.relative_to(pkg).as_posix()
        return any(fnmatch.fnmatch(rel, p) for p in patterns)

    csrc = pkg / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    includes = {m for src in sources for m in re.findall(
        r'^\s*#include\s+"([^"]+)"', src.read_text(), re.M)}
    assert {"runs.cuh", "gat_common.cuh"} <= includes
    for name in includes:
        assert (csrc / name).exists(), name
        assert shipped(csrc / name), f"csrc/{name} is not package data"
    for path in sources + sorted((pkg / "data" / "assets").glob("*")):
        assert shipped(path), path
