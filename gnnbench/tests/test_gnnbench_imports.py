"""What a run may load: never JAX or the JAX package (top-level names
compared whole, so ``msha_gnn_torch`` passes), and the references nothing
of the program (CPU)."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from gnnbench import harness

ENV = {**os.environ, "PYTHONPATH": str(harness.ROOT)}


def run_py(code: str, cwd=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd or
                          harness.ROOT, capture_output=True, text=True,
                          timeout=240, env=ENV)


@pytest.mark.parametrize("names,found", [
    ({"msha_gnn_torch", "msha_gnn_torch.ops.cuda", "numpy"}, []),
    ({"jaxtyping", "msha_gnn_tpu_extra", "flaxen", "jaxlibx"}, []),
    ({"jax", "jax.numpy"}, ["jax"]),
    ({"jaxlib.xla_client"}, ["jaxlib"]),
    ({"flax.linen"}, ["flax"]),
    ({"msha_gnn_tpu.ops.pallas", "msha_gnn_torch"}, ["msha_gnn_tpu"]),
])
def test_forbidden_names_are_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_runs_of_both_cells_load_the_port_and_no_jax():
    code = r'''
import json, sys, time
from gnnbench import harness
hub = {"nodes": 400, "edges": 4000,
       "senders": {"law": "uniform", "order": "sorted"},
       "receivers": {"law": "power", "alpha": 1.5}, "batch_edges": 64}
ddi = {"nodes": 120, "pairs": 1500, "senders": {"law": "power", "alpha": 0.5},
       "receivers": {"law": "power", "alpha": 0.5}, "split": [1200, 150, 150],
       "batch_size": 128}
for w, t in (("scale-hub50m", hub), ("ddi-full", ddi)):
    harness.run_cell(w, 3, 0.2, False, t_start=time.perf_counter(),
                     device="cpu", traffic=t,
                     spec=harness.benchmark(held=True))
print(json.dumps([harness.forbidden_modules(),
                  "msha_gnn_torch" in sys.modules]))
'''
    out = run_py(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == [[], True]


def test_references_import_nothing_of_the_program():
    out = run_py("import sys, json\n"
                 "import gnnbench.reference.scale_chunked\n"
                 "import gnnbench.reference.linkpred_full\n"
                 "print(json.dumps(sorted({m.split('.')[0] for m in "
                 "sys.modules if m.startswith('msha')})))")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []
    for path in (harness.HERE / "reference").glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(msha|jax|flax)", text,
                             re.M), path


def test_cli_without_a_card_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would go ahead")
    out = subprocess.run(
        [sys.executable, "-m", "gnnbench.run", "--workload", "scale-hub50m",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
        env=ENV)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
