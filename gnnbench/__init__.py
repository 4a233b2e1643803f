"""The benchmark of ``msha_gnn_torch`` on NVIDIA GPUs.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix): ``python -m gnnbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  Everything a cell needs is found by name:

* ``configs/<config>.json``: the model's fields, its driver, its source;
* ``traffic/<mix>.json``: the graph's law and counts, and the batch;
* ``drivers/<driver>.py``: set-up and one step through the port's entry
  points;
* ``reference/<driver>.py``: the plain PyTorch reference of that driver;
* ``metrics/<metric>.py``: one per-layer metric each;
* ``counts/``: the operations and bytes the work needs, and the peaks.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or ``msha_gnn_tpu``;
the reference modules import nothing of ``msha_gnn_torch`` either.
"""
