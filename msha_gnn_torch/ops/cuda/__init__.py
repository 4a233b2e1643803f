"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

The sources live in ``msha_gnn_torch/csrc``; :mod:`._build` compiles them
with ``nvcc`` at first use.  Nothing here compiles or loads anything when
it is imported.
"""
