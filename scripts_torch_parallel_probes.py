"""The multi-GPU probes of ``PERF.md`` §6 (the sharded steps' repairs),
on the CPU.

    JAX_PLATFORMS=cpu python scripts_torch_parallel_probes.py

1. ``bench.bench_scaling(n=64, records=512, batch_size=32,
   device_counts=(1, 2), device="cpu")`` on two gloo ranks (two processes
   of this script joined through a file store): at n_src 64 = M H a
   placement by shape cut ``out_att`` to a rank's rows and both ranks
   raised; placed by name, it runs to its end.
2. The sharded linkpred loss at world size 1, dropout 0, on the first 32
   training positives of ``synthetic_ddi(n=64, n_edges=600, seed=3)`` and
   96 negatives, against the single-device ``linkpred_loss``.
3. ``train_distributed``'s losses (fused and materialised, world size 1)
   on unsorted edges (N 120, E 900, ``ScaleConfig(d=8, steps=3,
   batch_edges=128, seed=3)``) from the JAX initial parameters, against
   the JAX package's ``train_distributed`` on the same edges.
4. ``train_chunked`` at ``ScaleConfig()`` on ``chip_smoke.build_edges(20000,
   200000)`` in its own order and in (sender, receiver) order: the first
   batch's BCE of the positives and of the negatives, and three steps'
   losses.

Prints one line a probe.  Imports JAX for probe 3's reference, so it runs
where the JAX package does, not on the card's machine.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F


def scaling_rank(store: str, rank: int) -> None:
    from msha_gnn_torch import bench
    from msha_gnn_torch.parallel import initialize, shutdown

    initialize(f"file://{store}", 2, rank, device="cpu", timeout_s=120)
    try:
        out = bench.bench_scaling(n=64, records=512, batch_size=32,
                                  device_counts=(1, 2), device="cpu")
    finally:
        shutdown()
    if rank == 0:
        print(f"1. bench_scaling(n=64) on two gloo ranks: sizes {list(out)}",
              flush=True)


def probe_scaling() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, "--rank",
                                   str(rank), f"{tmp}/store"])
                 for rank in range(2)]
        codes = [p.wait(timeout=300) for p in procs]
    if any(codes):
        print(f"1. bench_scaling(n=64) on two gloo ranks: the ranks exited "
              f"{codes}", flush=True)


def probe_linkpred(mesh) -> None:
    from msha_gnn_torch import parallel as par
    from msha_gnn_torch.data import split_edges, synthetic_ddi
    from msha_gnn_torch.training.link_prediction import (LinkPredConfig,
                                                         LinkPredModel,
                                                         linkpred_loss)

    split = split_edges(synthetic_ddi(n=64, n_edges=600, seed=3),
                        num_neg=100, seed=3, pad_to_multiple=64)
    pos = [torch.from_numpy(np.asarray(t[:32])).long()
           for t in split["train_pos"]]
    neg = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 96)))
    batch = [*pos, neg[0], neg[1]]
    step, (model, opt, graph), _ = par.make_sharded_linkpred_step(
        split, mesh, hidden=16, seed=5)
    sharded = float(step(model, opt, graph, *batch))
    single = LinkPredModel(split["n"], LinkPredConfig(hidden=16, dropout=0.0,
                                                      seed=5),
                           generator=torch.Generator().manual_seed(5))
    want = float(linkpred_loss(single, split["graph"], batch, impl="torch"))
    print(f"2. linkpred, 32 positives and 96 negatives: sharded "
          f"{sharded:.6f}, single-device {want:.6f}", flush=True)


def probe_distributed(mesh) -> None:
    import jax

    import msha_gnn_tpu.parallel as jpar
    from msha_gnn_tpu.training import scale as jax_scale
    from msha_gnn_torch.models.convert import scale_params_from_jax
    from msha_gnn_torch.training import scale

    rng = np.random.default_rng(11)
    s = rng.integers(0, 120, 900).astype(np.int32)
    r = rng.integers(0, 120, 900).astype(np.int32)
    jcfg = jax_scale.ScaleConfig(d=8, steps=3, batch_edges=128, seed=3)
    cfg = scale.ScaleConfig(d=8, steps=3, batch_edges=128, seed=3)
    params = scale_params_from_jax(jax_scale._init_params(
        jax.random.key(jcfg.seed), 120, jcfg.d))
    jmesh = jpar.make_mesh(1, data_axis=1)
    for fused in (True, False):
        want = jax_scale.train_distributed(s, r, 120, jmesh, jcfg,
                                           fused=fused)["loss_history"]
        loss_fn, s2, r2, _ = scale.build_distributed(s, r, 120, mesh, cfg,
                                                     fused=fused)
        got = scale._train(loss_fn, params, s2, r2, 120, cfg)["loss_history"]
        print(f"3. train_distributed on unsorted edges, fused={fused}: JAX "
              f"{[round(v, 6) for v in want]}, port "
              f"{[round(v, 6) for v in got]}", flush=True)


def probe_positive_term() -> None:
    import chip_smoke
    from msha_gnn_torch.ops.chunked_rank1 import ChunkedRank1Gat
    from msha_gnn_torch.training import scale

    n = 20000
    src, dst = chip_smoke.build_edges(n, 200000, seed=0)
    cfg = scale.ScaleConfig(steps=3)
    for name, (a, b) in (("build_edges order", (src, dst)),
                         ("(sender, receiver) order",
                          scale.sort_edges(src, dst, n))):
        _, s, r, _ = scale.build_chunked(a, b, n, cfg, num_slices=1,
                                         device="cpu")
        op = ChunkedRank1Gat(s, r, n_src=n, n_dst=n, num_slices=1,
                             assume_sorted=True, device="cpu")
        params = scale._init_params(torch.Generator().manual_seed(cfg.seed),
                                    n, cfg.d)
        ps, pr, ns, nr = scale.draw_batch(np.random.default_rng(cfg.seed),
                                          s, r, n, cfg.batch_edges, "cpu")
        with torch.no_grad():
            z = scale._encode(params, None, None, n, None, cfg,
                              attention_fn=op)
            pos, neg = (z[ps] * z[pr]).sum(1), (z[ns] * z[nr]).sum(1)
            bce_pos = float(F.binary_cross_entropy_with_logits(
                pos, torch.ones_like(pos)))
            bce_neg = float(F.binary_cross_entropy_with_logits(
                neg, torch.zeros_like(neg)))
        losses = scale.train_chunked(a, b, n, cfg, num_slices=1,
                                     device="cpu")["loss_history"]
        print(f"4. {name}: least positive logit {float(pos.min()):.4f}, "
              f"BCE(pos) {bce_pos:.3e}, BCE(neg) {bce_neg:.6f}; losses "
              f"{losses}", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--rank"]:
        scaling_rank(argv[2], int(argv[1]))
        return 0
    from msha_gnn_torch import parallel as par

    probe_scaling()
    par.initialize(device="cpu")
    try:
        mesh = par.make_mesh()
        probe_linkpred(mesh)
        probe_distributed(mesh)
    finally:
        par.shutdown()
    probe_positive_term()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
