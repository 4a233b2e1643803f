"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), end to end.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); TF32 off, stated.
2. build every CUDA kernel of the port from ``msha_gnn_torch/csrc``.
3. each kernel against its plain PyTorch version on the card, at the
   shapes the GCN serving path and a GCN training step (the forwards and
   their x gradients) give it, on a synthetic flow graph of the
   2015 data's shape (39,179 sources, 32 recipients, 233,887 records):
   error, median time of kernel / plain version / one PyTorch library call
   (a yardstick the port never calls), and the bytes-or-operations bound.
3b. the rank-1 GAT kernels (``r1l_fwd_f32`` at dropout rate 0 and 0.5, on
   the path's inputs, with the logits x30 and on a small graph with empty
   rows, ``r1l_bwd_f32`` at 0 and 0.5 with its keep mask, and the
   backward's dx: ``csr_spmm_f32`` weighted by ``q`` and the d = 1 column
   sum of ``dpre``) against their plain versions on the full-width
   link-prediction graph (synthetic ogbl-ddi, 4,267 nodes, 328,012 message
   edges, d = 64); times and bounds as in phase 3.

The kernels on the edge-run schedule (``csr_spmm_f32``,
``seg_reduce_f32``, ``r1l_fwd_f32``, ``r1l_bwd_f32``, ``flash_fwd_f32``,
``flash_bwd_f32``, ``r1_fwd_f32``, ``r1_bwd_f32``, ``csr_sddmm_f32``) are
launched twice on the same inputs and must give the same bits.  Kernels
are timed twice: by CUDA events (back-to-back calls, which under about 20
us measure the host's launch rate) and by ``torch.profiler``'s device time
over the same 20 calls, as is their library yardstick.
4. the serving path at full width (GCN, nfeat 128): checkpoint round trip,
   one full-score fill that must launch exactly the path's kernels, the
   fill against the plain path on the card and against a float64 dense
   reference on a small graph, then HTTP requests through ``make_server``.
3c. the materialised attention pipeline's kernels (``csr_sddmm_f32`` in
   both orientations, each also once through its C entry into a
   NaN-filled output (every slot written, the pads 0),
   ``seg_softmax_fwd_f32`` unmasked as the path runs it and, for
   correctness, with the build mask and with a mask that leaves one row
   fully masked, ``seg_softmax_bwd_f32``, both also twice bit for bit and
   once through their C entries into NaN-filled outputs and workspace;
   both again at dropout rate 0.5, the attention's keep mask folded into
   the walk, held bit for bit against the composition they replace
   (``att_k = att * keep_scale_plain``, ``dl`` of ``g * keep_scale_plain``),
   with device times at rate 0 and 0.5; and ``csr_spmm_f32`` weighted by
   attention, forward and transposed) against their plain versions on the
   same linkpred graph; times and bounds as in phase 3.
3d. the flash-GAT kernels (``flash_fwd_f32`` at dropout rate 0 and 0.5,
   ``flash_bwd_f32`` at 0 and 0.5 with its keep mask, and ``csr_spmm_f32``
   weighted by the backward's ``q`` as its dx) against their plain
   versions on the same linkpred graph, on the path's logits and on the
   same logits x30 (the online renormalisation), and on a small graph with
   empty rows and n not a multiple of 128 (an empty row's 0 and NEG, the
   zeroed pad slots); ``flash_fwd_f32`` also once through its C entry into
   NaN-filled outputs (every row written); times and bounds as in phase
   3.
3e. the generic rank-1 GAT kernels (``r1_fwd_f32``, ``r1_bwd_f32``, on
   ``c = h a_src`` and ``t = h a_dst`` of a seeded layer, then x30, and on
   a small rectangular graph with empty rows; each also once through its
   C entry into NaN-filled outputs and workspace), ``seg_reduce_f32`` on
   ``[E, 64]`` edge values over the linkpred row pointer (pads NaN), and
   ``csr_spmm_dw_f32`` in both directions with attention weights (its
   ``dw`` element by element against the unfused ``csr_sddmm_f32``, twice
   bit for bit, once through its C entry into NaN-filled outputs and
   workspace, its device time beside the unfused backward's: the
   weights' permute, ``csr_spmm_f32`` and ``csr_sddmm_f32``) against their
   plain versions on the same linkpred graph; then the generic pair's
   bfloat16 payload (``r1_fwd_bf16``, ``r1_bwd_bf16`` on ``x`` and ``t``
   rounded to bfloat16, twice bit for bit) beside the float32 kernels on
   the same values; times and bounds as in phase 3.
5. the link-prediction training path at full width
   (``LinkPredConfig()``: hidden 64, 2 heads, dropout 0.5, batch 4096):
   one training step that must launch exactly its kernels, the same step
   on the plain path from the same parameters and generator state (same
   dropout masks), one epoch whose loss must fall, the device's idle share
   over a few steps, and the evaluation (Hits@20, Hits@50, AUC).
6. the same with ``impl="materialised"``: one step that must launch
   exactly the materialised pipeline's kernels (the keep mask inside the
   three softmax launches each way, no kernel of its own; and, in the
   profiled steps, exactly two softmax grids a softmax call), held against
   the plain step and against the fused step from the same state, one
   epoch whose loss must fall and follow the fused epoch's step by step,
   each step's loss bit-equal to the unfolded composition's (the softmax
   kernel, then ``* keep_scale_plain``) from the same state, the idle
   share, and the evaluation's launches.
7. the same with ``impl="flash"``: one step that must launch exactly the
   flash path's kernels, held against the plain step and against the fused
   step from the same state, one epoch that must follow the fused epoch's
   step by step, the idle share, and the evaluation's launches.
3f. the rank-1 GAT logits ``sddmm(impl="cuda")`` on the linkpred graph:
   one ``csr_sddmm_f32`` launch on the width-2 columns ``[s_src, 1]``,
   ``[1, s_dst]`` forward and two d = 2 weighted ``csr_spmm_f32`` launches
   backward (exact counts), values and both gradients against the plain
   ``sddmm``; the kernel at d = 2 against its plain version; and the
   device time of the logits' forward plus backward three ways: the plain
   gather (``_gather_rows``, backward an indexed accumulate), the kernel
   path and an ``index_select`` gather (backward ``index_add_``).
8. the operator paths of phase 3e's kernels under autograd at full width,
   each with exact launch counts: the generic ``Rank1GatOperator`` against
   the dst_linear one at ``t = x a`` (output, ``dc``, ``da = x^T dt``,
   ``dx_lin = dx + dt a^T``); the generic operator at ``precision="bf16"``
   (one ``r1_fwd_bf16``, one ``r1_bwd_bf16`` and the two float32 SpMMs of
   ``dx`` and ``dt``) against the float32 one at 3e-2 and against the same
   operator on the CPU; five Adam steps of a one-layer rank-1 GAT
   link loss through each, whose losses must agree; ``SpmmOperator(
   fused_bwd=True)`` against ``fused_bwd=False`` in both directions; and
   ``segment_reduce_sorted``.

9. the MSHA serving path at full width (``TrainConfig()``: in 128, 64 a
   head, 2 heads, ``--predict_batch`` 1024) on the flow graph of phase 3,
   plain PyTorch (it launches none of the port's kernels, which is
   checked), each model's running statistics set from one train-mode
   forward, as training leaves them: checkpoint round trip, ``msha`` through the per-batch path
   against the same weights on the CPU, a 64-node request against one
   padded forward's first rows, ``ablation3`` through the cache fill
   against the CPU, one ``/v1/predict`` over HTTP for each, and the other
   three presets served once against the CPU.  Float32 matmuls stay at
   full precision (TF32 off, the default; asserted).
10. flow-model training on the same graph, written to a temporary data
   directory in the loader's format.  10a: ``cli train --model gcn
   --epochs 1 --in_features 128`` (3,290 steps of 64), then ``cli eval``
   and ``cli predict`` on its checkpoint, each with exact ``csr_spmm_f32``
   launches (a step 2 plain + 2 transposed, the forwards' and the x
   gradients', an evaluation or a fill 1 + 1); one step's launches split
   into forward and backward; the step's wall p50, device kernels, device
   time and idle share (20 timed steps, then ``torch.profiler`` over 20,
   after 5 of warm-up). 10b: MSHA at ``TrainConfig()`` through the same
   task, state and trainer, capped at 64 steps (one dispatch chunk; a
   full epoch is 3,290) and an evaluation of 1,024 test records (16
   padded batches), launching none of the port's kernels; its step as in
   10a. 10c: 8 steps of GCN and of ablation3 at dropout 0 on the card and
   on the CPU from the same weights and batches (losses, parameters), and
   two runs at dropout 0.5 from one seed (GCN bit for bit; MSHA's
   ``index_add_`` atomics bound stated).
11. the other flow presets, ``gat``, ``sage`` and ``hgane``, at
   ``TrainConfig()``'s widths on the same data directory, each capped as
   10b caps MSHA (64 steps, an evaluation of 1,024 test records), launching
   none of the port's kernels: a checkpoint read back by ``cli eval`` and
   ``cli predict``, the step's wall, kernels, device time and idle share,
   and the same 64 steps at dropout 0 on the card and on the CPU from one
   state (as 10c), then both evaluations of the 1,024 records.
12. the bfloat16 payload's kernels (``csr_spmm_bf16`` weighted by
   attention, forward and transposed; ``csr_spmm_dw_bf16`` in both
   directions; ``r1l_fwd_bf16`` and ``r1l_bwd_bf16`` at dropout rate 0 and
   0.5) against their plain versions on the same bfloat16 rows at the
   linkpred shapes, at the float32 kernels' tolerances, each twice bit for
   bit; event and device times beside the float32 kernel's on the same
   values, the bound at bfloat16 row bytes, ``torch.sparse.mm`` on
   bfloat16 values where this PyTorch takes it; then
   ``SpmmOperator(precision="bf16", fused_bwd=True)`` under autograd with
   exact launch counts against ``fused_bwd=False``; and the row broadcast
   of phase 14 alone, ``seg_expand_f32`` (bit for bit, pads 0) and its
   adjoint ``seg_reduce_f32`` at d = 1, against their plain versions,
   beside an ``index_select`` and ``torch.segment_reduce``.
13. one ``SparseGAT(precision="bf16")`` linkpred training step at
   ``LinkPredConfig()`` widths per impl, from the float32 run's state:
   exact launch counts; ``fused`` and ``materialised`` against the same
   step on the CPU at dropout 0 (the kernels' plain versions),
   ``materialised`` also against ``impl="torch"`` on the card, and both
   against the float32 step at 3e-2 of each value's largest; ``flash``
   bit-equal to its float32 step; the step's wall, kernels, device time
   and idle share beside the float32 step's.
14. out-of-core training (``training/scale.py::train_chunked``) at the
   repo's own size: ``scripts_scale_train.py``'s 50 M-edge power-law graph
   (2 M nodes, seed 0, its ``build_edges`` copied here), its edges put in
   (sender, receiver) order once on the host (``scale.sort_edges``, the
   order ``train_distributed`` draws from; its seconds printed on a line
   of their own), shared with phase 18b, ``ScaleConfig()``
   (d 32, batch 8192), 12 slices from the formula, 5 steps each of
   ``fused`` f32, ``fused`` bf16 and the materialised pipeline
   (``ChunkedSpmm``, the row softmax, ``broadcast_rows``): layout seconds,
   losses, the steady step wall p50 and edges/s, exact launches a step at
   12 slices, peak memory, the run's own last step under the profiler
   (kernels, device time, idle share, the largest kernels); the 12-slice
   f32 step's loss and gradients against one slice; on the full graph, at
   the seed's parameters and for two cotangents of the layer's output (the
   first batch's loss's and a dense normal one), every slice's
   ``r1l_fwd`` / ``r1l_bwd`` (f32 and bf16), its two ``dx`` SpMMs over the
   hub receiver's 1.6 M slots, the materialised forward and ``dx`` SpMMs
   and ``dw`` SDDMM, and the operators' merged outputs and gradients,
   against float64 plain versions on the same inputs; fused against
   materialised first loss, bf16 against f32 losses, and a cut graph
   (20,000 nodes, 200,000 edges) on the card against the CPU: 3 steps'
   losses, and the f32 first step's gradients.  On the heaviest slice (the
   longest row), the library yardsticks: ``torch.sparse.mm`` beside the
   ``q``-weighted dx SpMM, ``torch.segment_reduce`` beside the d = 1
   column sums of ``dpre``, ``torch.sparse.sampled_addmm`` beside the
   materialised ``dw`` SDDMM (each held to the kernel's values).
15. the link-prediction options and the LLP / SGAE drivers.  15a:
   ``LinkPredConfig(neighbor_fanout=16)`` (2 epochs, cut from 10; the
   fanout is this script's choice) through ``impl="auto"`` -> ``"fused"``
   on a subgraph drawn on the host each epoch: the draw's pieces timed
   (the sampler, ``from_coo``, the operators' build from the host arrays,
   the copy), the subgraphs and batches bit-equal to a CPU run's draws,
   the first subgraph's ``r1l_fwd_f32``, ``r1l_bwd_f32`` and dx SpMMs
   against their plain versions (times, bounds, library), one step's
   exact launches (3 + 3 + 6, as phase 5's step), its loss and gradients
   against the plain step from the same state, epoch 0's step losses and
   both epochs' mean losses against a plain (``impl="torch"``) run on the
   card at ``EPOCH_LOSS_RTOL``, the step wall p50, one profiled step an
   epoch, memory after each epoch (it must not grow: each epoch's
   operators are dropped), the evaluation on the full graph.  15b: one
   ``use_kd=True`` fused step on a subgraph: exact launches, the loss
   parts and gradients against the plain step.  15c: ``run_llp`` at
   ``LLPConfig()`` on the phase-3 graph (2 epochs, cut from 10) with 4,096
   'nb' sampled anchors and with ``kd_rank=0.1``; the step wall, kernels
   and idle share; at dropout 0 the teacher's embedding and the first
   ``CARD_CPU_STEPS`` losses against the CPU.  15d: ``run_sgae`` at
   ``SGAEConfig(pretrain_epochs=1, epochs=1)``, the pretrain and the
   temporal pretrain (with a second synthetic year) against the CPU, the
   fine-tune's first ``CARD_CPU_STEPS`` losses against the CPU; the
   walls.

16. the raw-data pipeline, joint multi-year training, attention
   explanation, scorer export and the NaN guard.  16a: 2015 and
   2016 as 233,887 synthetic raw records each (about 39 K node identities,
   32 school provinces, majors from the shipped table, every 50th county
   without GDP) and a 2017 without a flow file, through ``anonymize`` and
   ``write_anonymous_dataset`` (2015 and 2016 name their recipients in
   different orders), loaded with ``load_flow_graph``.  16b: ``cli train
   --years 2015,2016,2017`` at ``TrainConfig()``, 1 epoch on the first
   40,000 records a year (cut from 233,887): 2017 skipped, every step's
   loss finite, each year's last 50 below its first 50, the other years'
   tables bit-equal across each step, no kernel of the port; one step at
   dropout 0 against the CPU (loss, gradients); the step's wall, kernels,
   device time and idle share.  16c: ``cli explain --npz_path``: the
   recorded attention and intra weights against a CPU record forward of
   the same model, every top-K list of the JSON against the CPU's values
   rank by rank, clique rows rebuilt from the npz.  16d: ``cli export`` of
   a ``cli train --model gcn`` checkpoint as a portable table and of a
   64-step MSHA checkpoint as batches of 1,024, each loaded from its file
   and held to the live ``Predictor`` on 4,096 ids; one exported GCN call
   launches exactly 1 + 1 ``csr_spmm_f32`` (gc1 transposed, gc2 plain),
   counted in the kernels line, its device time beside the eager fill's;
   the table loaded on the CPU launches none.  16e: ``nan_guard()`` raises
   at an operator of an MSHA forward with a NaN feature and at
   ``csr_spmm_f32``'s own check; without it both run.
17. ``cli bench``, the benchmarks module, in phase 16's directory.  17a:
   ``csr_spmm_f32`` (``A x``; its float4 rows, ``x`` 16-byte aligned) and
   ``csr_sddmm_f32`` at d 128 on the benchmark's own inputs
   (``make_powerlaw_graph(131072, 131072, 2_000_000)``, column 0 about 38%
   of the edges), each against its plain version, twice bit for bit, once
   through its C entry into a NaN-filled output, with times, bound and
   yardstick (``torch.sparse.mm``, ``torch.sparse.sampled_addmm``).  17b:
   the attention benchmark's sparse path (the kernels: the d = 2 logits by
   ``csr_sddmm_f32``, ``seg_softmax_fwd_f32``, the att-weighted
   ``csr_spmm_f32`` both ways; under autograd ``seg_softmax_bwd_f32``,
   each SpMM's ``dw`` and ``dx``, the logits' adjoints) against its dense
   path on the 2015 inter graph at d 64, outputs and both gradients, with
   exact launches; each of those kernels against its plain version on the
   path's inputs; then ``bench_flagship_attention_paths``, its launches
   counted.  17c: ``python -m msha_gnn_torch.cli bench --which all`` in
   this process: one JSON line with every key of the JAX package's output
   (``xla`` -> ``torch``, ``pallas`` -> ``cuda``, no ``prng``), times
   finite and positive, ``records_per_s == batch_size / step_seconds``,
   ``mfu`` a number, exactly 23 launches each of ``csr_spmm_f32`` and
   ``csr_sddmm_f32`` and nothing else, the peak memory; then
   ``bench_serving`` at batch 1,024 and ``bench_flagship_size_sweep`` at
   39,179, 156,716 and 626,864 sources, launching no kernel of the port.
   The phase's seconds are printed.
18. the parallel layer (``msha_gnn_torch/parallel``) on this one card, world
   size 1 over NCCL through ``parallel.initialize()`` (an in-process store,
   no second process).  18a: on the linkpred graph at d 64,
   ``ShardedRank1Gat`` against ``Rank1GatOperator(dst_linear=True)`` and
   ``ShardedCsrSpmm`` against ``SpmmOperator`` (static and runtime
   weights), outputs and gradients bit for bit (the same kernels on the
   same CSR), with exact launches (1 ``r1l_fwd_f32``, 1 ``r1l_bwd_f32`` and
   2 ``csr_spmm_f32``; 2 ``csr_spmm_f32``; 2 and 1 ``csr_sddmm_f32``);
   ``DistributedSpmm`` and ``RingSpmm`` (forward, transpose, runtime
   weights, gradients) at the JAX tests' 1e-5, launching no kernel; each
   kernel the sharded operators launch against its plain version on the
   shard's arrays, with times, bound and yardstick.  18b:
   ``train_distributed`` on phase 14's 50 M-edge graph, ``ScaleConfig()``,
   5 steps fused (exactly 5 + 5 + 10 launches) and 5 materialised (none),
   each held to phase 14's ``train_chunked`` losses at the JAX test's rtol
   and atol 2e-4: the same edges, in the same (sender, receiver) order,
   for both drivers, so both draw the same batches from the seed; step
   wall p50, edges/s, peak memory; then the fused run's four kernels on
   its own shard at d 32 (one launch the whole 50 M-edge graph) against
   their plain versions
   (the two dx SpMMs, whose transposed hub row has 19 M edges, against
   float64), with times, bound and yardstick, as entries of their own
   whose launches are the run's (the dx SpMM's two uses read from the
   shard operator's counts).  18c: ``python -m msha_gnn_torch.cli bench --which
   scaling`` in this process (one JSON line, JAX's keys, the key ``"1"``
   only, efficiency null, ``records_per_s == 1024 / step_seconds``, no
   kernel launched), and the sharded MSHA step against the single-card
   step's first loss at 5e-5.  18d: ``device_health_check()`` ok, one
   ``run_with_restarts`` with a failure injected in epoch 1 and the resume
   from its checkpoint.  ``shutdown()`` at the end.  The phase's seconds
   and the script's are printed.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM published peaks (NVIDIA data sheet) at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N, M, N_CITY, N_PROV, RECORDS = 39179, 32, 291, 32, 233887
NFEAT = 128
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6  # f32, another summation order
SLICE_TOL = 1e-5                       # log-probs, kernel vs plain path
REF_TOL = 1e-5                         # log-probs vs float64 reference
DEVICE = "cuda"
MSHA_RTOL, MSHA_ATOL = 1e-4, 1e-5      # MSHA log-scores, card vs CPU
# one request vs the same padded batch's forward: the intra channels' sums
# by index_add_, whose float atomics add in another order each launch
MSHA_REPEAT_RTOL, MSHA_REPEAT_ATOL = 1e-5, 1e-6
PREDICT_BATCH = 1024                   # the CLI's --predict_batch
# flow training: card vs CPU from one state, at dropout 0, per-step losses
# (float32 sums in another order, through Adam steps) and parameters (Adam
# divides by the root of the second moment, so last-bit differences of
# small gradients move an update by a fraction of lr = 1e-3)
TRAIN_LOSS_RTOL, TRAIN_LOSS_ATOL = 1e-4, 1e-5
TRAIN_PARAM_ATOL = 1e-4                # plus Adam's share, card_against_cpu
# each step's gradients, card vs CPU, as a share of the model's largest:
# ablation3's norms take sums over 39,179 rows whose inputs reach the
# hundreds, and two summation orders on the CPU alone (one thread against
# eight) put its gradients 3.1e-4 of the largest apart
TRAIN_GRAD_REL = 1e-3
# the norms' running statistics: means and variances of sums over N rows
# (variances in the hundreds), float32 in another order, so relative
TRAIN_STATS_RTOL = 1e-4
CARD_CPU_STEPS = 8
# a training step's device kernels by kind, the first match in order
STEP_GROUPS = (("port kernels", ("csr_spmm", "fixup")),
               ("adam (foreach)", ("multi_tensor_apply",)),
               ("gemm", ("gemm",)),
               ("indexing", ("index", "gather", "scatter")),
               ("reductions", ("reduce_kernel",)),
               ("elementwise", ("elementwise",)))
# MSHA's training at defaults, capped (a full epoch is 3,290 steps); the
# other flow presets (phase 11) are capped the same way
MSHA_STEPS, MSHA_TRAIN_IDS, MSHA_TEST_IDS = 64, 4096, 1024
FLOW_PRESETS = ("gat", "sage", "hgane")
# phase 11's evaluation of 1,024 records after the same 64 steps, card vs
# CPU: the loss at TRAIN_LOSS_*; the rank and count metrics move by whole
# records where near-tied scores swap (one record of 1,024 is 9.8e-4 of
# accuracy), so an absolute 5e-3
REPORT_ATOL = 5e-3
# and its running statistics: HGANE's norms take the means of 64 batch
# rows (bn1) and 32 recipients (bn2), inputs of order 1, so an element near
# 0 carries the absolute error of its larger siblings; after 64 Adam steps
# whose parameters are held at TRAIN_PARAM_ATOL, each statistic is also
# held absolutely at this share of its largest value
FLOW_STATS_ATOL_REL = 1e-4

LP_SEED = 42                           # the linkpred CLI's default seed
LP_D = 64                              # LinkPredConfig().hidden
DROP_SEED = -123457                    # a fixed int32 dropout seed
# sums of up to 3,842 (dc) and 328,012 (da) terms, in another order
SUM_RTOL, SUM_ATOL_REL = 1e-4, 1e-5
STEP_LOSS_RTOL = 1e-5                  # kernel step vs plain step, loss
# and gradients, whose leaves' scales run from 1e-6 to 1e-2: rtol, and an
# atol of this share of each leaf's largest plain value (the plain path's
# index_add_ adds by atomics)
STEP_GRAD_RTOL, STEP_GRAD_ATOL_REL = 1e-3, 1e-5
# materialised or flash vs fused step loss: each is held to the plain step
# at STEP_LOSS_RTOL, so the two may differ by twice that
PATHS_LOSS_RTOL = 2 * STEP_LOSS_RTOL
# materialised or flash vs fused epoch, each step's loss: the same function
# from the same state, its float32 sums in another order, through 40 Adam
# steps.  That rounding alone moves a float32 epoch off a float64 one, and
# the ways (the plain path among them) off each other, by up to 1.6e-4
# (PERF.md, from scripts_torch_epoch_drift.py), so 3e-4.  A wrong kernel
# shows on the first step, held to the plain step at STEP_LOSS_RTOL and
# STEP_GRAD_*; this check catches what grows over the steps
EPOCH_LOSS_RTOL = 3e-4
# a bfloat16 linkpred step against the f32 step from one state: the JAX
# package's own bound for SparseGAT(precision="bf16") against float32
# (tests/test_pallas_spmm.py:485-505), as a share of each value's largest
BF16_STEP_TOL = 3e-2
# a bf16 step against its plain counterpart from one state: both round the
# same float32 values to bfloat16 (the rows, the cotangents), but values
# formed in another summation order differ in their last bits, and where
# one sits at a rounding boundary its bfloat16 copy moves by one bfloat16
# unit, at most 2^-7 of it; each gradient leaf is held at that share of
# its largest value, the loss at STEP_LOSS_RTOL (each kernel alone is held
# at the float32 tolerances on the same bfloat16 inputs, phase 12)
BF16_FLIP_TOL = 2 ** -7
# generic vs dst_linear rank-1 GAT, five Adam steps from one state: the same
# function, t = h a by a GEMM against a dot in the kernel (float32 rounding)
GENERIC_LOSS_RTOL = 1e-5
# out-of-core training (phase 14) at the repo's own size: the 50 M-edge
# power-law graph of scripts_scale_train.py (BASELINE config #5),
# ScaleConfig() (d 32, batch 8192, seed 0), 5 steps a mode
SCALE_NODES, SCALE_EDGES, SCALE_STEPS = 2_000_000, 50_000_000, 5
# (label, fused, precision) of the three runs
SCALE_MODES = (("fused f32", True, "f32"), ("fused bf16", True, "bf16"),
               ("materialised f32", False, "f32"))
# 12 slices against 1 on the same parameters and batch: the loss and each
# gradient at this share of its largest value (the merge of rows split
# between slices and sums over up to 19 M edges in another order)
SCALE_SLICE_REL = 1e-4
# fused against materialised first loss: the JAX package's own bound
# (tests/test_chunked_rank1.py:116-131)
SCALE_PATHS_TOL = 1e-3
# each bf16 step's loss against the f32 step's, relative (BF16_STEP_TOL)
SCALE_BF16_REL = BF16_STEP_TOL
# the cut graph, card against the CPU (the kernels' plain versions) from
# the same parameters and batches: 3 steps' losses relative (sums in
# another order through Adam steps; read at 8.8e-8 in both precisions),
# and the f32 first step's gradients at SUM_RTOL / SUM_ATOL_REL
SCALE_CUT_NODES, SCALE_CUT_EDGES, SCALE_CUT_STEPS = 20_000, 200_000, 3
SCALE_CARD_CPU_RTOL = 1e-5
# phase 15: sampled linkpred at LinkPredConfig() widths.  The fanout is
# this script's choice (the reference names none); 2 epochs (cut from 10);
# one step an epoch runs under the profiler (left out of the wall p50)
SAMPLED_FANOUT, SAMPLED_EPOCHS, SAMPLED_PROFILED_STEP = 16, 2, 10
LLP_EPOCHS = 2                         # run_llp at LLPConfig(), cut from 10
# phase 18: the parallel layer at world size 1 over NCCL.  DistributedSpmm
# and RingSpmm (plain per-shard sums) against SpmmOperator at the JAX
# package's bound (tests/test_dist_spmm.py); train_distributed against
# train_chunked's losses at the JAX package's bound
# (tests/test_scale_training.py:29-30)
DIST_TOL = 1e-5
DIST_TRAIN_TOL = 2e-4
# the sharded MSHA step against the single-card step, first loss
# (tests/test_parallel.py:93)
SHARDED_MSHA_RTOL = 5e-5
SCALING_KEYS = {"step_seconds", "records_per_s", "scaling_efficiency"}
# phase 16: two years of raw records at the 2015 data's shape (233,887
# records over about 39 K of RAW_POOL node identities, 32 recipients) and a
# year without records; the joint training's records cut to the first
# TEMPORAL_RECORDS a year (a full epoch of both years is 6,578 steps), every
# node's table kept
RAW_POOL, RAW_RECORDS = N, RECORDS
TEMPORAL_RECORDS = 40_000
TEMPORAL_YEARS = ("2015", "2016", "2017")
EXPLAIN_TOP_K = 100                    # cli explain's --top_k default
# the recorded attention and intra weights, card vs CPU (float32 GEMMs in
# another order; the values are probabilities and their weights)
EXPLAIN_RTOL, EXPLAIN_ATOL = 1e-5, 1e-6
# an exported scorer against the live Predictor: the JAX package's bounds
# (tests/test_export.py)
EXPORT_IDS = 4096
EXPORT_RTOL, EXPORT_ATOL = 1e-5, 1e-6
# phase 17: cli bench.  bench_spmm / bench_sddmm's defaults (the kernels
# at d 128 on 2 M power-law edges), the attention benchmark's width, and
# bench_flagship_size_sweep's default sizes
BENCH_NODES, BENCH_EDGES, BENCH_D = 131072, 2_000_000, 128
ATTENTION_D = 64
SWEEP_SIZES = (39179, 156716, 626864)
# the keys of the JAX package's benchmarks (msha_gnn_tpu/bench.py), which
# this script does not import; cli bench's with xla -> torch, pallas ->
# cuda and no prng
FLAGSHIP_KEYS = {"n", "m", "batch_size", "step_seconds",
                 "single_dispatch_step_seconds", "records_per_s",
                 "flops_per_step", "mfu", "dense_baseline_step_seconds",
                 "dense_baseline_n", "speedup_vs_dense_reference"}
SPMM_KEYS = {"impl", "edges", "d", "seconds", "edges_per_s",
             "effective_gbps", "roofline_fraction", "strict_roofline_fraction"}
SDDMM_KEYS = {"impl", "edges", "d", "seconds", "edges_per_s",
              "roofline_fraction"}
BENCH_KEYS = {"flagship": FLAGSHIP_KEYS, "spmm": SPMM_KEYS,
              "spmm_torch": SPMM_KEYS, "sddmm": SDDMM_KEYS,
              "sddmm_cuda": SDDMM_KEYS}
ATTENTION_KEYS = {"n", "m", "edges", "e_pad", "d", "dense_fwd", "sparse_fwd",
                  "dense_fwd_grad", "sparse_fwd_grad",
                  "dense_over_sparse_fwd", "dense_over_sparse_fwd_grad"}
SERVING_KEYS = {"batch_seconds", "predictions_per_s"}
SWEEP_KEYS = {"step_seconds", "records_per_s", "ns_per_node_per_step"}
# the fused epoch's metrics before the redesign of csr_spmm_f32 and
# r1l_bwd_f32 (the same data, seed and state), for comparison by eye
BEFORE_METRICS = ("before the edge-run kernels: Hits@20 0.0090, Hits@50 "
               "0.0288, AUC 0.932571")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 15, iters: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int = 20):
    """Device time of one call (ms): the CUDA kernels' own time over
    ``iters`` back-to-back calls under ``torch.profiler``, over ``iters``;
    None when the profiler saw no device time.  Event times of calls under
    about 20 us measure the host's launch rate; this does not."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(
        getattr(evt, "self_device_time_total", 0.0)
        or getattr(evt, "self_cuda_time_total", 0.0)
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(evt, "is_user_annotation", False))
    return us / 1e3 / iters if us else None


def same_bits(name, fn):
    """Two launches of ``fn`` on the same inputs give the same bits."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    firsts = first if isinstance(first, tuple) else (first,)
    seconds = second if isinstance(second, tuple) else (second,)
    if not all(torch.equal(u, v) for u, v in zip(firsts, seconds)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    log(f"  {name}: two launches bit for bit equal")


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(nbytes, flops):
    """Least time (ms, what bounds it) of moving ``nbytes`` at the HBM rate
    and doing ``flops`` at the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spmm_bound(ptr, col, x, n_rows, weighted=True):
    """Least time of one CSR SpMM on this data: each input read once (only
    the rows of x that the edges reference, at x's bytes a value; no
    weights when unweighted), the float32 output written once, and 2 flops
    per edge and feature (1, an add, when unweighted)."""
    e, d = col.numel(), x.shape[1]
    x_rows = int(torch.unique(col).numel())
    per_edge = 8 if weighted else 4
    nbytes = (4 * ptr.numel() + per_edge * e + x.element_size() * x_rows * d
              + 4 * n_rows * d)
    return bound(nbytes, (2 if weighted else 1) * e * d)


def phase_kernels(op, fg):
    """Phase 3: csr_spmm_f32 vs its plain version at the two GCN shapes,
    for the forwards and for a training step's x gradients."""
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cases = [
        # (entry, TPU kernel replaced, transpose, x rows): the two forwards
        # and, in a training step, their x gradients (the other direction)
        ("csr_spmm_f32[gc1 A^T x]",
         "msha_gnn_tpu/ops/pallas/spmm.py:244 _visit_kernel", True, fg.n_src),
        ("csr_spmm_f32[gc2 A x]",
         "msha_gnn_tpu/ops/pallas/spmm.py:747 _hub_kernel", False, fg.n_dst),
        ("csr_spmm_f32[gc2 dx A^T g]",
         "msha_gnn_tpu/ops/pallas/spmm.py:244 _visit_kernel", True, fg.n_src),
        ("csr_spmm_f32[gc1 dx A g]",
         "msha_gnn_tpu/ops/pallas/spmm.py:244 _visit_kernel", False, fg.n_dst),
    ]
    results = []
    for name, replaces, transpose, n_in in cases:
        x = torch.rand((n_in, M), generator=gen, device=DEVICE) - 0.5
        if transpose:
            ptr, col, w = op.t_ptr, op.t_col, op.t_w
            n_rows, n_cols = fg.n_dst, fg.n_src
        else:
            ptr, col, w = op.ptr, op.col, op.w
            n_rows, n_cols = fg.n_src, fg.n_dst
        run = cuda_spmm.run_for(col.numel(), M)
        got = cuda_spmm.csr_spmm(ptr, col, w, x, n_rows)
        want = cuda_spmm.csr_spmm_plain(ptr, col, w, x, n_rows)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel_err = float(((got - want).abs() / want.abs().clamp_min(1e-12))
                        .max())
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        log(f"  {name}: rows {n_rows}, edges {col.numel()}, d {M}, "
            f"{run} slots a run: max abs err {abs_err:.3e}, max rel err "
            f"{rel_err:.3e} (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        same_bits(name, lambda: cuda_spmm.csr_spmm(ptr, col, w, x, n_rows))
        a = torch.sparse_csr_tensor(ptr, col, w, size=(n_rows, n_cols),
                                    check_invariants=True)
        lib_out = torch.sparse.mm(a, x)
        if not torch.allclose(lib_out, want, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"{name}: torch.sparse.mm yardstick "
                                 "disagrees with the plain version")
        kernel = (lambda: cuda_spmm.csr_spmm(ptr, col, w, x, n_rows))
        ms, dev_ms = time_ms(kernel), device_ms(kernel)
        plain_ms = time_ms(lambda: cuda_spmm.csr_spmm_plain(ptr, col, w, x,
                                                            n_rows))
        library_ms = time_ms(lambda: torch.sparse.mm(a, x))
        lib_dev_ms = device_ms(lambda: torch.sparse.mm(a, x))
        bound_ms, bound_by = spmm_bound(ptr, col, x, n_rows)
        log(f"  {name}: kernel {ms:.4f} ms (device {fmt(dev_ms)}), plain "
            f"{plain_ms:.4f} ms, torch.sparse.mm {library_ms:.4f} ms (device "
            f"{fmt(lib_dev_ms)}), bound {bound_ms:.5f} ms ({bound_by})")
        results.append({
            "name": name, "route": "cuda",
            "source": "msha_gnn_torch/csrc/spmm.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms, "transpose": transpose,
        })
    return results


def close(name, got, want, rtol, atol):
    """Max errors of ``got`` against ``want``; raises past rtol/atol."""
    abs_err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=rtol, atol=atol)
    log(f"  {name}: max abs err {abs_err:.3e} (max |value| "
        f"{float(want.abs().max()):.3e}; rtol {rtol}, atol {atol:.1e})")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return abs_err


def prime_nan(*shapes):
    """Hand the caching allocator blocks full of NaN, so that an output
    slot a kernel does not write shows."""
    junk = [torch.full(s, float("nan"), device=DEVICE) for s in shapes]
    del junk


def nan_filled(name, shapes, launch, want, what="out, lse"):
    """One launch of a kernel through its C entry, ``launch(*buffers)``,
    into buffers of ``shapes`` filled with NaN (its outputs, then its
    workspace): every element of the outputs must be written, with the
    bits of ``want`` (the wrapper's launch on the same inputs, one tensor
    an output)."""
    bufs = [torch.full(s, float("nan"), device=DEVICE) for s in shapes]
    rc = launch(*bufs)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"{name}: the C entry returned {rc}")
    outs = bufs[:len(want)]
    if any(o.isnan().any() for o in outs):
        raise AssertionError(f"{name} left an element of {what} unwritten")
    if not all(torch.equal(o, w) for o, w in zip(outs, want)):
        raise AssertionError(f"{name}: the C entry's launch differs from "
                             "the wrapper's")
    log(f"  {name}: a launch through the C entry into NaN-filled {what} and "
        "workspace wrote every element, the wrapper's bits")


def small_graph(seed):
    """A 300 x 120 graph of density 0.05 with empty rows (first, middle,
    last), n not a multiple of 128, edges padded to a multiple of 128."""
    from msha_gnn_torch.graph import BipartiteGraph

    rng = np.random.default_rng(seed)
    dense = ((rng.random((300, 120)) < 0.05)
             * rng.integers(1, 5, (300, 120))).astype(np.float32)
    dense[[0, 151, 299]] = 0.0
    return BipartiteGraph.from_dense(dense, pad_to_multiple=128).to(DEVICE)


def linkpred_split():
    """The linkpred CLI's data at its defaults: synthetic ogbl-ddi."""
    from msha_gnn_torch.data import load_ddi, split_edges

    return split_edges(load_ddi(seed=LP_SEED), seed=LP_SEED)


def r1l_bounds(n, e, d, row_bytes=4):
    """Least times (ms, bound) of the two rank-1 GAT kernels on this data:
    every input read once (x once: it fits in L2), every output written
    once, and the flops the function needs at the float32 rate.  ``t =
    x @ a`` depends on the column only, so it counts once per node (2 n d),
    as does ``<gout[r], out[r]>`` per row; per edge and feature the
    forward needs the aggregation's multiply-add (2 E d), the backward
    ``<gout[r], x[j]>`` (2) and ``da``'s multiply-add (2).  The backward
    writes ``q`` and ``dpre`` (8 B an edge), not the ``[E, d]`` rows of
    ``z = q gout + dpre a`` that its dx sums.  ``row_bytes``: x's bytes a
    value (2 for the bfloat16 payload; the rest is float32)."""
    # ptr, col, c, a, x in; out, lse out
    fwd = bound(4 * (n + 1) + 4 * e + 4 * n + 4 * d + row_bytes * n * d
                + 4 * n * d + 4 * n, 2 * n * d + 2 * e * d)
    # ptr, col, c, a, x, gout, out, lse in; q, dpre, dc, da out
    bwd = bound(4 * (n + 1) + 4 * e + 4 * n + 4 * d + row_bytes * n * d
                + 2 * 4 * n * d + 4 * n + 8 * e + 4 * n + 4 * d,
                4 * n * d + 4 * e * d)
    return fwd, bwd


def phase_rank1_kernels(split):
    """Phase 3b: r1l_fwd_f32, r1l_bwd_f32 and the dx reduce vs their
    plain versions at the linkpred shapes."""
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    g = split["graph"].to(DEVICE)
    op = r1.Rank1GatOperator(g, dst_linear=True, dropout_rate=0.5)
    n, e, d = g.n_src, g.num_edges, LP_D
    deg = (op.ptr[1:] - op.ptr[:-1]).float()
    log(f"  graph: {n} rows, {e} edges ({g.num_padded_edges} padded), "
        f"row length mean {float(deg.mean()):.1f}, max {int(deg.max())}, "
        f"empty rows {int((deg == 0).sum())}; d {d}")
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    c = torch.randn(n, generator=gen, device=DEVICE)
    a = torch.randn(d, generator=gen, device=DEVICE) * 0.3
    x = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=DEVICE)

    log(f"  tolerances: out, lse, q at rtol {KERNEL_RTOL}, atol "
        f"{KERNEL_ATOL} (f32, another summation order); dpre (a difference "
        f"of two d-term dots), dc, da at rtol {SUM_RTOL}, atol "
        f"{SUM_ATOL_REL} x max|value| (sums of up to {int(deg.max())} and "
        f"{e} terms in another order), and so the dx SpMMs")
    (fwd_b, fwd_by), (bwd_b, bwd_by) = r1l_bounds(n, e, d)
    no_lib = ("none: no single PyTorch call computes the row softmax, the "
              "hashed dropout and the aggregation together")
    results = []
    small = small_graph(4)
    s_op = r1.Rank1GatOperator(small, dst_linear=True)
    s_c, s_a, s_x = (torch.rand(shape, generator=gen, device=DEVICE) - 0.5
                     for shape in ((300,), (d,), (120, d)))
    empty = small.row_ptr[1:] == small.row_ptr[:-1]
    for rate in (0.0, 0.5):
        args = (op.ptr, op.col, c, a, x, seed, rate, op.slope, n)
        errs = []
        for label, scale in (("path", 1.0), ("logits x30", 30.0)):
            big = (op.ptr, op.col, c * scale, a * scale, x, seed, rate,
                   op.slope, n)
            prime_nan((n, d), (n,))
            out, lse = r1.r1l_fwd(*big)
            want_out, want_lse = r1.rank1_gat_plain(*big)
            torch.cuda.synchronize()
            # x30, the logit's own dot <x[j], a>, rounded in another order
            # by the kernel and the plain version, is 30 times larger: out
            # and lse at the sums' tolerance (the one-block-per-row kernel
            # and the plain float32 version miss KERNEL_* there too, by
            # about as much: scripts_torch_kernel_ab.py, PERF.md)
            for name, got, want in (("out", out, want_out),
                                    ("lse", lse, want_lse)):
                live = want[want > r1.NEG / 2]  # lse: the rows with edges
                rtol, atol = ((KERNEL_RTOL, KERNEL_ATOL) if scale == 1.0
                              else (SUM_RTOL, SUM_ATOL_REL
                                    * float(live.abs().max())))
                errs.append(close(f"r1l_fwd_f32[{label}, rate {rate}] "
                                  f"{name}", got, want, rtol, atol))
        s_args = (s_op.ptr, s_op.col, s_c, s_a, s_x, seed, rate, s_op.slope,
                  300)
        prime_nan((300, d), (300,))
        out, lse = r1.r1l_fwd(*s_args)
        want_out, want_lse = r1.rank1_gat_plain(*s_args)
        torch.cuda.synchronize()
        errs += [close(f"r1l_fwd_f32[small graph, rate {rate}] out", out,
                       want_out, KERNEL_RTOL, KERNEL_ATOL),
                 close(f"r1l_fwd_f32[small graph, rate {rate}] lse", lse,
                       want_lse, KERNEL_RTOL, KERNEL_ATOL)]
        if out[empty].any() or not bool((lse[empty] == r1.NEG).all()):
            raise AssertionError("r1l_fwd_f32: an empty row got output or a "
                                 "finite lse")
        log(f"  r1l_fwd_f32[small graph, rate {rate}]: 300 x 120, "
            f"{int(empty.sum())} empty rows: 0 and NEG")
        same_bits(f"r1l_fwd_f32[rate {rate}]", lambda: r1.r1l_fwd(*args))
        kernel = (lambda: r1.r1l_fwd(*args))
        ms, dev_ms = time_ms(kernel), device_ms(kernel)
        plain_ms = time_ms(lambda: r1.rank1_gat_plain(*args), reps=5,
                           iters=5)
        log(f"  r1l_fwd_f32[rate {rate}]: {e} edges, "
            f"{cuda_spmm.warp_run(op.col.numel())} slots a run, "
            f"{r1.group_for(d)} lanes an edge: kernel {ms:.4f} ms (device "
            f"{fmt(dev_ms)}; the runs grid and the fix-up grid), plain "
            f"{plain_ms:.4f} ms, bound {fwd_b:.5f} ms ({fwd_by}); library "
            f"{no_lib}")
        results.append({
            "name": f"r1l_fwd_f32[rate {rate}]", "route": "cuda",
            "source": "msha_gnn_torch/csrc/rank1_gat.cu",
            "replaces": "msha_gnn_tpu/ops/pallas/rank1_gat.py:234 "
                        "_r1l_fwd_kernel",
            "launches": None, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": fwd_b, "bound_by": fwd_by,
            "library_ms": None, "device_ms": dev_ms,
            "library_device_ms": None})
    keep = r1.keep_scale_plain(torch.arange(e, device=DEVICE), seed, 0.5)
    for rate in (0.0, 0.5):
        out, lse = r1.rank1_gat_plain(op.ptr, op.col, c, a, x, seed, rate,
                                      op.slope, n)
        args = (op.ptr, op.col, c, a, x, gout, out, lse, seed, rate,
                op.slope, n)
        prime_nan((e,), (e,), (n,), (e * (2 + d),))
        q, dpre, dc, da = r1.r1l_bwd(*args)
        wq, wdpre, wdc, wda = r1.rank1_gat_bwd_plain(*args)
        torch.cuda.synchronize()
        err = max(
            close(f"r1l_bwd_f32[rate {rate}] q", q, wq, KERNEL_RTOL,
                  KERNEL_ATOL),
            close(f"r1l_bwd_f32[rate {rate}] dpre", dpre, wdpre, SUM_RTOL,
                  SUM_ATOL_REL * float(wdpre.abs().max())),
            close(f"r1l_bwd_f32[rate {rate}] dc", dc, wdc, SUM_RTOL,
                  SUM_ATOL_REL * float(wdc.abs().max())),
            close(f"r1l_bwd_f32[rate {rate}] da", da, wda, SUM_RTOL,
                  SUM_ATOL_REL * float(wda.abs().max())))
        if rate > 0:
            # the keep mask: q is 0 exactly on the dropped slots
            dropped = keep == 0
            if q[dropped].any() or not bool((q[~dropped & (wq > 1e-30)]
                                             > 0).all()):
                raise AssertionError("r1l_bwd_f32's keep mask differs from "
                                     "keep_scale_plain")
            log(f"  r1l_bwd_f32[rate 0.5]: keep mask bit-exact, "
                f"{int(dropped.sum())} of {e} slots dropped")
        same_bits(f"r1l_bwd_f32[rate {rate}]", lambda: r1.r1l_bwd(*args))
    kernel = (lambda: r1.r1l_bwd(*args))
    ms, dev_ms = time_ms(kernel), device_ms(kernel)
    plain_ms = time_ms(lambda: r1.rank1_gat_bwd_plain(*args), reps=5,
                       iters=5)
    log(f"  r1l_bwd_f32[rate 0.5]: {e} edges, {cuda_spmm.warp_run(e)} slots "
        f"a run: kernel {ms:.4f} ms (device {fmt(dev_ms)}; the runs grid and "
        f"the da / dc fix-up grid), plain {plain_ms:.4f} ms, bound "
        f"{bwd_b:.5f} ms ({bwd_by}); library {no_lib}")
    results.append({
        "name": "r1l_bwd_f32[rate 0.5]", "route": "cuda",
        "source": "msha_gnn_torch/csrc/rank1_gat.cu",
        "replaces": "msha_gnn_tpu/ops/pallas/rank1_gat.py:305 "
                    "_r1l_bwd_kernel",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bwd_b, "bound_by": bwd_by,
        "library_ms": None, "device_ms": dev_ms, "library_device_ms": None})

    # dx = A(q).T gout + (A.T dpre) a^T, as the operator assembles it: the
    # q-weighted transposed SpMM and the d = 1 column sum of dpre
    spmm = op.spmm
    got_dx = r1.assemble_dx(spmm, gout, a, q, dpre)
    rcv = g.receivers[:e].long()
    z = wq[:, None] * gout[cuda_spmm.edge_rows(op.ptr, e)] + wdpre[:, None] * a
    want_dx = z.new_zeros((n, d)).index_add_(0, rcv, z)
    del z
    torch.cuda.synchronize()
    close("dx assembled from q and dpre vs the plain z reduce", got_dx,
          want_dx, SUM_RTOL, SUM_ATOL_REL * float(want_dx.abs().max()))
    w_t = spmm.weights(q, True)
    dcol = dpre[:, None].contiguous()
    a_csr = torch.sparse_csr_tensor(spmm.t_ptr, spmm.t_col, w_t, size=(n, n))
    results.append(spmm_use(
        "r1l dx q A^T g", (spmm.t_ptr, spmm.t_col, w_t, gout, n),
        lambda: torch.sparse.mm(a_csr, gout), "torch.sparse.mm"))
    results.append(spmm_use(
        "r1l dpre column sum", (spmm.t_ptr, spmm.t_edge, None, dcol, n),
        lambda: dcol.new_zeros((n, 1)).index_add_(0, rcv, dcol),
        "index_add_"))
    return results


def kernel_use(name, source, replaces, kernel, plain, bnd, rtol, atol_rel,
               library=None, reference=None, reps=15, iters=20):
    """One use of a kernel on the card, on the inputs its caller closed
    over: ``kernel()`` against ``plain()`` (the first output of each) at
    ``rtol`` and ``atol_rel`` times the largest plain value, two launches
    bit for bit, the yardstick ``library = (call, values, lib_name)``
    (``values(call())`` held to the plain output at rtol 1e-4) where there
    is one, event and device times of kernel, plain version and yardstick
    (``reps`` x ``iters`` calls), the bound ``bnd``; returns its entry of
    the kernels line.  ``reference()``, where given, is the plain version
    in float64, held in place of ``plain()``'s value (sums over millions
    of edges, which a float32 plain version rounds past the bound)."""
    def first(out):
        return out[0] if isinstance(out, tuple) else out

    got = first(kernel())
    want = first(plain() if reference is None else reference())
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = close(name, got.to(want.dtype), want, rtol, atol_rel * scale)
    same_bits(name, kernel)
    ms, dev_ms = time_ms(kernel, reps, iters), device_ms(kernel, iters)
    plain_ms = time_ms(plain, reps, iters)
    library_ms = lib_dev_ms = None
    lib_name = "none"
    if library is not None:
        call, values, lib_name = library
        if not torch.allclose(values(call()).to(want.dtype), want,
                              rtol=1e-4, atol=1e-5 * max(1.0, scale)):
            raise AssertionError(f"{name}: the {lib_name} yardstick "
                                 "disagrees with the plain version")
        library_ms = time_ms(call, reps, iters)
        lib_dev_ms = device_ms(call, iters)
    log(f"  {name}: kernel {ms:.4f} ms (device {fmt(dev_ms)}), plain "
        f"{plain_ms:.4f} ms, {lib_name} {fmt(library_ms)} (device "
        f"{fmt(lib_dev_ms)}), bound {bnd[0]:.5f} ms ({bnd[1]})")
    return {**entry(name, source, replaces, err, ms, plain_ms, bnd,
                    library_ms),
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms}


def spmm_use(label, args, library, lib_name):
    """One use of ``csr_spmm_f32`` on the card (:func:`kernel_use`): at the
    sums' tolerance (sums of up to 3,842 terms), its library yardstick a
    dense result; returns its entry of the kernels line."""
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    ptr, col, w, x, n_rows = args
    e, d = col.numel(), x.shape[1]
    log(f"  csr_spmm_f32[{label}]: rows {n_rows}, edges {e}, d {d}, "
        f"{cuda_spmm.run_for(e, d)} slots a run")
    return kernel_use(
        f"csr_spmm_f32[{label}]", "spmm.cu",
        "msha_gnn_tpu/ops/pallas/spmm.py:244 _visit_kernel",
        lambda: cuda_spmm.csr_spmm(*args),
        lambda: cuda_spmm.csr_spmm_plain(*args),
        spmm_bound(ptr, col, x, n_rows, weighted=w is not None), SUM_RTOL,
        SUM_ATOL_REL, (library, lambda out: out, lib_name))


def sddmm_bound(ptr, col, a, b, n_out):
    """Least time of one CSR SDDMM on this data: the pointer, the column
    indices, the rows of ``a`` that own edges and of ``b`` that the edges
    reference read once, the ``n_out`` outputs (pads included) written
    once; 2 flops per edge and feature."""
    e, d = col.numel(), a.shape[1]
    a_rows = int(((ptr[1:] - ptr[:-1]) > 0).sum())
    b_rows = int(torch.unique(col).numel())
    nbytes = 4 * ptr.numel() + 4 * e + 4 * (a_rows + b_rows) * d + 4 * n_out
    return bound(nbytes, 2 * e * d)


def softmax_bounds(n, e, n_out, masked, drop=False):
    """Least times of the row softmax and its VJP on this data.  Forward:
    the pointer, the E logits and (if given) the E mask bytes read once,
    ``att`` [n_out] and ``lse`` [n] written once; per edge a max, the exp
    and add of the row sum, and the subtract and exp of ``att`` (5 E).
    Backward: the pointer, ``att`` and ``g`` read once, ``dl`` [n_out]
    written once; per edge the multiply-add of the row sum and
    ``att g - att rs`` (5 E).  With dropout (``drop``) the forward also
    writes ``att_k`` [n_out], and each slot takes the keep mask's hash (14
    integer operations, counted at the float32 rate: the table has no
    int32 peak) and one multiply, both ways."""
    per_slot = 15 * n_out if drop else 0
    fwd = bound(4 * (n + 1) + 4 * e + (e if masked else 0) + 4 * n_out
                + 4 * n + (4 * n_out if drop else 0), 5 * e + per_slot)
    bwd = bound(4 * (n + 1) + 8 * e + 4 * n_out, 5 * e + per_slot)
    return fwd, bwd


def entry(name, source, replaces, err, ms, plain_ms, bnd, library_ms):
    return {"name": name, "route": "cuda",
            "source": f"msha_gnn_torch/csrc/{source}", "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": library_ms}


def phase_materialised_kernels(split):
    """Phase 3c: csr_sddmm_f32, seg_softmax_fwd_f32 and
    seg_softmax_bwd_f32 (without and with the keep mask folded in) and the
    attention-weighted csr_spmm_f32 vs their plain versions at the
    linkpred shapes."""
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.ops.cuda.softmax import softmax_operator_for
    from msha_gnn_torch.ops.cuda.spmm import operator_for

    g = split["graph"].to(DEVICE)
    op, sop = operator_for(g), softmax_operator_for(g)
    n, e, e_pad, d = g.n_src, g.num_edges, g.num_padded_edges, LP_D
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    x = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    logits = torch.randn(e_pad, generator=gen, device=DEVICE) * 2
    gatt = torch.randn(e_pad, generator=gen, device=DEVICE)
    log(f"  graph: {n} rows, {e} edges ({e_pad} padded), d {d}; softmax "
        f"runs of {sop.run} slots, a warp a run, SpMM runs of "
        f"{cuda_spmm.warp_run(e)} slots")
    longest = int(torch.cat([op.ptr.diff(), op.t_ptr.diff()]).max())
    log(f"  tolerances: SDDMM and softmax forward at rtol {KERNEL_RTOL}, "
        f"atol {KERNEL_ATOL} (one d-term dot or one row's sums in another "
        f"order); the softmax VJP and the SpMMs at rtol {SUM_RTOL}, atol "
        f"{SUM_ATOL_REL} x max|value| (sums of up to {longest} terms)")

    results = []

    # SDDMM, both orientations: dw of A @ h is sddmm(g, x), of A.T @ h
    # sddmm(x, g); the training path runs the first, which alone has an
    # entry in the kernels line (with the larger error of the two)
    sd_run, sd_group = cuda_sddmm.RUN, r1.group_for(d)
    sd_errs, sd_entry = [], None
    log(f"  csr_sddmm_f32: the edge-run walk, {sd_run} slots a run, "
        f"{sd_group} lanes an edge")
    pattern = torch.sparse_csr_tensor(op.ptr, op.col,
                                      torch.zeros(e, device=DEVICE),
                                      size=(n, n))
    for label, (rows, cols) in (("sddmm(g, x)", (gout, x)),
                                ("sddmm(x, g)", (x, gout))):
        sd_args = (op.ptr, op.col, rows, cols, e_pad)
        prime_nan((e_pad,))
        got = cuda_sddmm.csr_sddmm(*sd_args)
        want = cuda_sddmm.csr_sddmm_plain(*sd_args)
        torch.cuda.synchronize()
        sd_errs.append(close(f"csr_sddmm_f32[{label}]", got, want,
                             KERNEL_RTOL, KERNEL_ATOL))
        if got[e:].any():
            raise AssertionError("csr_sddmm_f32 wrote a pad slot")
        kernel = (lambda sd_args=sd_args: cuda_sddmm.csr_sddmm(*sd_args))
        same_bits(f"csr_sddmm_f32[{label}]", kernel)
        nan_filled(
            f"csr_sddmm_f32[{label}]", ((e_pad,),),
            lambda out, rows=rows, cols=cols:
            cuda_sddmm._kernel_lib().csr_sddmm_f32(
                op.ptr.data_ptr(), op.col.data_ptr(), rows.data_ptr(),
                cols.data_ptr(), out.data_ptr(), n, e_pad, sd_run, sd_group,
                d, torch.cuda.current_stream().cuda_stream),
            (kernel(),), what="out (pads included)")
        ms, dev_ms = time_ms(kernel), device_ms(kernel)
        plain_ms = time_ms(lambda sd_args=sd_args:
                           cuda_sddmm.csr_sddmm_plain(*sd_args))
        library_ms = lib_dev_ms = None
        lib_note = ""
        try:
            colst = cols.t()
            lib_out = torch.sparse.sampled_addmm(pattern, rows, colst,
                                                 beta=0.0)
            if not torch.allclose(lib_out.values(), want[:e], rtol=1e-4,
                                  atol=1e-5):
                raise AssertionError("sampled_addmm disagrees with the "
                                     "plain version")

            def library(rows=rows, colst=colst):
                return torch.sparse.sampled_addmm(pattern, rows, colst,
                                                  beta=0.0)

            library_ms, lib_dev_ms = time_ms(library), device_ms(library)
        except (RuntimeError, NotImplementedError) as exc:
            lib_note = f" (torch.sparse.sampled_addmm does not run: {exc})"
        bnd = sddmm_bound(op.ptr, op.col, rows, cols, e_pad)
        log(f"  csr_sddmm_f32[{label}]: kernel {ms:.4f} ms (device "
            f"{fmt(dev_ms)}), plain {plain_ms:.4f} ms, "
            f"torch.sparse.sampled_addmm {library_ms} ms (device "
            f"{fmt(lib_dev_ms)}){lib_note}, bound {bnd[0]:.5f} ms "
            f"({bnd[1]})")
        sd_entry = sd_entry or {**entry(
            "csr_sddmm_f32[dw]", "sddmm.cu",
            "msha_gnn_tpu/ops/pallas/spmm.py:1428 _sddmm_kernel and :1294 "
            "_sddmm_hub_kernel", None, ms, plain_ms, bnd, library_ms),
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
    results.append({**sd_entry, "max_abs_err": max(sd_errs)})

    # the row softmax: unmasked, as the path runs it (the build mask
    # senders < n_src is False only on the pads, past ptr[-1]); then, for
    # correctness only, the build mask and a mask that leaves row 1 fully
    # masked
    if sop.mask is not None:
        raise AssertionError("the path's softmax operator reads a mask")
    arbitrary = g.edge_mask & (torch.rand(e_pad, generator=gen,
                                          device=DEVICE) > 0.3)
    p0, p1 = int(op.ptr[1]), int(op.ptr[2])
    arbitrary[p0:p1] = False
    errs = []
    for label, mask in (("path, no mask", None), ("build mask", g.edge_mask),
                        ("arbitrary mask", arbitrary)):
        att, lse = sm.seg_softmax_fwd(op.ptr, logits, mask, e, sop.run)
        want_att, want_lse = sm.seg_softmax_fwd_plain(op.ptr, logits, mask, e)
        torch.cuda.synchronize()
        errs.append(max(
            close(f"seg_softmax_fwd_f32[{label}] att", att, want_att,
                  KERNEL_RTOL, KERNEL_ATOL),
            close(f"seg_softmax_fwd_f32[{label}] lse", lse, want_lse,
                  KERNEL_RTOL, KERNEL_ATOL)))
        if att[e:].any() or (mask is not None and att[~mask].any()):
            raise AssertionError("a masked edge or pad got attention")
    if att[p0:p1].any():
        raise AssertionError("the fully masked row got attention")
    fwd_args = (op.ptr, logits, None, e)

    def fwd_kernel():  # into the operator's workspace, as the path runs it
        return sm.seg_softmax_fwd(*fwd_args, sop.run, sop.ws)

    same_bits("seg_softmax_fwd_f32[path]", fwd_kernel)
    n_ws = sm.ws_floats(e_pad, sop.run)
    nan_filled(
        "seg_softmax_fwd_f32[path]", ((e_pad,), (n,), (n_ws,)),
        lambda att_, lse_, ws_: sm._kernel_lib().seg_softmax_fwd_f32(
            op.ptr.data_ptr(), logits.data_ptr(), None, att_.data_ptr(),
            None, lse_.data_ptr(), ws_.data_ptr(), None, 0.0, 1.0, n, e,
            e_pad, sop.run, torch.cuda.current_stream().cuda_stream),
        fwd_kernel(), what="att (pads included), lse")
    ms, dev_ms = time_ms(fwd_kernel), device_ms(fwd_kernel)
    plain_ms = time_ms(lambda: sm.seg_softmax_fwd_plain(*fwd_args))
    rows = g.senders[:e].long()
    coo = torch.sparse_coo_tensor(torch.stack([rows, g.receivers[:e].long()]),
                                  logits[:e], size=(n, n)).coalesce()
    want_att = sm.seg_softmax_fwd_plain(*fwd_args)[0][:e]
    if not torch.allclose(torch.sparse.softmax(coo, 1).values(), want_att,
                          rtol=1e-4, atol=1e-6):
        raise AssertionError("torch.sparse.softmax yardstick disagrees with "
                             "the plain version")
    library_ms = time_ms(lambda: torch.sparse.softmax(coo, 1))
    lib_dev_ms = device_ms(lambda: torch.sparse.softmax(coo, 1), iters=5)
    (fwd_b, bwd_b) = softmax_bounds(n, e, e_pad, masked=False)
    log(f"  seg_softmax_fwd_f32[rate 0.0]: kernel {ms:.4f} ms (device "
        f"{fmt(dev_ms)}), plain {plain_ms:.4f} ms, torch.sparse.softmax "
        f"{library_ms:.4f} ms (device {fmt(lib_dev_ms)}), bound "
        f"{fwd_b[0]:.5f} ms ({fwd_b[1]})")
    results.append({**entry(
        "seg_softmax_fwd_f32[rate 0.0]", "softmax.cu",
        "msha_gnn_tpu/ops/pallas/softmax.py:56 _stats_kernel and :86 "
        "_expand_kernel", max(errs), ms, plain_ms, fwd_b, library_ms),
        "device_ms": dev_ms, "library_device_ms": lib_dev_ms})
    fwd_dev_ms0 = dev_ms

    # the attention's dropout folded into the walk, as the training path
    # runs it: att_k = att * keep_scale_plain bit for bit (the keep mask of
    # rank1_gat.py:85 _keep_scale, which had a kernel of its own before)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=DEVICE)
    keep = r1.keep_scale_plain(torch.arange(e_pad, device=DEVICE), seed, 0.5)

    def fwd_drop():
        return sm.seg_softmax_fwd_drop(*fwd_args, seed, 0.5, sop.run, sop.ws)

    att0, lse0 = fwd_kernel()
    att, att_k, lse = fwd_drop()
    torch.cuda.synchronize()
    if not (torch.equal(att, att0) and torch.equal(lse, lse0)
            and torch.equal(att_k, att0 * keep)):
        raise AssertionError("seg_softmax_fwd_f32[rate 0.5]: att_k is not "
                             "att * keep_scale_plain bit for bit")
    same_bits("seg_softmax_fwd_f32[rate 0.5]", fwd_drop)
    nan_filled(
        "seg_softmax_fwd_f32[rate 0.5]", ((e_pad,), (e_pad,), (n,), (n_ws,)),
        lambda att_, attk_, lse_, ws_: sm._kernel_lib().seg_softmax_fwd_f32(
            op.ptr.data_ptr(), logits.data_ptr(), None, att_.data_ptr(),
            attk_.data_ptr(), lse_.data_ptr(), ws_.data_ptr(),
            seed.data_ptr(), 0.5, 2.0, n, e, e_pad, sop.run,
            torch.cuda.current_stream().cuda_stream),
        fwd_drop(), what="att, att_k (pads included), lse")
    ms, dev_ms = time_ms(fwd_drop), device_ms(fwd_drop)
    plain_ms = time_ms(lambda: sm.seg_softmax_fwd_drop_plain(
        *fwd_args, seed, 0.5))
    fwd_db, bwd_db = softmax_bounds(n, e, e_pad, masked=False, drop=True)
    log(f"  seg_softmax_fwd_f32[rate 0.5], seed {DROP_SEED}: att_k = att * "
        f"keep_scale_plain bit for bit over {e_pad} slots (kept share "
        f"{float((keep > 0).float().mean()):.4f}); kernel {ms:.4f} ms "
        f"(device {fmt(dev_ms)}; rate 0 {fmt(fwd_dev_ms0)}), plain "
        f"{plain_ms:.4f} ms, bound {fwd_db[0]:.5f} ms ({fwd_db[1]}); library "
        "none: no PyTorch call computes the hash")
    results.append({**entry(
        "seg_softmax_fwd_f32[rate 0.5]", "softmax.cu",
        "msha_gnn_tpu/ops/pallas/softmax.py:56 _stats_kernel and :86 "
        "_expand_kernel, with rank1_gat.py:85 _keep_scale (the attention's "
        "keep mask) folded in", max(errs), ms, plain_ms, fwd_db, None),
        "device_ms": dev_ms, "library_device_ms": None})

    att = sm.seg_softmax_fwd_plain(*fwd_args)[0]
    bwd_args = (op.ptr, att, gatt, e)
    def bwd_kernel():
        return sm.seg_softmax_bwd(*bwd_args, sop.run, sop.ws)

    prime_nan((e_pad,), (n_ws,))
    dl = bwd_kernel()
    want_dl = sm.seg_softmax_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    err = close("seg_softmax_bwd_f32 dl", dl, want_dl, SUM_RTOL,
                SUM_ATOL_REL * float(want_dl.abs().max()))
    if dl[e:].any():
        raise AssertionError("seg_softmax_bwd_f32 wrote a pad slot")
    same_bits("seg_softmax_bwd_f32", bwd_kernel)
    nan_filled(
        "seg_softmax_bwd_f32", ((e_pad,), (n_ws,)),
        lambda dl_, ws_: sm._kernel_lib().seg_softmax_bwd_f32(
            op.ptr.data_ptr(), att.data_ptr(), gatt.data_ptr(),
            dl_.data_ptr(), ws_.data_ptr(), None, 0.0, 1.0, n, e, e_pad,
            sop.run, torch.cuda.current_stream().cuda_stream),
        (bwd_kernel(),), what="dl (pads included)")
    ms, dev_ms = time_ms(bwd_kernel), device_ms(bwd_kernel)
    plain_ms = time_ms(lambda: sm.seg_softmax_bwd_plain(*bwd_args))
    # the yardstick: torch.sparse.softmax's own backward on the forward's COO
    att_coo = torch.sparse.softmax(coo, 1)
    g_coo = torch.sparse_coo_tensor(att_coo.indices(), gatt[:e],
                                    size=(n, n)).coalesce()
    lib_dl = torch._sparse_softmax_backward_data(g_coo, att_coo, 1, coo)
    if not torch.allclose(lib_dl.coalesce().values(), want_dl[:e], rtol=1e-4,
                          atol=1e-5 * float(want_dl.abs().max())):
        raise AssertionError("the torch.sparse.softmax backward yardstick "
                             "disagrees with the plain version")
    def library():
        return torch._sparse_softmax_backward_data(g_coo, att_coo, 1, coo)

    library_ms = time_ms(library)
    lib_dev_ms = device_ms(library, iters=5)
    log(f"  seg_softmax_bwd_f32[rate 0.0]: kernel {ms:.4f} ms (device "
        f"{fmt(dev_ms)}), plain {plain_ms:.4f} ms, torch.sparse.softmax backward "
        f"{library_ms:.4f} ms (device {fmt(lib_dev_ms)}), bound "
        f"{bwd_b[0]:.5f} ms ({bwd_b[1]})")
    bwd_dev_ms0 = dev_ms

    # with the keep mask: dl of att_k's cotangent is dl of gatt * keep
    def bwd_drop():
        return sm.seg_softmax_bwd_drop(*bwd_args, seed, 0.5, sop.run, sop.ws)

    dl_k = bwd_drop()
    dl_0 = sm.seg_softmax_bwd(op.ptr, att, gatt * keep, e, sop.run, sop.ws)
    torch.cuda.synchronize()
    if not torch.equal(dl_k, dl_0):
        raise AssertionError("seg_softmax_bwd_f32[rate 0.5]: dl is not the "
                             "VJP of g * keep_scale_plain bit for bit")
    err_k = close("seg_softmax_bwd_f32[rate 0.5] dl", dl_k,
                  sm.seg_softmax_bwd_drop_plain(*bwd_args, seed, 0.5),
                  SUM_RTOL, SUM_ATOL_REL * float(want_dl.abs().max()))
    same_bits("seg_softmax_bwd_f32[rate 0.5]", bwd_drop)
    nan_filled(
        "seg_softmax_bwd_f32[rate 0.5]", ((e_pad,), (n_ws,)),
        lambda dl_, ws_: sm._kernel_lib().seg_softmax_bwd_f32(
            op.ptr.data_ptr(), att.data_ptr(), gatt.data_ptr(),
            dl_.data_ptr(), ws_.data_ptr(), seed.data_ptr(), 0.5, 2.0, n, e,
            e_pad, sop.run, torch.cuda.current_stream().cuda_stream),
        (bwd_drop(),), what="dl (pads included)")
    ms, dev_ms = time_ms(bwd_drop), device_ms(bwd_drop)
    plain_ms = time_ms(lambda: sm.seg_softmax_bwd_drop_plain(
        *bwd_args, seed, 0.5))
    log(f"  seg_softmax_bwd_f32[rate 0.5]: dl of g * keep_scale_plain bit "
        f"for bit; kernel {ms:.4f} ms (device {fmt(dev_ms)}; rate 0 "
        f"{fmt(bwd_dev_ms0)}), plain {plain_ms:.4f} ms, bound "
        f"{bwd_db[0]:.5f} ms ({bwd_db[1]}); library none: no PyTorch call "
        "computes the hash")
    results.append({**entry(
        "seg_softmax_bwd_f32[rate 0.5]", "softmax.cu",
        "msha_gnn_tpu/ops/pallas/softmax.py:102 _rowsum_kernel and :86 "
        "_expand_kernel, with rank1_gat.py:85 _keep_scale folded in",
        max(err, err_k), ms, plain_ms, bwd_db, None),
        "device_ms": dev_ms, "library_device_ms": None})

    # the attention-weighted SpMM: A(att) @ h forward, A(att).T @ g for dx
    w, w_t = op.weights(att, False), op.weights(att, True)
    for label, transpose, inp in (("att A h", False, x),
                                  ("att dx A^T g", True, gout)):
        ptr, col, ww = ((op.t_ptr, op.t_col, w_t) if transpose
                        else (op.ptr, op.col, w))
        a_csr = torch.sparse_csr_tensor(ptr, col, ww, size=(n, n))
        results.append(spmm_use(
            label, (ptr, col, ww, inp, n),
            lambda: torch.sparse.mm(a_csr, inp), "torch.sparse.mm"))
    return results


def flash_bounds(n, e, n_out, d, x_rows):
    """Least times (ms, bound) of the flash-GAT kernels on this data: every
    input read once (``logits`` and ``col`` for the E real edges, the
    ``x_rows`` rows of x that the edges reference), every output written
    once.  Forward: ``out`` and ``lse``; 2 E d flops (the aggregation's
    multiply-add).  Backward: ``gout``, ``out`` and ``lse`` read too, ``dl``
    and ``q`` [n_out] written; 2 E d flops (``<gout[r], x[j]>``) and 2 n d
    (``<gout[r], out[r]>``)."""
    common = 4 * (n + 1) + 8 * e + 4 * x_rows * d + 4 * n
    fwd = bound(common + 4 * n * d, 2 * e * d)
    bwd = bound(common + 2 * 4 * n * d + 8 * n_out, 2 * e * d + 2 * n * d)
    return fwd, bwd


def phase_flash_kernels(split):
    """Phase 3d: flash_fwd_f32, flash_bwd_f32 and the q-weighted dx SpMM
    vs their plain versions at the linkpred shapes, and on a small graph
    with empty rows."""
    from msha_gnn_torch.ops import sddmm
    from msha_gnn_torch.ops.cuda import flash_gat as fg
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    g = split["graph"].to(DEVICE)
    op = fg.FlashGatOperator(g, dropout_rate=0.5)
    spmm = op.spmm
    n, e, e_pad, d = g.n_src, g.num_edges, g.num_padded_edges, LP_D
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    # the path's logits: the plain rank-1 sddmm of s_src = h a_src, t = h a_dst
    logits = sddmm(g, torch.randn(n, generator=gen, device=DEVICE),
                   torch.randn(n, generator=gen, device=DEVICE))
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=DEVICE)
    log(f"  graph: {n} rows, {e} edges ({e_pad} padded), d {d}; logits "
        f"in [{float(logits[:e].min()):.2f}, {float(logits[:e].max()):.2f}]")
    log(f"  tolerances: out, lse, q at rtol {KERNEL_RTOL}, atol "
        f"{KERNEL_ATOL} (f32, another summation order); dl (a difference "
        f"of two d-term dots) and the dx SpMM at rtol {SUM_RTOL}, atol "
        f"{SUM_ATOL_REL} x max|value|")

    def check(label, graph_op, lg, xx, gg, rate, n_rows):
        """Both kernels vs plain on one input; returns the max errors."""
        args = (graph_op.ptr, graph_op.col, lg, xx, seed, rate, n_rows)
        prime_nan((n_rows, d), (n_rows,))
        out, lse = fg.flash_fwd(*args)
        want_out, want_lse = fg.flash_gat_plain(*args)
        bwd_args = (graph_op.ptr, graph_op.col, lg, xx, gg, want_out,
                    want_lse, seed, rate, n_rows)
        prime_nan((2, lg.numel()))
        dl, q = fg.flash_bwd(*bwd_args)
        want_dl, want_q = fg.flash_gat_bwd_plain(*bwd_args)
        torch.cuda.synchronize()
        fwd_err = max(
            close(f"flash_fwd_f32[{label}, rate {rate}] out", out, want_out,
                  KERNEL_RTOL, KERNEL_ATOL),
            close(f"flash_fwd_f32[{label}, rate {rate}] lse", lse, want_lse,
                  KERNEL_RTOL, KERNEL_ATOL))
        bwd_err = max(
            close(f"flash_bwd_f32[{label}, rate {rate}] q", q, want_q,
                  KERNEL_RTOL, KERNEL_ATOL),
            close(f"flash_bwd_f32[{label}, rate {rate}] dl", dl, want_dl,
                  SUM_RTOL, SUM_ATOL_REL * float(want_dl.abs().max())))
        n_edges = graph_op.col.numel()
        if dl[n_edges:].any() or q[n_edges:].any():
            raise AssertionError("flash_bwd_f32 left a pad slot nonzero")
        if rate > 0:
            # the keep mask: q is 0 exactly on the dropped slots
            dropped = r1.keep_scale_plain(
                torch.arange(n_edges, device=DEVICE), seed, rate) == 0
            kept = ~dropped & (want_q[:n_edges] > 1e-30)
            if q[:n_edges][dropped].any() or not bool(
                    (q[:n_edges][kept] > 0).all()):
                raise AssertionError("flash_bwd_f32's keep mask differs "
                                     "from keep_scale_plain")
        empty = graph_op.ptr[1:] == graph_op.ptr[:-1]
        if out[empty].any() or not bool((lse[empty] == fg.NEG).all()):
            raise AssertionError("an empty row got output or a finite lse")
        return fwd_err, bwd_err, int(empty.sum())

    errs = {}
    for label, lg in (("path logits", logits), ("logits x30", logits * 30)):
        for rate in (0.0, 0.5):
            errs[label, rate] = check(label, op, lg, x, gout, rate, n)[:2]
    small = small_graph(5)
    small_op = fg.FlashGatOperator(small)
    s_logits = torch.randn(small.num_padded_edges, generator=gen,
                           device=DEVICE) * 3
    s_x = torch.rand((120, d), generator=gen, device=DEVICE) - 0.5
    s_g = torch.rand((300, d), generator=gen, device=DEVICE) - 0.5
    for rate in (0.0, 0.5):
        small_err = check("small graph", small_op, s_logits, s_x, s_g, rate,
                          300)
    log(f"  small graph: 300 x 120, {small.num_edges} edges "
        f"({small.num_padded_edges} padded), {small_err[2]} empty rows: 0 "
        "and NEG, pads 0")

    x_rows = int(torch.unique(op.col).numel())
    (fwd_b, fwd_by), (bwd_b, bwd_by) = flash_bounds(n, e, e_pad, d, x_rows)
    no_lib = ("none: no single PyTorch call computes the row softmax, the "
              "hashed dropout and the aggregation together")
    results = []
    n_slots = op.col.numel()
    run, group = cuda_spmm.warp_run(n_slots), r1.group_for(d)
    lib = fg._kernel_lib()
    for rate in (0.0, 0.5):
        args = (op.ptr, op.col, logits, x, seed, rate, n)
        kernel = (lambda: fg.flash_fwd(*args))
        same_bits(f"flash_fwd_f32[rate {rate}]", kernel)
        nan_filled(
            f"flash_fwd_f32[rate {rate}]",
            ((n, d), (n,), (cuda_spmm.n_runs(n_slots, run) * (2 * d + 5),)),
            lambda out, lse, ws: lib.flash_fwd_f32(
                op.ptr.data_ptr(), op.col.data_ptr(), logits.data_ptr(),
                x.data_ptr(), seed.data_ptr(), rate, r1._scale(rate),
                out.data_ptr(), lse.data_ptr(), ws.data_ptr(), n, n_slots,
                run, group, d, fg.WARPS,
                torch.cuda.current_stream().cuda_stream),
            kernel())
        ms, dev_ms = time_ms(kernel), device_ms(kernel)
        plain_ms = time_ms(lambda: fg.flash_gat_plain(*args))
        log(f"  flash_fwd_f32[rate {rate}]: {run} slots a run, {group} lanes "
            f"an edge: kernel {ms:.4f} ms (device {fmt(dev_ms)}; the runs "
            f"grid and the fix-up grid), plain {plain_ms:.4f} ms, bound "
            f"{fwd_b:.5f} ms ({fwd_by}); library {no_lib}")
        err = max(errs[label, rate][0] for label in ("path logits",
                                                     "logits x30"))
        results.append({**entry(
            f"flash_fwd_f32[rate {rate}]", "flash_gat.cu",
            "msha_gnn_tpu/ops/pallas/flash_gat.py:51 _flash_kernel", err, ms,
            plain_ms, (fwd_b, fwd_by), None), "device_ms": dev_ms,
            "library_device_ms": None})
    log("  flash_bwd_f32[rate 0.5]: keep mask bit-exact (q 0 exactly on "
        "the dropped slots)")
    out, lse = fg.flash_gat_plain(op.ptr, op.col, logits, x, seed, 0.5, n)
    bwd_args = (op.ptr, op.col, logits, x, gout, out, lse, seed, 0.5, n)
    kernel = (lambda: fg.flash_bwd(*bwd_args))
    same_bits("flash_bwd_f32[rate 0.5]", kernel)
    ms, dev_ms = time_ms(kernel), device_ms(kernel)
    plain_ms = time_ms(lambda: fg.flash_gat_bwd_plain(*bwd_args))
    log(f"  flash_bwd_f32[rate 0.5]: {fg.BWD_RUN} slots a "
        f"run, {r1.group_for(d)} lanes an edge: kernel {ms:.4f} ms (device "
        f"{fmt(dev_ms)}), plain {plain_ms:.4f} ms, bound {bwd_b:.5f} ms "
        f"({bwd_by}); library {no_lib}")
    err = max(errs[label, 0.5][1] for label in ("path logits", "logits x30"))
    results.append({**entry(
        "flash_bwd_f32[rate 0.5]", "flash_gat.cu",
        "msha_gnn_tpu/ops/pallas/flash_gat.py:167 _flash_bwd_kernel", err,
        ms, plain_ms, (bwd_b, bwd_by), None), "device_ms": dev_ms,
        "library_device_ms": None})

    # dx = A(q).T gout: the q-weighted transposed SpMM, as the operator runs it
    _, q = fg.flash_gat_bwd_plain(*bwd_args)
    w_t = spmm.weights(q, True)
    a_csr = torch.sparse_csr_tensor(spmm.t_ptr, spmm.t_col, w_t, size=(n, n))
    results.append(spmm_use(
        "flash dx", (spmm.t_ptr, spmm.t_col, w_t, gout, n),
        lambda: torch.sparse.mm(a_csr, gout), "torch.sparse.mm"))
    return results


def generic_bounds(n, e, d, x_rows, t_rows, row_bytes=4):
    """Least times (ms, bound) of the generic rank-1 GAT kernels on this
    data: every input read once (``col`` for the E edges, ``c`` per row,
    ``t`` and ``x`` for the ``t_rows``/``x_rows`` columns the edges
    reference, x at ``row_bytes`` a value: 2 for the bfloat16 payload),
    every output written once.  Forward: ``out`` and ``lse``; 2 E d flops
    (the aggregation's multiply-add).  Backward: ``gout``, ``out`` and
    ``lse`` read too, ``att`` and ``dpre`` [E] and ``dc`` [n] written; 2 E
    d flops (``<gout[r], x[j]>``) and 2 n d (``<gout[r], out[r]>``)."""
    common = (4 * (n + 1) + 4 * e + 4 * n + 4 * t_rows
              + row_bytes * x_rows * d + 4 * n)
    fwd = bound(common + 4 * n * d, 2 * e * d)
    bwd = bound(common + 2 * 4 * n * d + 8 * e + 4 * n, 2 * e * d + 2 * n * d)
    return fwd, bwd


def dw_bound(ptr, col, eid, g, n_dw):
    """Least time of one fused SpMM backward on this data: the pointer, the
    column indices, the edge ids (when given) and the weights read once
    per edge, the rows of ``g`` that the edges reference and of ``x`` that
    own edges read once (at g's bytes a value: x is of g's type), ``dx``
    and ``dw`` [n_dw] written once in float32; 4 flops per edge and feature
    (the dx multiply-add and the dw dot)."""
    e, d = col.numel(), g.shape[1]
    g_rows = int(torch.unique(col).numel())
    x_rows = int(((ptr[1:] - ptr[:-1]) > 0).sum())
    per_edge = 12 if eid is not None else 8
    nbytes = (4 * ptr.numel() + per_edge * e
              + g.element_size() * (g_rows + x_rows) * d
              + 4 * (ptr.numel() - 1) * d + 4 * n_dw)
    return bound(nbytes, 4 * e * d)


def phase_generic_kernels(split):
    """Phase 3e: r1_fwd_f32, r1_bwd_f32, seg_reduce_f32 and csr_spmm_dw_f32
    vs their plain versions at the linkpred shapes."""
    from msha_gnn_torch.models.gat import SparseGATLayer
    from msha_gnn_torch.ops.cuda import flash_gat as fg
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    g = split["graph"].to(DEVICE)
    op = r1.Rank1GatOperator(g)
    spmm = op.spmm
    n, e, e_pad, d = g.n_src, g.num_edges, g.num_padded_edges, LP_D
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    # the layer draws its weights on the host, from a host generator
    layer = SparseGATLayer(d, d, generator=torch.Generator().manual_seed(4))
    layer = layer.to(DEVICE)
    with torch.no_grad():
        h = (torch.rand((n, d), generator=gen, device=DEVICE) - 0.5) @ layer.W
        av = layer.a.reshape(2 * d)
        c, t = h @ av[:d], h @ av[d:]
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    log(f"  graph: {n} rows, {e} edges ({e_pad} padded), d {d}; c = h a_src "
        f"in [{float(c.min()):.3f}, {float(c.max()):.3f}], t = h a_dst in "
        f"[{float(t.min()):.3f}, {float(t.max()):.3f}]")
    log(f"  tolerances: out, lse, att and dw at rtol {KERNEL_RTOL}, atol "
        f"{KERNEL_ATOL} (f32, another summation order); dpre (a difference "
        f"of two d-term dots), dc, the segment sums and the fused dx at rtol "
        f"{SUM_RTOL}, atol {SUM_ATOL_REL} x max|value|")

    def check(label, graph_op, cc, tt, xx, gg, n_rows):
        """Both generic kernels vs plain on one input; the max errors."""
        args = (graph_op.ptr, graph_op.col, cc, tt, xx, graph_op.slope,
                n_rows)
        prime_nan((n_rows, d), (n_rows,))
        out, lse = r1.r1_fwd(*args)
        want_out, want_lse = r1.rank1_gat_generic_plain(*args)
        bwd_args = (graph_op.ptr, graph_op.col, cc, tt, xx, gg, want_out,
                    want_lse, graph_op.slope, n_rows)
        n_edges = graph_op.col.numel()
        prime_nan((n_edges,), (n_edges,), (n_rows,))
        att, dpre, dc = r1.r1_bwd(*bwd_args)
        want_att, want_dpre, want_dc = r1.rank1_gat_generic_bwd_plain(
            *bwd_args)
        torch.cuda.synchronize()
        fwd_err = max(
            close(f"r1_fwd_f32[{label}] out", out, want_out, KERNEL_RTOL,
                  KERNEL_ATOL),
            close(f"r1_fwd_f32[{label}] lse", lse, want_lse, KERNEL_RTOL,
                  KERNEL_ATOL))
        bwd_err = max(
            close(f"r1_bwd_f32[{label}] att", att, want_att, KERNEL_RTOL,
                  KERNEL_ATOL),
            close(f"r1_bwd_f32[{label}] dpre", dpre, want_dpre, SUM_RTOL,
                  SUM_ATOL_REL * float(want_dpre.abs().max())),
            close(f"r1_bwd_f32[{label}] dc", dc, want_dc, SUM_RTOL,
                  SUM_ATOL_REL * float(want_dc.abs().max())))
        empty = graph_op.ptr[1:] == graph_op.ptr[:-1]
        if out[empty].any() or not bool((lse[empty] == r1.NEG).all()) \
                or dc[empty].any():
            raise AssertionError("an empty row got output, a finite lse or "
                                 "a dc")
        return fwd_err, bwd_err, int(empty.sum())

    errs = [check("path c, t", op, c, t, h, gout, n),
            check("c, t x30", op, c * 30, t * 30, h, gout, n)]
    small = small_graph(6)
    small_op = r1.Rank1GatOperator(small)
    s_c, s_t = (torch.randn(k, generator=gen, device=DEVICE) * 3
                for k in (300, 120))
    s_x = torch.rand((120, d), generator=gen, device=DEVICE) - 0.5
    s_g = torch.rand((300, d), generator=gen, device=DEVICE) - 0.5
    small_err = check("small graph", small_op, s_c, s_t, s_x, s_g, 300)
    log(f"  small graph: 300 x 120, {small.num_edges} edges "
        f"({small.num_padded_edges} padded), {small_err[2]} empty rows: 0, "
        "NEG and no dc")

    x_rows = int(torch.unique(op.col).numel())
    (fwd_b, fwd_by), (bwd_b, bwd_by) = generic_bounds(n, e, d, x_rows, x_rows)
    no_lib = ("none: no single PyTorch call computes the row softmax of the "
              "rank-1 logits and the aggregation (or its backward) together")
    args = (op.ptr, op.col, c, t, h, op.slope, n)
    n_slots = op.col.numel()
    run, group = cuda_spmm.warp_run(n_slots), r1.group_for(d)
    same_bits("r1_fwd_f32", lambda: r1.r1_fwd(*args))
    nan_filled(
        "r1_fwd_f32",
        ((n, d), (n,), (cuda_spmm.n_runs(n_slots, run) * (2 * d + 5),)),
        lambda out, lse, ws: r1._kernel_lib().r1_fwd_f32(
            op.ptr.data_ptr(), op.col.data_ptr(), c.data_ptr(), t.data_ptr(),
            h.data_ptr(), op.slope, out.data_ptr(), lse.data_ptr(),
            ws.data_ptr(), n, n_slots, run, group, d, r1._warps(d),
            torch.cuda.current_stream().cuda_stream),
        r1.r1_fwd(*args))
    out, lse = r1.rank1_gat_generic_plain(*args)
    bwd_args = (op.ptr, op.col, c, t, h, gout, out, lse, op.slope, n)
    b_run = r1.R1_BWD_RUN
    same_bits("r1_bwd_f32", lambda: r1.r1_bwd(*bwd_args))
    nan_filled(
        "r1_bwd_f32",
        ((n_slots,), (n_slots,), (n,),
         (cuda_spmm.sums_ws_floats(n_slots, b_run, 1),)),
        lambda att, dpre, dc, ws: fg._kernel_lib().r1_bwd_f32(
            op.ptr.data_ptr(), op.col.data_ptr(), c.data_ptr(), t.data_ptr(),
            h.data_ptr(), gout.data_ptr(), out.data_ptr(), lse.data_ptr(),
            op.slope, att.data_ptr(), dpre.data_ptr(), dc.data_ptr(),
            ws.data_ptr(), n, n_slots, b_run, group, d, fg.WARPS,
            torch.cuda.current_stream().cuda_stream),
        r1.r1_bwd(*bwd_args), what="att, dpre (pads included), dc")
    results = []
    for name, fn, plain, bnd, err, replaces in (
            ("r1_fwd_f32", r1.r1_fwd, r1.rank1_gat_generic_plain,
             (fwd_b, fwd_by), max(x[0] for x in errs + [small_err]),
             "msha_gnn_tpu/ops/pallas/rank1_gat.py:94 _r1_fwd_kernel"),
            ("r1_bwd_f32", r1.r1_bwd, r1.rank1_gat_generic_bwd_plain,
             (bwd_b, bwd_by), max(x[1] for x in errs + [small_err]),
             "msha_gnn_tpu/ops/pallas/rank1_gat.py:160 _r1_bwd_kernel")):
        a = args if name == "r1_fwd_f32" else bwd_args
        ms, dev_ms = time_ms(lambda: fn(*a)), device_ms(lambda: fn(*a))
        plain_ms = time_ms(lambda: plain(*a))
        how = (f"{run if name == 'r1_fwd_f32' else b_run} slots a run, "
               f"{group} lanes an edge, the runs grid and the fix-up grid")
        log(f"  {name} ({how}): kernel {ms:.4f} ms (device {fmt(dev_ms)}), "
            f"plain {plain_ms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}); "
            f"library {no_lib}")
        source = "rank1_gat.cu" if name == "r1_fwd_f32" else "flash_gat.cu"
        results.append({**entry(name, source, replaces, err, ms, plain_ms,
                                bnd, None), "device_ms": dev_ms,
                        "library_device_ms": None})

    # the generic pair's bfloat16 payload: x and t rounded to bfloat16, as
    # the operator passes them, against the plain versions on the same rows
    # at the float32 tolerances (both compute in float32 over the widened
    # rows), twice bit for bit, beside the float32 kernels on the same
    # values
    hb, tb = h.to(torch.bfloat16), t.to(torch.bfloat16).float()
    args16 = (op.ptr, op.col, c, tb, hb, op.slope, n)
    prime_nan((n, d), (n,))
    out16, lse16 = r1.r1_fwd(*args16)
    w_out16, w_lse16 = r1.rank1_gat_generic_plain(*args16)
    torch.cuda.synchronize()
    fwd16_err = max(
        close("r1_fwd_bf16 out", out16, w_out16, KERNEL_RTOL, KERNEL_ATOL),
        close("r1_fwd_bf16 lse", lse16, w_lse16, KERNEL_RTOL, KERNEL_ATOL))
    bwd16 = (op.ptr, op.col, c, tb, hb, gout, w_out16, w_lse16, op.slope, n)
    prime_nan((n_slots,), (n_slots,), (n,))
    att16, dpre16, dc16 = r1.r1_bwd(*bwd16)
    w_att16, w_dpre16, w_dc16 = r1.rank1_gat_generic_bwd_plain(*bwd16)
    torch.cuda.synchronize()
    bwd16_err = max(
        close("r1_bwd_bf16 att", att16, w_att16, KERNEL_RTOL, KERNEL_ATOL),
        close("r1_bwd_bf16 dpre", dpre16, w_dpre16, SUM_RTOL,
              SUM_ATOL_REL * float(w_dpre16.abs().max())),
        close("r1_bwd_bf16 dc", dc16, w_dc16, SUM_RTOL,
              SUM_ATOL_REL * float(w_dc16.abs().max())))
    same_bits("r1_fwd_bf16", lambda: r1.r1_fwd(*args16))
    same_bits("r1_bwd_bf16", lambda: r1.r1_bwd(*bwd16))
    b16 = generic_bounds(n, e, d, x_rows, x_rows, row_bytes=2)
    for name, fn, plain, a16, bnd, err, replaces, source in (
            ("r1_fwd_bf16", r1.r1_fwd, r1.rank1_gat_generic_plain, args16,
             b16[0], fwd16_err,
             "msha_gnn_tpu/ops/pallas/rank1_gat.py:94 _r1_fwd_kernel (bf16, "
             "lo_pass=False :149-151)", "rank1_gat.cu"),
            ("r1_bwd_bf16", r1.r1_bwd, r1.rank1_gat_generic_bwd_plain, bwd16,
             b16[1], bwd16_err,
             "msha_gnn_tpu/ops/pallas/rank1_gat.py:160 _r1_bwd_kernel (bf16 "
             "xt, :586-592)", "flash_gat.cu")):
        a32 = tuple(v.float() if v is hb else v for v in a16)
        ms, dev_ms = time_ms(lambda: fn(*a16)), device_ms(lambda: fn(*a16))
        plain_ms = time_ms(lambda: plain(*a16), reps=5, iters=5)
        f32_ms, f32_dev = (time_ms(lambda: fn(*a32)),
                           device_ms(lambda: fn(*a32)))
        log(f"  {name}: kernel {ms:.4f} ms (device {fmt(dev_ms)}), plain "
            f"{plain_ms:.4f} ms, the float32 kernel on the same values "
            f"{f32_ms:.4f} ms (device {fmt(f32_dev)}), bound {bnd[0]:.5f} ms "
            f"({bnd[1]}, bfloat16 rows); library {no_lib}")
        results.append({**entry(name, source, replaces, err, ms, plain_ms,
                                bnd, None), "device_ms": dev_ms,
                        "library_device_ms": None, "f32_ms": f32_ms,
                        "f32_device_ms": f32_dev})

    # the sorted segment sum: [E_pad, d] edge values over the row pointer,
    # the pads past ptr[n] NaN (never read)
    values = torch.rand((e_pad, d), generator=gen, device=DEVICE) - 0.5
    values[e:] = float("nan")
    seg_args = (values, g.senders, spmm.ptr)
    prime_nan((n, d))
    got = cuda_spmm.segment_reduce_sorted(*seg_args, n_src=n)
    want = cuda_spmm.segment_reduce_sorted_plain(*seg_args, n_src=n)
    torch.cuda.synchronize()
    err = close("seg_reduce_f32 out", got, want, SUM_RTOL,
                SUM_ATOL_REL * float(want.abs().max()))
    same_bits("seg_reduce_f32", lambda: cuda_spmm.segment_reduce_sorted(
        *seg_args, n_src=n))
    offsets, rows = spmm.ptr.long(), g.senders[:e].long()

    def library():
        return torch.segment_reduce(values[:e], "sum", offsets=offsets)

    lib_name = "torch.segment_reduce"
    try:
        lib_out = library()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  torch.segment_reduce does not run here ({exc}): index_add_")
        lib_name = "index_add_"

        def library():
            return values.new_zeros((n, d)).index_add_(0, rows, values[:e])

        lib_out = library()
    # sums of up to 3,842 rows in another order: the sums' tolerance
    if not torch.allclose(lib_out, want, rtol=SUM_RTOL,
                          atol=SUM_ATOL_REL * float(want.abs().max())):
        raise AssertionError(f"{lib_name} yardstick disagrees with the plain "
                             "version")
    kernel = (lambda: cuda_spmm.segment_reduce_sorted(*seg_args, n_src=n))
    ms, dev_ms = time_ms(kernel), device_ms(kernel)
    plain_ms = time_ms(lambda: cuda_spmm.segment_reduce_sorted_plain(
        *seg_args, n_src=n))
    library_ms, lib_dev_ms = time_ms(library), device_ms(library)
    index_add = (lambda: values.new_zeros((n, d)).index_add_(0, rows,
                                                             values[:e]))
    ia_ms, ia_dev_ms = time_ms(index_add), device_ms(index_add)
    # the pointer, the E rows of values, the output; one add an element
    bnd = bound(4 * (n + 1) + 4 * e * d + 4 * n * d, e * d)
    log(f"  seg_reduce_f32: rows {n}, edges {e} ({e_pad} slots), d {d}, "
        f"{cuda_spmm.run_for(e_pad, d)} slots a run: kernel {ms:.4f} ms "
        f"(device {fmt(dev_ms)}), plain {plain_ms:.4f} ms, {lib_name} "
        f"{library_ms:.4f} ms (device {fmt(lib_dev_ms)}), index_add_ "
        f"{ia_ms:.4f} ms (device {fmt(ia_dev_ms)}), bound {bnd[0]:.5f} ms "
        f"({bnd[1]})")
    results.append({**entry(
        "seg_reduce_f32", "spmm.cu",
        "msha_gnn_tpu/ops/pallas/spmm.py:81 _reduce_kernel", err, ms,
        plain_ms, bnd, library_ms), "device_ms": dev_ms,
        "library_device_ms": lib_dev_ms})

    # the fused dx + dw of the att-weighted SpMM, both directions: dx of
    # A @ x walks the CSC and writes dw through t_edge, of A.T @ x the CSR;
    # against its plain version and the unfused backward it replaces (the
    # weights' permute for A @ x, csr_spmm_f32 for dx, csr_sddmm_f32 for
    # dw), whose device time stands where a library call would: no
    # PyTorch call computes dx and dw together
    logits = torch.randn(e_pad, generator=gen, device=DEVICE) * 2
    att = sm.seg_softmax_fwd_plain(spmm.ptr, logits, None, e)[0]
    dw_run, dw_group = cuda_spmm.DW_RUN, r1.group_for(d)
    for label, transpose in (("dw of A x", False), ("dw of A^T x", True)):
        if transpose:
            args = (spmm.ptr, spmm.col, None, att, gout, h, n, e_pad)
            rows, cols = h, gout
        else:
            args = (spmm.t_ptr, spmm.t_col, spmm.t_edge, att, gout, h, n,
                    e_pad)
            rows, cols = gout, h
        ws = torch.empty(cuda_spmm.sums_ws_floats(e_pad, dw_run, d),
                         device=DEVICE)

        def kernel(args=args, ws=ws):
            return cuda_spmm.csr_spmm_dw(*args, ws)

        def unfused(transpose=transpose, rows=rows, cols=cols):
            return (spmm.apply(gout, att, not transpose),
                    cuda_sddmm.csr_sddmm(spmm.ptr, spmm.col, rows, cols,
                                         e_pad))

        prime_nan((e_pad,), (n, d), (ws.numel(),))
        dx, dw = kernel()
        want_dx, want_dw = cuda_spmm.csr_spmm_dw_plain(*args)
        unfused_dx, sd = unfused()
        torch.cuda.synchronize()
        err = max(
            close(f"csr_spmm_dw_f32[{label}] dx", dx, want_dx, SUM_RTOL,
                  SUM_ATOL_REL * float(want_dx.abs().max())),
            close(f"csr_spmm_dw_f32[{label}] dw", dw, want_dw, KERNEL_RTOL,
                  KERNEL_ATOL))
        close(f"csr_spmm_dw_f32[{label}] dw vs csr_sddmm_f32", dw, sd,
              KERNEL_RTOL, KERNEL_ATOL)
        close(f"csr_spmm_dw_f32[{label}] dx vs csr_spmm_f32", dx, unfused_dx,
              SUM_RTOL, SUM_ATOL_REL * float(unfused_dx.abs().max()))
        if dw[e:].any():
            raise AssertionError("csr_spmm_dw_f32 left a pad slot nonzero")
        same_bits(f"csr_spmm_dw_f32[{label}]", kernel)
        nan_filled(
            f"csr_spmm_dw_f32[{label}]", ((n, d), (e_pad,), (ws.numel(),)),
            lambda dx_, dw_, ws_, args=args:
            cuda_spmm._kernel_lib().csr_spmm_dw_f32(
                args[0].data_ptr(), args[1].data_ptr(),
                None if args[2] is None else args[2].data_ptr(),
                att.data_ptr(), gout.data_ptr(), h.data_ptr(),
                dx_.data_ptr(), dw_.data_ptr(), ws_.data_ptr(), n, e_pad,
                dw_run, dw_group, d, torch.cuda.current_stream().cuda_stream),
            kernel(), what="dx, dw (pads included)")
        ms, dev_ms = time_ms(kernel), device_ms(kernel)
        plain_ms = time_ms(lambda args=args:
                           cuda_spmm.csr_spmm_dw_plain(*args))
        unfused_ms, unfused_dev_ms = time_ms(unfused), device_ms(unfused)
        bnd = dw_bound(args[0], args[1], args[2], gout, e_pad)
        verdict = ("below" if dev_ms is not None and unfused_dev_ms is not None
                   and dev_ms < unfused_dev_ms else "NOT below")
        log(f"  csr_spmm_dw_f32[{label}] ({dw_run} slots a run, {dw_group} "
            f"lanes an edge, the runs grid and the fix-up grid): kernel "
            f"{ms:.4f} ms (device {fmt(dev_ms)}), plain {plain_ms:.4f} ms, "
            f"the unfused backward (the weights' permute, csr_spmm_f32, "
            f"csr_sddmm_f32) {unfused_ms:.4f} ms (device "
            f"{fmt(unfused_dev_ms)}): the kernel's device time {verdict} "
            f"it; bound {bnd[0]:.5f} ms ({bnd[1]}); library none: no "
            "PyTorch call computes dx and dw together")
        results.append({**entry(
            f"csr_spmm_dw_f32[{label}]", "spmm.cu",
            "msha_gnn_tpu/ops/pallas/spmm.py:282 _visit_dw_kernel and :340 "
            "_hub_dw_kernel", err, ms, plain_ms, bnd, None),
            "device_ms": dev_ms, "library_device_ms": None,
            "unfused_ms": unfused_ms, "unfused_device_ms": unfused_dev_ms})
    return results


def phase_operators(split):
    """Phase 8: the generic rank-1 GAT, the fused SpMM backward and the
    sorted segment sum through their operators under autograd at full
    width, each run with its counts set to 0 just before and read just
    after; returns the launches by kernel entry of phase 3e."""
    from msha_gnn_torch.models.gat import SparseGATLayer
    from msha_gnn_torch.ops import segment_reduce_sorted
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.ops.cuda.spmm import SpmmOperator

    g = split["graph"].to(DEVICE)
    gen_op, lin_op = r1.Rank1GatOperator(g), r1.Rank1GatOperator(
        g, dst_linear=True)
    spmm = gen_op.spmm
    n, e, e_pad, d = g.n_src, g.num_edges, g.num_padded_edges, LP_D
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    layer = SparseGATLayer(d, d, generator=torch.Generator().manual_seed(8))
    layer = layer.to(DEVICE)
    av = layer.a.detach().reshape(2 * d)
    x = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    h = (x @ layer.W.detach()).contiguous()
    c, a = h @ av[:d], av[d:].contiguous()
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    launches = {}

    # the generic operator against the dst_linear one at t = h a
    gen_in = [v.clone().requires_grad_() for v in (c, h @ a, h)]
    zero_counts(spmm)
    out_gen = gen_op(*gen_in)
    out_gen.backward(gout)
    torch.cuda.synchronize()
    counts = read_counts(spmm)
    log(f"  generic operator, one forward and backward: {counts}")
    want = expected(r1_fwd_f32=1, r1_bwd_f32=1, csr_spmm_f32=2,
                    csr_spmm_f32_transposed=2, csr_spmm_f32_reduce_edges=1)
    if counts != want:
        raise AssertionError(f"expected {want} launches, got {counts}")
    lin_in = [v.clone().requires_grad_() for v in (c, a, h)]
    out_lin = lin_op(*lin_in)
    out_lin.backward(gout)
    torch.cuda.synchronize()
    dc, dt, dx = (v.grad for v in gen_in)
    close("generic vs dst_linear out", out_gen.detach(), out_lin.detach(),
          KERNEL_RTOL, KERNEL_ATOL)
    for label, got, want_g in (
            ("dc", dc, lin_in[0].grad), ("h^T dt vs da", h.T @ dt,
                                         lin_in[1].grad),
            ("dx + dt a^T vs dx_lin", dx + dt[:, None] * a[None, :],
             lin_in[2].grad)):
        close(f"generic vs dst_linear {label}", got, want_g, SUM_RTOL,
              SUM_ATOL_REL * float(want_g.abs().max()))

    # the generic operator at precision="bf16": r1_fwd_bf16, r1_bwd_bf16,
    # and dx, dt by the float32 SpMMs of the float32 cotangent; against the
    # same operator on the CPU (the kernels' plain versions on the same
    # bfloat16 rows) at the float32 kernels' tolerances, and its output
    # against the float32 operator's at BF16_STEP_TOL of the largest value
    # (the JAX test holds the forward so, tests/test_rank1_gat.py:85-93).
    # Not the gradients: a logit near 0 whose bfloat16 t flips its leaky
    # slope moves dc by a whole 0.8 dl_e (6.2e-2 of a largest 0.33 at these
    # shapes on the card)
    gen16 = r1.Rank1GatOperator(g, precision="bf16")
    runs16 = {}
    for dev, graph16 in ((DEVICE, g), ("cpu", split["graph"])):
        op16 = gen16 if dev == DEVICE else r1.Rank1GatOperator(
            graph16, precision="bf16")
        ins16 = [v.detach().to(dev).requires_grad_() for v in gen_in]
        zero_counts(spmm)
        out16 = op16(*ins16)
        out16.backward(gout.to(dev))
        if dev == DEVICE:
            torch.cuda.synchronize()
            counts = read_counts(spmm)
            log(f"  generic operator at precision='bf16', one forward and "
                f"backward: {counts}")
            want = expected(r1_fwd_bf16=1, r1_bwd_bf16=1, csr_spmm_f32=2,
                            csr_spmm_f32_transposed=2,
                            csr_spmm_f32_reduce_edges=1)
            if counts != want:
                raise AssertionError(f"expected {want} launches, got "
                                     f"{counts}")
        runs16[dev] = [out16.detach().cpu()] + [v.grad.cpu() for v in ins16]
    launches["r1_fwd_bf16"] = launches["r1_bwd_bf16"] = 1
    ref = out_gen.detach().cpu()
    close("generic bf16 vs f32 out", runs16[DEVICE][0], ref, 0.0,
          BF16_STEP_TOL * float(ref.abs().max()))
    for i, label in enumerate(("out", "dc", "dt", "dx")):
        card, cpu = runs16[DEVICE][i], runs16["cpu"][i]
        if i == 0:
            close(f"generic bf16 card vs cpu {label}", card, cpu,
                  KERNEL_RTOL, KERNEL_ATOL)
        else:
            close(f"generic bf16 card vs cpu {label}", card, cpu, SUM_RTOL,
                  SUM_ATOL_REL * float(cpu.abs().max()))

    # five Adam steps of a one-layer rank-1 GAT link loss, each way
    pos = torch.as_tensor(np.stack(split["train_pos"]), device=DEVICE)
    k = min(4096, pos.shape[1])  # LinkPredConfig().batch_size positives
    pos = pos[:, torch.randperm(pos.shape[1], generator=gen,
                                device=DEVICE)[:k]].long()
    neg = torch.randint(0, n, (2, k), generator=gen, device=DEVICE)
    pairs = torch.cat([pos, neg], 1)
    labels = torch.cat([torch.ones(k, device=DEVICE),
                        torch.zeros(k, device=DEVICE)])
    init = [x.clone(), layer.W.detach().clone(), av.clone()]

    def train(form):
        emb, w, avec = (p.clone().requires_grad_() for p in init)
        opt = torch.optim.Adam([emb, w, avec], lr=0.01)
        losses = []
        for _ in range(5):
            hh = emb @ w
            cc = hh @ avec[:d]
            if form == "generic":
                z = gen_op(cc, hh @ avec[d:], hh)
            else:
                z = lin_op(cc, avec[d:], hh)
            z = torch.nn.functional.elu(z)
            score = (z[pairs[0]] * z[pairs[1]]).sum(1)
            loss = torch.nn.functional.binary_cross_entropy_with_logits(
                score, labels)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return losses

    zero_counts(spmm)
    losses_gen = train("generic")
    torch.cuda.synchronize()
    counts = read_counts(spmm)
    log(f"  five generic Adam steps: {counts}")
    want = expected(r1_fwd_f32=5, r1_bwd_f32=5, csr_spmm_f32=10,
                    csr_spmm_f32_transposed=10, csr_spmm_f32_reduce_edges=5)
    if counts != want:
        raise AssertionError(f"expected {want} launches, got {counts}")
    launches["r1_fwd_f32"] = counts["r1_fwd_f32"]
    launches["r1_bwd_f32"] = counts["r1_bwd_f32"]
    losses_lin = train("dst_linear")
    errs = [abs(p - q) / abs(q) for p, q in zip(losses_gen, losses_lin)]
    log(f"  five Adam steps, generic vs dst_linear losses: "
        + ", ".join(f"{p:.7f}/{q:.7f}" for p, q in zip(losses_gen,
                                                       losses_lin))
        + f"; max rel err {max(errs):.2e} (rtol {GENERIC_LOSS_RTOL})")
    if max(errs) > GENERIC_LOSS_RTOL or not losses_gen[-1] < losses_gen[0]:
        raise AssertionError("the generic and dst_linear steps differ, or "
                             "the loss did not fall")

    # SpmmOperator(fused_bwd=True) against fused_bwd=False, both directions
    fused_op = SpmmOperator(g, DEVICE, fused_bwd=True)
    logits = torch.randn(e_pad, generator=gen, device=DEVICE) * 2
    att = sm.seg_softmax_fwd_plain(spmm.ptr, logits, None, e)[0]
    for label, transpose in (("dw of A x", False), ("dw of A^T x", True)):
        grads = {}
        for fused, op in ((False, spmm), (True, fused_op)):
            xx, ww = h.clone().requires_grad_(), att.clone().requires_grad_()
            out = op(xx, transpose=transpose, edge_weight=ww)
            zero_counts(op)
            out.backward(gout)
            torch.cuda.synchronize()
            counts = read_counts(op)
            want = (expected(csr_spmm_dw_f32=1) if fused else
                    expected(csr_spmm_f32=1, csr_sddmm_f32=1,
                             csr_spmm_f32_transposed=int(not transpose)))
            log(f"  SpmmOperator(fused_bwd={fused}) backward of "
                f"{'A^T' if transpose else 'A'} x: {counts}")
            if counts != want:
                raise AssertionError(f"expected {want} launches, got "
                                     f"{counts}")
            grads[fused] = (xx.grad, ww.grad)
        launches[f"csr_spmm_dw_f32[{label}]"] = 1
        for name, got, want_g in zip(("dx", "dw"), grads[True],
                                     grads[False]):
            close(f"fused_bwd vs unfused {label}: {name}", got, want_g,
                  SUM_RTOL if name == "dx" else KERNEL_RTOL,
                  SUM_ATOL_REL * float(want_g.abs().max())
                  if name == "dx" else KERNEL_ATOL)
        if grads[True][1][e:].any():
            raise AssertionError("the fused dw has a nonzero pad slot")

    # segment_reduce_sorted
    values = torch.rand((e_pad, d), generator=gen, device=DEVICE) - 0.5
    zero_counts(spmm)
    got = segment_reduce_sorted(values, g.senders, spmm.ptr, n_src=n)
    torch.cuda.synchronize()
    counts = read_counts(spmm)
    log(f"  segment_reduce_sorted: {counts}")
    if counts != expected(seg_reduce_f32=1):
        raise AssertionError(f"expected one seg_reduce_f32 launch, got "
                             f"{counts}")
    launches["seg_reduce_f32"] = 1
    want = torch.zeros((n, d), device=DEVICE).index_add_(
        0, g.senders[:e].long(), values[:e])
    close("segment_reduce_sorted vs index_add_", got, want, SUM_RTOL,
          SUM_ATOL_REL * float(want.abs().max()))
    if tuple(got.shape) != (n, d) or not bool(torch.isfinite(got).all()):
        raise AssertionError("segment sums: shape or non-finite values")
    return launches


def read_counts(op=None):
    from msha_gnn_torch.ops.cuda import flash_gat as fg
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    counts = {"r1l_fwd_f32": r1.fwd_launches,
              "r1l_bwd_f32": r1.bwd_launches,
              "csr_spmm_f32": cuda_spmm.launches,
              "csr_sddmm_f32": cuda_sddmm.launches,
              "seg_softmax_fwd_f32": sm.fwd_launches,
              "seg_softmax_fwd_f32 dropout": sm.fwd_drop_launches,
              "seg_softmax_bwd_f32": sm.bwd_launches,
              "seg_softmax_bwd_f32 dropout": sm.bwd_drop_launches,
              "flash_fwd_f32": fg.fwd_launches,
              "flash_bwd_f32": fg.bwd_launches,
              "r1_fwd_f32": r1.r1_fwd_launches,
              "r1_bwd_f32": r1.r1_bwd_launches,
              "seg_reduce_f32": cuda_spmm.seg_launches,
              "csr_spmm_dw_f32": cuda_spmm.dw_launches,
              "csr_spmm_bf16": cuda_spmm.bf16_launches,
              "csr_spmm_dw_bf16": cuda_spmm.dw_bf16_launches,
              "r1l_fwd_bf16": r1.fwd_bf16_launches,
              "r1l_bwd_bf16": r1.bwd_bf16_launches,
              "r1_fwd_bf16": r1.r1_fwd_bf16_launches,
              "r1_bwd_bf16": r1.r1_bwd_bf16_launches,
              "seg_expand_f32": sm.expand_launches}
    # the operator's own counts take its launches of either row type
    if op is not None:
        counts["csr_spmm_f32 transposed"] = op.launches_transposed
        counts["csr_spmm_f32 reduce_edges"] = op.launches_reduce
    return counts


def zero_counts(op=None):
    from msha_gnn_torch.ops.cuda import flash_gat as fg
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    r1.fwd_launches = r1.bwd_launches = 0
    r1.r1_fwd_launches = r1.r1_bwd_launches = 0
    r1.fwd_bf16_launches = r1.bwd_bf16_launches = 0
    r1.r1_fwd_bf16_launches = r1.r1_bwd_bf16_launches = 0
    sm.expand_launches = 0
    cuda_spmm.launches = cuda_spmm.seg_launches = cuda_spmm.dw_launches = 0
    cuda_spmm.bf16_launches = cuda_spmm.dw_bf16_launches = 0
    cuda_sddmm.launches = sm.fwd_launches = sm.bwd_launches = 0
    sm.fwd_drop_launches = sm.bwd_drop_launches = 0
    fg.fwd_launches = fg.bwd_launches = 0
    if op is not None:
        op.launches = op.launches_transposed = op.launches_reduce = 0


def expected(**nonzero):
    """Launch counts with every kernel at 0 but those given."""
    names = ("r1l_fwd_f32", "r1l_bwd_f32", "csr_spmm_f32", "csr_sddmm_f32",
             "seg_softmax_fwd_f32", "seg_softmax_fwd_f32 dropout",
             "seg_softmax_bwd_f32", "seg_softmax_bwd_f32 dropout",
             "flash_fwd_f32", "flash_bwd_f32", "r1_fwd_f32", "r1_bwd_f32",
             "seg_reduce_f32", "csr_spmm_dw_f32", "csr_spmm_bf16",
             "csr_spmm_dw_bf16", "r1l_fwd_bf16", "r1l_bwd_bf16",
             "r1_fwd_bf16", "r1_bwd_bf16", "seg_expand_f32",
             "csr_spmm_f32 transposed", "csr_spmm_f32 reduce_edges")
    return {k: nonzero.get(k.replace(" ", "_"), 0) for k in names}


# launches of one training step and of one evaluation, per linkpred impl
STEP_WANT = {
    # each backward: r1l_bwd_f32, then dx from the q-weighted transposed
    # csr_spmm_f32 and the d = 1 column sum of dpre (reduce_edges; no
    # [E, d] z)
    "fused": expected(r1l_fwd_f32=3, r1l_bwd_f32=3, csr_spmm_f32=6,
                      csr_spmm_f32_transposed=6,
                      csr_spmm_f32_reduce_edges=3),
    # the attention's keep mask rides each softmax launch (no kernel or
    # torch multiply of its own)
    "materialised": expected(csr_spmm_f32=6, csr_spmm_f32_transposed=3,
                             csr_sddmm_f32=3, seg_softmax_fwd_f32=3,
                             seg_softmax_fwd_f32_dropout=3,
                             seg_softmax_bwd_f32=3,
                             seg_softmax_bwd_f32_dropout=3),
    "flash": expected(flash_fwd_f32=3, flash_bwd_f32=3, csr_spmm_f32=3,
                      csr_spmm_f32_transposed=3),
}
EVAL_WANT = {
    "fused": expected(r1l_fwd_f32=3),
    "materialised": expected(csr_spmm_f32=3, seg_softmax_fwd_f32=3),
    "flash": expected(flash_fwd_f32=3),
}


def phase_linkpred(split, impl):
    """Phases 5 (``impl="fused"``), 6 (``"materialised"``) and 7
    (``"flash"``): the linkpred training path at full width on the card."""
    from torch.profiler import ProfilerActivity, profile

    from msha_gnn_torch.ops.cuda.spmm import operator_for
    from msha_gnn_torch.training import (LinkPredConfig,
                                         build_link_prediction, evaluate,
                                         linkpred_loss, train_step)
    from msha_gnn_torch.training.link_prediction import epoch_batches

    t0 = time.perf_counter()
    cfg = LinkPredConfig(epochs=1,
                         impl="auto" if impl == "fused" else impl)
    run = build_link_prediction(split, cfg, device=DEVICE)
    op = operator_for(run.graph)
    if run.impl != impl:
        raise AssertionError(f"impl {cfg.impl} resolved to {run.impl} on "
                             "CUDA")
    batches = epoch_batches(run)
    torch.cuda.synchronize()
    log(f"  set-up {(time.perf_counter() - t0) * 1e3:.1f} ms: impl "
        f"{run.impl}, {len(batches)} steps of {batches.shape[2]} pairs, "
        f"parameters {sum(p.numel() for p in run.model.parameters())}")

    plain_model = copy.deepcopy(run.model)
    fused_model = copy.deepcopy(run.model) if impl != "fused" else None
    gen_state = run.generator.get_state()
    # materialised: each step's loss against the composition its softmax
    # walk folds, from the same parameters and generator state
    unfolded = [unfolded_loss(run, batches[0])] if impl == "materialised" \
        else None
    # the main path: counts set to 0 just before one step, read just after
    zero_counts(op)
    t0 = time.perf_counter()
    loss_k = train_step(run, batches[0])
    torch.cuda.synchronize()
    first_step_ms = (time.perf_counter() - t0) * 1e3
    step_counts = read_counts(op)
    log(f"  main path launches in one training step: {step_counts}")
    want = STEP_WANT[impl]
    if step_counts != want:
        raise AssertionError(f"expected {want} launches per step, got "
                             f"{step_counts}")

    grads_k = {k: p.grad for k, p in run.model.named_parameters()}
    gen = torch.Generator(device=DEVICE)
    gen.set_state(gen_state)
    loss_p = linkpred_loss(plain_model, run.graph, batches[0], impl="torch",
                           generator=gen)
    loss_p.backward()
    torch.cuda.synchronize()
    if read_counts(op) != step_counts:
        raise AssertionError("the plain path launched a kernel")
    loss_p = loss_p.detach()
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    log(f"  step loss: kernel path {float(loss_k):.7f}, plain path "
        f"{float(loss_p):.7f}, rel err {loss_err:.2e} (rtol "
        f"{STEP_LOSS_RTOL})")
    if loss_err > STEP_LOSS_RTOL:
        raise AssertionError("step loss: kernel path vs plain path")
    for name, p in plain_model.named_parameters():
        got, want_g = grads_k[name], p.grad
        err = float((got - want_g).abs().max())
        scale = float(want_g.abs().max())
        log(f"  grad {name} {tuple(p.shape)}: max abs err {err:.3e} (max "
            f"|value| {scale:.3e})")
        if not scale > 0 or not torch.allclose(
                got, want_g, rtol=STEP_GRAD_RTOL,
                atol=STEP_GRAD_ATOL_REL * scale):
            raise AssertionError(f"gradient of {name}: kernel path vs "
                                 "plain path")
    log(f"  gradients agree at rtol {STEP_GRAD_RTOL}, atol "
        f"{STEP_GRAD_ATOL_REL} x each leaf's max |value|")
    if impl != "fused":
        gen.set_state(gen_state)
        loss_f = float(linkpred_loss(fused_model, run.graph, batches[0],
                                     impl="fused", generator=gen).detach())
        paths_err = abs(float(loss_k) - loss_f) / abs(loss_f)
        log(f"  step loss: {impl} {float(loss_k):.7f}, fused {loss_f:.7f} "
            f"from the same state, rel err {paths_err:.2e} (rtol "
            f"{PATHS_LOSS_RTOL})")
        if paths_err > PATHS_LOSS_RTOL:
            raise AssertionError(f"step loss: {impl} vs fused")

    losses, step_ms, aside_s = [float(loss_k)], [], 0.0
    t_epoch = time.perf_counter()
    for batch in batches[1:]:
        if unfolded is not None:
            t0 = time.perf_counter()
            unfolded.append(unfolded_loss(run, batch))
            aside_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        losses.append(float(train_step(run, batch)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    epoch_s = (time.perf_counter() - t_epoch - aside_s
               + first_step_ms / 1e3)
    if unfolded is not None:
        differ = [i for i, (u, v) in enumerate(zip(losses, unfolded))
                  if u != v]
        log(f"  each of the {len(losses)} step losses against the unfolded "
            f"composition (softmax kernel, then * keep_scale_plain) from the "
            f"same state: {len(losses) - len(differ)} bit-equal"
            + (f", steps {differ} differ" if differ else ""))
        if differ:
            raise AssertionError("the folded keep mask changed a step loss")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"  epoch of {len(losses)} steps: loss first-5 mean {first5:.5f}, "
        f"last-5 mean {last5:.5f}")
    if not all(np.isfinite(losses)) or not last5 < first5:
        raise AssertionError("the epoch's loss did not fall")

    more = epoch_batches(run)[:5]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in more:
            train_step(run, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a user annotation (Adam's step) spans listed kernels
    busy_us = sum(
        getattr(evt, "self_device_time_total", 0.0)
        or getattr(evt, "self_cuda_time_total", 0.0)
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(evt, "is_user_annotation", False))
    idle = max(0.0, 1 - busy_us / 1e3 / wall_ms) if busy_us else None
    # the device's kernels a step, and the softmax kernels' grids among
    # them (two a call: a step's want[...] calls)
    on_card = [evt for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False)]
    kernels_per_step = sum(evt.count for evt in on_card) / len(more)
    softmax_grids = sum(evt.count for evt in on_card
                        if "seg_softmax::" in evt.key) / len(more)
    want_grids = 2 * (want["seg_softmax_fwd_f32"]
                      + want["seg_softmax_bwd_f32"])
    log(f"  profiled steps: {kernels_per_step} device kernels a step, "
        f"{softmax_grids} of them softmax grids (want {want_grids})")
    if busy_us and softmax_grids != want_grids:
        raise AssertionError(f"{softmax_grids} softmax grids a step, want "
                             f"{want_grids}")

    zero_counts(op)
    t0 = time.perf_counter()
    metrics = evaluate(run)
    eval_s = time.perf_counter() - t0
    eval_counts = read_counts(op)
    log(f"  evaluation launches: {eval_counts}")
    if eval_counts != EVAL_WANT[impl]:
        raise AssertionError(f"expected {EVAL_WANT[impl]} launches per "
                             f"evaluation, got {eval_counts}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    summary = {
        "step_ms_p50": statistics.median(step_ms),
        "first_step_ms": first_step_ms, "epoch_s": epoch_s,
        "device_idle_share": idle,
        "device_busy_ms_per_step": busy_us / 1e3 / len(more),
        "device_kernels_per_step": kernels_per_step,
        "eval_s": eval_s, **metrics,
    }
    log(f"  linkpred ({impl}): {json.dumps(summary)}")
    if impl == "fused":
        log(f"  after one epoch: Hits@20 {metrics.get('hits@20')}, Hits@50 "
            f"{metrics.get('hits@50')}, AUC {metrics.get('auc')}; the same "
            f"epoch {BEFORE_METRICS}")
    return step_counts, eval_counts, losses


def unfolded_loss(run, batch):
    """The training loss of ``batch`` from the run's parameters and
    generator state, with the materialised layer's attention dropout as
    the composition its softmax walk folds (the softmax kernel without
    dropout, then ``* keep_scale_plain`` in torch); forward only, the
    generator left as it was."""
    from msha_gnn_torch.ops import edge_softmax
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.training import linkpred_loss

    def composed(graph, logits, seed, rate):
        return edge_softmax(graph, logits, impl="cuda") * r1.keep_scale_plain(
            torch.arange(graph.num_padded_edges, device=logits.device), seed,
            rate)

    state = run.generator.get_state()
    folded = sm.edge_softmax_drop
    sm.edge_softmax_drop = composed
    try:
        with torch.no_grad():
            loss = linkpred_loss(run.model, run.graph, batch, impl=run.impl,
                                 generator=run.generator)
        return float(loss)
    finally:
        sm.edge_softmax_drop = folded
        run.generator.set_state(state)


def follow_fused_epoch(impl, losses, fused_losses):
    """Each step loss of ``impl``'s epoch against the fused epoch's: the
    same function from the same state."""
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, fused_losses)]
    epoch_err = max(errs)
    shown = sorted({*range(0, len(errs), 8), len(errs) - 1})
    log(f"  epoch: each of {len(losses)} step losses vs the fused epoch's, "
        f"max rel err {epoch_err:.2e} (rtol {EPOCH_LOSS_RTOL}); by step: "
        + ", ".join(f"{i} {errs[i]:.1e}" for i in shown))
    if len(losses) != len(fused_losses) or epoch_err > EPOCH_LOSS_RTOL:
        raise AssertionError(f"the {impl} epoch's losses differ from the "
                             "fused epoch's")


def rank1_logits_bound(op, n_src, n_dst, e_pad):
    """Least time of the rank-1 logits' forward and backward on this data,
    as the kernel path runs them: the SDDMM on the width-2 columns and the
    two d = 2 weighted SpMMs, each bound by :func:`sddmm_bound` /
    :func:`spmm_bound`, summed."""
    a = torch.empty((n_src, 2), device=DEVICE)
    b = torch.empty((n_dst, 2), device=DEVICE)
    parts = [sddmm_bound(op.ptr, op.col, a, b, e_pad),
             spmm_bound(op.ptr, op.col, b, n_src),
             spmm_bound(op.t_ptr, op.t_col, a, n_dst)]
    total = sum(p[0] for p in parts)
    return total, "bytes" if all(p[1] == "bytes" for p in parts) \
        else "operations"


def phase_rank1_logits(split):
    """Phase 3f: ``sddmm(impl="cuda")`` against the plain ``sddmm`` on the
    linkpred graph, its exact launches, the kernel at d = 2, and the three
    logit forms' device time; returns the kernels line's entry."""
    from msha_gnn_torch.ops import sddmm
    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm
    from msha_gnn_torch.ops.cuda.spmm import operator_for

    g = split["graph"].to(DEVICE)
    op = operator_for(g)
    n, e, e_pad = g.n_src, g.num_edges, g.num_padded_edges
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    s_src = torch.randn(n, generator=gen, device=DEVICE)
    s_dst = torch.randn(g.n_dst, generator=gen, device=DEVICE)
    ct = torch.randn(e_pad, generator=gen, device=DEVICE)
    log(f"  graph: {n} rows, {e} edges ({e_pad} padded); logits "
        "leaky_relu(s_src[snd] + s_dst[rcv]), slope 0.2")

    # the counted run: one forward and backward through the kernel path
    ins = [v.clone().requires_grad_() for v in (s_src, s_dst)]
    zero_counts(op)
    got = sddmm(g, *ins, impl="cuda")
    got_grads = torch.autograd.grad(got, ins, ct)
    torch.cuda.synchronize()
    counts = read_counts(op)
    log(f"  sddmm(impl='cuda'), one forward and backward: {counts}")
    want_counts = expected(csr_sddmm_f32=1, csr_spmm_f32=2,
                           csr_spmm_f32_transposed=1)
    if counts != want_counts:
        raise AssertionError(f"expected {want_counts} launches, got "
                             f"{counts}")
    ref = [v.clone().requires_grad_() for v in (s_src, s_dst)]
    want = sddmm(g, *ref)
    want_grads = torch.autograd.grad(want, ref, ct)
    torch.cuda.synchronize()
    err = close("rank-1 logits, kernel path vs plain", got.detach()[:e],
                want.detach()[:e], KERNEL_RTOL, KERNEL_ATOL)
    if got.detach()[e:].any():
        raise AssertionError("the kernel path's logits are not 0 on the "
                             "pad slots")
    for name, gk, gp in zip(("ds_src", "ds_dst"), got_grads, want_grads):
        close(f"rank-1 logits, kernel path vs plain: {name}", gk, gp,
              SUM_RTOL, SUM_ATOL_REL * float(gp.abs().max()))

    # the kernel alone at d = 2, as the path launches it
    a2 = torch.stack([s_src, torch.ones_like(s_src)], dim=1)
    b2 = torch.stack([torch.ones_like(s_dst), s_dst], dim=1)
    sd_args = (op.ptr, op.col, a2, b2, e_pad)
    kernel = (lambda: cuda_sddmm.csr_sddmm(*sd_args))
    close("csr_sddmm_f32[rank1 logits] vs plain", kernel(),
          cuda_sddmm.csr_sddmm_plain(*sd_args), KERNEL_RTOL, KERNEL_ATOL)
    same_bits("csr_sddmm_f32[rank1 logits]", kernel)
    ms, dev_ms = time_ms(kernel), device_ms(kernel)
    plain_ms = time_ms(lambda: cuda_sddmm.csr_sddmm_plain(*sd_args))
    library_ms = None
    try:
        pattern = torch.sparse_csr_tensor(
            op.ptr, op.col, torch.zeros(e, device=DEVICE),
            size=(n, g.n_dst))
        b2t = b2.t()
        lib_out = torch.sparse.sampled_addmm(pattern, a2, b2t, beta=0.0)
        if not torch.allclose(lib_out.values(), kernel()[:e], rtol=1e-5,
                              atol=1e-5):
            raise AssertionError("sampled_addmm disagrees with the kernel")
        library_ms = time_ms(
            lambda: torch.sparse.sampled_addmm(pattern, a2, b2t, beta=0.0))
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  torch.sparse.sampled_addmm does not run: {exc}")
    bnd = sddmm_bound(op.ptr, op.col, a2, b2, e_pad)
    log(f"  csr_sddmm_f32[rank1 logits] (d 2): kernel {ms:.4f} ms (device "
        f"{fmt(dev_ms)}), plain {plain_ms:.4f} ms, "
        f"torch.sparse.sampled_addmm {library_ms} ms, bound {bnd[0]:.5f} "
        f"ms ({bnd[1]})")

    # the backward's two d = 2 SpMMs, weighted by the edge gradient, as the
    # operator launches them (their numbers logged, not in the kernels line)
    for label, (ptr, col, w, x, rows) in (
            ("rank1 logits ds_src A(g) [s_dst 1]",
             (op.ptr, op.col, op.weights(ct, False), b2, n)),
            ("rank1 logits ds_dst A(g)^T [s_src 1]",
             (op.t_ptr, op.t_col, op.weights(ct, True), a2, g.n_dst))):
        a_csr = torch.sparse_csr_tensor(ptr, col, w, size=(rows, x.shape[0]))
        spmm_use(label, (ptr, col, w, x, rows),
                 lambda a_csr=a_csr, x=x: torch.sparse.mm(a_csr, x),
                 "torch.sparse.mm")

    # the three logit forms, forward and backward, by device time
    snd = g.senders[:e].long()
    rcv = g.receivers[:e].long()

    def index_select_form(u, v):
        out = u.index_select(0, snd) + v.index_select(0, rcv)
        return torch.nn.functional.leaky_relu(
            torch.cat([out, out.new_zeros(e_pad - e)]), 0.2)

    forms = {"plain _gather_rows": lambda u, v: sddmm(g, u, v),
             "sddmm(impl='cuda')": lambda u, v: sddmm(g, u, v, impl="cuda"),
             "index_select": index_select_form}
    close("index_select form vs plain", index_select_form(s_src, s_dst)[:e],
          want.detach()[:e], KERNEL_RTOL, KERNEL_ATOL)
    fb_bound = rank1_logits_bound(op, n, g.n_dst, e_pad)
    form_ms = {}
    for label, form in forms.items():
        leaves = [v.clone().requires_grad_() for v in (s_src, s_dst)]

        def fwd_bwd(form=form, leaves=leaves):
            return torch.autograd.grad(form(*leaves), leaves, ct)

        form_ms[label] = {"ms": time_ms(fwd_bwd, reps=7),
                          "device_ms": device_ms(fwd_bwd)}
        log(f"  rank-1 logits forward + backward, {label}: "
            f"{form_ms[label]['ms']:.4f} ms (device "
            f"{fmt(form_ms[label]['device_ms'])}), bound {fb_bound[0]:.5f} "
            f"ms ({fb_bound[1]})")
    log(f"  rank-1 logit forms: {json.dumps(form_ms)}")
    out = entry("csr_sddmm_f32[rank1 logits]", "sddmm.cu",
                "msha_gnn_tpu/ops/pallas/spmm.py:1428 _sddmm_kernel "
                "(through sddmm.py:88 sddmm_pallas)", err, ms, plain_ms, bnd,
                library_ms)
    out["launches"] = counts["csr_sddmm_f32"]
    return out


def phase_msha(fg):
    """Phase 9: the MSHA serving path at full width on the card."""
    import dataclasses

    from msha_gnn_torch.cli import _build_task
    from msha_gnn_torch.models.common import BatchNorm
    from msha_gnn_torch.server import ModelService, make_server
    from msha_gnn_torch.serving import Predictor
    from msha_gnn_torch.training import restore_checkpoint, save_checkpoint
    from msha_gnn_torch.utils import TrainConfig

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmuls are not at full precision")
    log("  float32 matmuls at full precision: allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, precision "
        f"{torch.get_float32_matmul_precision()}")
    cfg = TrainConfig()  # model "msha", the CLI's defaults
    rng = np.random.default_rng(3)

    def build(model, device=DEVICE):
        c = dataclasses.replace(cfg, model=model)
        t0 = time.perf_counter()
        task, net = _build_task(c, fg, device)
        return task, net, (time.perf_counter() - t0) * 1e3

    def calibrate(task, net):
        """Running statistics as a trained checkpoint carries them: each
        norm's batch mean and variance of one train-mode forward (dropout
        on), in place of the initial 0 and 1, under which the random
        model's unnormalised sums over N rows put its logits in the
        thousands and its log-scores off any float32 tolerance."""
        norms = [m for m in net.modules() if isinstance(m, BatchNorm)]
        for bn in norms:
            bn.momentum = 0.0
        with torch.no_grad():
            task.forward(net, torch.arange(PREDICT_BATCH), train=True,
                         generator=torch.Generator(DEVICE).manual_seed(4))
        for bn in norms:
            bn.momentum = 0.9

    def on_cpu(model, net):
        task_c, net_c, _ = build(model, "cpu")
        net_c.load_state_dict({k: v.cpu() for k, v in
                               net.state_dict().items()})
        return Predictor.from_state(task_c, net_c, PREDICT_BATCH)

    def check_rows(name, scores, rows):
        if scores.shape != (rows, fg.n_dst) or not np.isfinite(scores).all():
            raise AssertionError(f"{name}: shape {scores.shape} or "
                                 "non-finite values")
        err = float(np.abs(np.exp(scores).sum(axis=1) - 1).max())
        if err > 1e-4:
            raise AssertionError(f"{name}: rows are not distributions "
                                 f"({err:.2e})")

    def against_cpu(name, got, want):
        err = float(np.abs(got - want).max())
        log(f"  {name}: card vs CPU, same weights: max abs err {err:.3e} "
            f"(rtol {MSHA_RTOL}, atol {MSHA_ATOL})")
        np.testing.assert_allclose(got, want, rtol=MSHA_RTOL, atol=MSHA_ATOL,
                                   err_msg=name)

    def one_http(service, nodes, k=5):
        httpd = make_server(service, port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/predict"
        ms = []
        try:
            for chunk in nodes:
                t0 = time.perf_counter()
                body = post(url, {"nodes": chunk, "k": k})
                ms.append((time.perf_counter() - t0) * 1e3)
                for res, node in zip(body["results"], chunk):
                    ps = [e["p"] for e in res["top"]]
                    if res["node"] != node or len(ps) != k or \
                            ps != sorted(ps, reverse=True):
                        raise AssertionError(f"bad top-k {res}")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("the server thread did not stop")
        return ms

    def requests(count):
        return [rng.integers(0, fg.n_src, 64).tolist() for _ in range(count)]

    summary = {}
    task, model, build_ms = build("msha")
    calibrate(task, model)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  msha_task ({cfg.in_features} in, {cfg.out_features} a head, "
        f"{cfg.n_heads} heads, {n_params} parameters): {build_ms:.1f} ms")
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, model, step=1)
        with torch.no_grad():
            for v in model.state_dict().values():
                v.zero_()
        model, _, step = restore_checkpoint(td, model)
    for k, v in model.state_dict().items():
        if not torch.equal(v, saved[k]):
            raise AssertionError(f"checkpoint round trip changed {k}")
    log(f"  checkpoint round trip (step {step}, {len(saved)} tensors, "
        "running statistics included): bit-exact")

    predictor = Predictor.from_state(task, model, PREDICT_BATCH)
    nodes = rng.integers(0, fg.n_src, 2 * PREDICT_BATCH + 300)
    # the main path: counts set to 0 just before, read just after
    zero_counts()
    t0 = time.perf_counter()
    got = predictor.log_scores(nodes)
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"the MSHA path launched a kernel: {counts}")
    log(f"  msha, {len(nodes)} nodes in 3 padded batches of "
        f"{PREDICT_BATCH}: {first_ms:.1f} ms (first call); none of the "
        "port's kernels launched")
    check_rows("msha per-batch scores", got, len(nodes))
    against_cpu("msha per-batch scores", got,
                on_cpu("msha", model).log_scores(nodes))

    few = rng.integers(0, fg.n_src, 64)
    one = predictor.log_scores(few)
    padded = np.concatenate([few, np.zeros(PREDICT_BATCH - 64, np.int64)])
    with torch.inference_mode():
        full_batch, _ = task.forward(model, torch.from_numpy(padded),
                                     train=False)
    rows = full_batch[:64].cpu().numpy()
    err = float(np.abs(one - rows).max())
    log(f"  a 64-node request vs the first 64 rows of one padded forward: "
        f"max abs err {err:.3e} (rtol {MSHA_REPEAT_RTOL}, atol "
        f"{MSHA_REPEAT_ATOL}; bit-equal: {np.array_equal(one, rows)})")
    np.testing.assert_allclose(one, rows, rtol=MSHA_REPEAT_RTOL,
                               atol=MSHA_REPEAT_ATOL)

    fwd_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        with torch.inference_mode():
            task.forward(model, torch.from_numpy(padded), train=False)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    predictor.log_scores(np.arange(fg.n_src))
    all_ms = (time.perf_counter() - t0) * 1e3
    service = ModelService(predictor, n_src=fg.n_src,
                           metadata={"model": "msha", "n_dst": fg.n_dst})
    req_ms = one_http(service, requests(21))
    summary["msha"] = {
        "batch_forward_ms_p50": statistics.median(fwd_ms),
        "predict_all_ms": all_ms,
        "request_64_http_ms_p50": statistics.median(req_ms[1:]),
        "requests": len(req_ms) - 1}
    log(f"  msha: one /v1/predict per request over HTTP, {summary['msha']}")

    task3, model3, _ = build("ablation3")
    calibrate(task3, model3)
    predictor3 = Predictor.from_state(task3, model3, PREDICT_BATCH)
    zero_counts()
    t0 = time.perf_counter()
    full = predictor3._full_scores()
    torch.cuda.synchronize()
    fill_ms = (time.perf_counter() - t0) * 1e3
    if any(read_counts().values()):
        raise AssertionError("the ablation3 fill launched a kernel")
    full_np = full.cpu().numpy()
    check_rows("ablation3 fill", full_np, fg.n_src)
    cpu3 = on_cpu("ablation3", model3)
    against_cpu("ablation3 fill", full_np, cpu3._full_scores().numpy())
    with torch.inference_mode():
        batch_rows, _ = task3.forward(model3, torch.from_numpy(padded),
                                      train=False)
    close("ablation3 per-batch rows vs its fill",
          batch_rows[:64], full[torch.from_numpy(few).to(DEVICE)],
          MSHA_REPEAT_RTOL, MSHA_REPEAT_ATOL)
    refill = []
    for _ in range(10):
        t0 = time.perf_counter()
        task3.full_scores(model3)
        torch.cuda.synchronize()
        refill.append((time.perf_counter() - t0) * 1e3)
    service3 = ModelService(predictor3, n_src=fg.n_src,
                            metadata={"model": "ablation3",
                                      "n_dst": fg.n_dst})
    req3 = one_http(service3, requests(21))
    summary["ablation3"] = {
        "first_fill_ms": fill_ms, "fill_ms_p50": statistics.median(refill),
        "request_64_http_ms_p50": statistics.median(req3[1:])}
    log(f"  ablation3: {summary['ablation3']}")

    for preset in ("ours", "ablation1", "ablation2"):
        task_p, model_p, _ = build(preset)
        calibrate(task_p, model_p)
        pred = Predictor.from_state(task_p, model_p, PREDICT_BATCH)
        zero_counts()
        got_p = pred.log_scores(few)
        if any(read_counts().values()):
            raise AssertionError(f"the {preset} path launched a kernel")
        check_rows(f"{preset} scores", got_p, 64)
        against_cpu(f"{preset}, a 64-node request", got_p,
                    on_cpu(preset, model_p).log_scores(few))
    log(f"  msha serving: {json.dumps(summary)}")
    return summary


def write_flow_dir(fg, path, year="2015"):
    """The loader's three files (``Adjacent``, ``GDP``, ``Flow``) for the
    flow graph ``fg``; recipients are named ``P<j>``."""
    os.makedirs(path, exist_ok=True)
    city = fg.city.group_id.numpy()
    prov = fg.province.group_id.numpy()
    adj = {"source_index": {str(i): [int(c), int(p)]
                            for i, (c, p) in enumerate(zip(city, prov))},
           "recipient_index": {f"P{j}": j for j in range(fg.n_dst)}}
    with open(os.path.join(path, f"Adjacent{year}.json"), "wb") as f:
        f.write(json.dumps(adj).encode("gbk"))
    gdp = {"GDP_embedding": {str(i): float(v)
                             for i, v in enumerate(fg.gdp.numpy())}}
    with open(os.path.join(path, f"GDP{year}.json"), "wb") as f:
        f.write(json.dumps(gdp).encode("gbk"))
    src, dst = fg.edge_src.numpy(), fg.edge_dst.numpy()
    np.savetxt(os.path.join(path, f"Flow{year}.csv"),
               np.stack([src, dst, city[src], prov[src]], axis=1),
               fmt="%d", delimiter=",",
               header="source,recipient,city,province", comments="")
    return path


def all_spmm_ops():
    """Every cached SpmmOperator (the CLI builds its graph's own)."""
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    return [op for _, op in cuda_spmm._OPS.values()
            if isinstance(op, cuda_spmm.SpmmOperator)]


def stacked_batches(trainer, ids, seed):
    """An epoch's batches of ``ids`` as the trainer makes them, on the
    card: ``[(src [B], labels [B], weights [B]), ...]``."""
    from msha_gnn_torch.training.trainer import _stacked_batches

    idx, w = _stacked_batches(len(ids), trainer.batch_size, shuffle=True,
                              rng=np.random.default_rng(seed))
    rec = ids[idx]
    src = torch.from_numpy(trainer.src[rec].astype(np.int64)).to(DEVICE)
    lab = torch.from_numpy(trainer.labels[rec].astype(np.int64)).to(DEVICE)
    return list(zip(src, lab, torch.from_numpy(w).to(DEVICE)))


def profile_steps(name, step, state, batches, generator):
    """Step wall p50 (20 timed steps, each between two synchronises, after
    6 of warm-up), then ``torch.profiler`` over 20 steps: device kernels a
    step, device ms a step and the idle share of their wall."""
    from torch.profiler import ProfilerActivity, profile

    if len(batches) < 46:
        raise AssertionError(f"{name}: {len(batches)} batches, want 46")
    for b in batches[:6]:
        step(state, *b, generator)
    times = []
    for b in batches[6:26]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *b, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[26:46]:
            step(state, *b, generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [evt for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False)]
    busy_us = sum(getattr(evt, "self_device_time_total", 0.0)
                  or getattr(evt, "self_cuda_time_total", 0.0)
                  for evt in on_card)
    out = {"step_wall_ms_p50": statistics.median(times) * 1e3,
           "device_kernels_per_step": sum(e.count for e in on_card) / 20,
           "device_ms_per_step": busy_us / 1e3 / 20 if busy_us else None,
           "device_idle_share": (max(0.0, 1 - busy_us / 1e3 / wall_ms)
                                 if busy_us else None),
           "profiled_wall_ms_per_step": wall_ms / 20}
    def us(evt):
        return (getattr(evt, "self_device_time_total", 0.0)
                or getattr(evt, "self_cuda_time_total", 0.0))

    groups = {}
    for evt in on_card:
        key = evt.key.lower()
        kind = next((k for k, words in STEP_GROUPS if any(
            w in key for w in words)), "other")
        n, t = groups.get(kind, (0, 0.0))
        groups[kind] = (n + evt.count / 20, t + us(evt) / 20)
    for kind, (n, t) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        log(f"    {name} device: {kind}: {t:.2f} us, {n} kernels a step")
    for evt in sorted(on_card, key=lambda e: -us(e))[:6]:
        short = evt.key.replace("void ", "").replace(
            "at::native::", "").replace("(anonymous namespace)::", "")
        log(f"    {name} device: {us(evt) / 20:.2f} us, {evt.count / 20} a "
            f"step: {short[:150]}")
    out["device_us_by_kind"] = {k: t for k, (_, t) in groups.items()}
    log(f"  {name} step: {json.dumps(out)}")
    return out


def card_against_cpu(name, fg, batches, stats_atol_rel=0.0):
    """Phase 10c: ``name`` at dropout 0 on the card and on the CPU from the
    same weights, the same batches in lockstep.  Each step's loss at
    ``TRAIN_LOSS_*``; each step's gradients within ``TRAIN_GRAD_REL`` of
    the model's largest gradient; the running statistics at
    ``TRAIN_STATS_RTOL``; each parameter at ``TRAIN_PARAM_ATOL`` plus what
    Adam makes of the gradients' measured difference.  Adam steps by
    ``lr m / sqrt(v)``: a gradient difference ``delta`` moves a step by at
    most about ``2 lr delta / sqrt(v)``, never more than ``2 lr``, so a
    coordinate whose gradient is near float32 noise (MSHA's output
    attention ``a``, whose row-constant part the row softmax cancels)
    moves apart by up to ``lr`` a step while a well-conditioned one stays
    within ``TRAIN_PARAM_ATOL``.  ``stats_atol_rel``: an absolute bound on
    each running statistic of that share of its largest value, beside
    the relative one.  Returns the two train states and tasks,
    ``(state_k, task_k, state_c, task_c)``."""
    import dataclasses

    from msha_gnn_torch.cli import _build_task
    from msha_gnn_torch.training import TrainState, make_train_step
    from msha_gnn_torch.utils import TrainConfig

    cfg = dataclasses.replace(TrainConfig(), model=name, in_features=NFEAT,
                              dropout=0.0)
    (task_k, model_k), (task_c, model_c) = (_build_task(cfg, fg, DEVICE),
                                            _build_task(cfg, fg, "cpu"))
    model_c.load_state_dict({k: v.cpu() for k, v in
                             model_k.state_dict().items()})
    state_k = TrainState.create(model_k, task_k.optimizer)
    state_c = TrainState.create(model_c, task_c.optimizer)
    step_k, step_c = make_train_step(task_k), make_train_step(task_c)
    beta2 = state_c.optimizer.defaults["betas"][1]
    eps = state_c.optimizer.defaults["eps"]
    allow = {n: torch.full_like(p, TRAIN_PARAM_ATOL)
             for n, p in model_c.named_parameters()}
    card, cpu, grad_err = [], [], 0.0
    for t, b in enumerate(batches, 1):
        card.append(float(step_k(state_k, *b)))
        cpu.append(float(step_c(state_c, *(x.cpu() for x in b))))
        pairs = [(n, pk.grad.cpu(), pc) for (n, pk), pc in
                 zip(model_k.named_parameters(), model_c.parameters())]
        scale = max(float(pc.grad.abs().max()) for _, _, pc in pairs)
        for n, gk, pc in pairs:
            delta = float((gk - pc.grad).abs().max())
            grad_err = max(grad_err, delta / scale)
            v_hat = state_c.optimizer.state[pc]["exp_avg_sq"] / (1 - beta2 ** t)
            allow[n] += cfg.lr * torch.clamp(
                2 * delta / (v_hat.sqrt() + eps), max=2.0)
    sd_k = {k: v.cpu() for k, v in model_k.state_dict().items()}
    sd_c = model_c.state_dict()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    worst, widened = {}, 0
    for n, p in model_c.named_parameters():
        err = (sd_k[n] - p.detach()).abs()
        worst[n] = (float(err.max()), float((err / allow[n]).max()))
        widened += int((allow[n] > 2 * TRAIN_PARAM_ATOL).sum())
    stats = [k for k in sd_c if k not in allow]
    stats_err = max((float(((sd_k[k] - sd_c[k]).abs()
                            / sd_c[k].abs().clamp_min(1e-6)).max())
                     for k in stats), default=0.0)
    log(f"  {name}, {len(batches)} steps: losses card {card[0]:.7f} .. "
        f"{card[-1]:.7f}, max rel err vs CPU {loss_err:.3e} (rtol "
        f"{TRAIN_LOSS_RTOL}, atol {TRAIN_LOSS_ATOL}); gradients max abs err "
        f"{grad_err:.3e} of the largest (bound {TRAIN_GRAD_REL}); "
        f"{len(stats)} running statistics max rel err {stats_err:.3e} (rtol "
        f"{TRAIN_STATS_RTOL})")
    for n, (err, used) in worst.items():
        log(f"    {name} {n}: max abs err {err:.3e}, {used:.3f} of its bound")
    log(f"    {name}: {widened} coordinates with a bound above "
        f"{2 * TRAIN_PARAM_ATOL} (near-noise gradients)")
    np.testing.assert_allclose(card, cpu, rtol=TRAIN_LOSS_RTOL,
                               atol=TRAIN_LOSS_ATOL, err_msg=name)
    if grad_err > TRAIN_GRAD_REL:
        raise AssertionError(f"{name}: gradients card vs CPU")
    bad = [n for n, (_, used) in worst.items() if used > 1.0]
    if bad:
        raise AssertionError(f"{name}: parameters card vs CPU: {bad}")
    for k in stats:
        atol = max(1e-6, stats_atol_rel * float(sd_c[k].abs().max()))
        torch.testing.assert_close(sd_k[k], sd_c[k], rtol=TRAIN_STATS_RTOL,
                                   atol=atol,
                                   msg=lambda m, k=k: f"{name} {k}: {m}")
    return state_k, task_k, state_c, task_c


def phase_train(fg):
    """Phase 10: flow-model training at full width on the card.  Returns
    the csr_spmm_f32 launches of its GCN runs: ``{"fwd_plain",
    "fwd_transposed", "bwd_plain", "bwd_transposed"}``."""
    import contextlib
    import dataclasses
    import io

    from msha_gnn_torch import cli
    from msha_gnn_torch.cli import _build_task
    from msha_gnn_torch.data import train_test_split_records
    from msha_gnn_torch.ops.cuda.spmm import operator_for
    from msha_gnn_torch.training import (Trainer, TrainState,
                                         make_train_step)
    from msha_gnn_torch.utils import TrainConfig

    n_train = int(TrainConfig().train_fraction * fg.num_records)
    steps = -(-n_train // TrainConfig().batch_size)
    src, labels = fg.edge_src.numpy(), fg.edge_dst.numpy()
    train_ids, test_ids = train_test_split_records(
        fg.num_records, TrainConfig().train_fraction, TrainConfig().seed)

    log(f"phase 10a: cli train / eval / predict --model gcn, in_features "
        f"{NFEAT}, 1 epoch of {steps} steps of {TrainConfig().batch_size}")
    gcn = {}
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        data = write_flow_dir(fg, os.path.join(td, "data"))
        log(f"  wrote the graph in the loader's format: "
            f"{time.perf_counter() - t0:.2f} s")
        ckpt, train_log = os.path.join(td, "ckpt"), os.path.join(td, "log")
        common = ["--model", "gcn", "--in_features", str(NFEAT),
                  "--data_dir", data, "--checkpoint_dir", ckpt]
        runs = (("train", ["--epochs", "1", "--log_path", train_log]),
                ("eval", []), ("predict", ["--nodes", "0,1,2"]))
        for cmd, extra in runs:
            ops = all_spmm_ops()
            for op in ops:
                zero_counts(op)
            zero_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main([cmd, *common, *extra])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            transposed = sum(op.launches_transposed for op in
                             {id(o): o for o in ops + all_spmm_ops()}
                             .values())
            lines = out.getvalue().strip().splitlines()
            log(f"  cli {cmd}: exit {rc}, {secs:.2f} s, csr_spmm_f32 "
                f"{counts['csr_spmm_f32']} ({transposed} transposed); "
                f"last line {lines[-1] if lines else None}")
            if rc != 0:
                raise AssertionError(f"cli {cmd} exited {rc}")
            # a step: 2 plain + 2 transposed; each command evaluates or
            # fills once: 1 + 1
            want_total = (4 * steps if cmd == "train" else 0) + 2
            want_t = (2 * steps if cmd == "train" else 0) + 1
            want = {k: v for k, v in
                    expected(csr_spmm_f32=want_total).items() if k in counts}
            if counts != want or transposed != want_t:
                raise AssertionError(
                    f"cli {cmd}: {counts}, {transposed} transposed; want "
                    f"csr_spmm_f32 {want_total}, {want_t} transposed")
            gcn[cmd] = {"seconds": secs, "launches": want_total,
                        "transposed": transposed, "last": lines[-1]}
        with open(train_log) as f:
            events = [json.loads(line) for line in f]
        epoch = next(e for e in events if e["event"] == "train_epoch")
        report = json.loads(gcn["train"]["last"])
        evaluated = json.loads(gcn["eval"]["last"])
        if evaluated["checkpoint_step"] != steps or not all(
                np.isfinite(v) for v in report.values()):
            raise AssertionError(f"train {report}, eval {evaluated}")
        for k in ("auc", "accuracy", "loss"):
            if not np.isclose(evaluated[k], report[k], rtol=1e-5):
                raise AssertionError(f"eval of the checkpoint: {k} "
                                     f"{evaluated[k]} vs {report[k]}")
        if json.loads(gcn["predict"]["last"])["nodes"] != 3:
            raise AssertionError(f"predict: {gcn['predict']['last']}")
        log(f"  gcn epoch: {epoch['seconds']:.2f} s for {steps} steps "
            f"(train_epoch event); report {json.dumps(report)}")

    # one step's launches split into forward and backward, then the step's
    # wall, kernels and device time, through the trainer cmd_train builds
    cfg = dataclasses.replace(TrainConfig(), model="gcn", in_features=NFEAT)
    task, model = _build_task(cfg, fg, DEVICE)
    op = operator_for(task.graph)
    state = TrainState.create(model, task.optimizer)
    trainer = Trainer(task=task, src=src, labels=labels, seed=cfg.seed)
    batches = stacked_batches(trainer, train_ids, cfg.seed)
    gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
    zero_counts(op)
    scores, _ = task.forward(model, batches[0][0], train=True, generator=gen)
    fwd = read_counts(op)
    task.loss_fn(scores, batches[0][1], batches[0][2]).backward()
    torch.cuda.synchronize()
    both = read_counts(op)
    model.zero_grad(set_to_none=True)
    split = {"fwd_plain": fwd["csr_spmm_f32"] - fwd["csr_spmm_f32 transposed"],
             "fwd_transposed": fwd["csr_spmm_f32 transposed"],
             "bwd_plain": (both["csr_spmm_f32"] - fwd["csr_spmm_f32"]
                           - both["csr_spmm_f32 transposed"]
                           + fwd["csr_spmm_f32 transposed"]),
             "bwd_transposed": (both["csr_spmm_f32 transposed"]
                                - fwd["csr_spmm_f32 transposed"])}
    log(f"  one gcn step's csr_spmm_f32 launches: {split}")
    if split != dict.fromkeys(split, 1) or \
            both != expected(csr_spmm_f32=4, csr_spmm_f32_transposed=2):
        raise AssertionError(f"a gcn step launched {both}, split {split}")
    step = make_train_step(task)
    zero_counts(op)
    step(state, *batches[0], gen)
    torch.cuda.synchronize()
    if read_counts(op) != both:
        raise AssertionError(f"the trainer's step launched {read_counts(op)}")
    summary = {"gcn": profile_steps("gcn", step, state, batches[1:], gen)}
    summary["gcn"]["epoch_s"] = epoch["seconds"]
    launches = {k: v * steps for k, v in split.items()}
    for k in ("fwd_plain", "fwd_transposed"):  # the evaluations and fill
        launches[k] += 3

    log(f"phase 10b: msha at TrainConfig() defaults, {MSHA_STEPS} steps "
        f"(one dispatch chunk) on the first {MSHA_TRAIN_IDS} train ids, "
        f"evaluation on the first {MSHA_TEST_IDS} test ids; capped: a full "
        f"epoch is {steps} steps")
    cfg = TrainConfig()
    task, model = _build_task(cfg, fg, DEVICE)
    state = TrainState.create(model, task.optimizer)
    trainer = Trainer(task=task, src=src, labels=labels, seed=cfg.seed)
    gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
    zero_counts()
    t0 = time.perf_counter()
    state, loss = trainer.train_epoch(state, train_ids[:MSHA_TRAIN_IDS], gen,
                                      0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = trainer.evaluate(state, test_ids[:MSHA_TEST_IDS])
    eval_s = time.perf_counter() - t0
    if any(read_counts().values()):
        raise AssertionError(f"the msha path launched a kernel: "
                             f"{read_counts()}")
    if state.step != MSHA_STEPS or not np.isfinite(loss) or not all(
            np.isfinite(report[k]) for k in ("auc", "accuracy", "loss")):
        raise AssertionError(f"msha: {state.step} steps, loss {loss}, "
                             f"report {report}")
    log(f"  msha: {MSHA_STEPS} steps {train_s:.2f} s, loss {loss:.5f}; "
        f"evaluation ({MSHA_TEST_IDS // cfg.batch_size} padded batches) "
        f"{eval_s:.2f} s: {json.dumps(report)}; none of the port's kernels "
        "launched")
    summary["msha"] = profile_steps(
        "msha", make_train_step(task), state,
        stacked_batches(trainer, train_ids[:64 * 47], cfg.seed), gen)

    log("phase 10c: card against CPU, the same initial weights and batches "
        "at dropout 0; then two runs at dropout 0.5 from one seed")
    for name in ("gcn", "ablation3"):
        card_against_cpu(name, fg, batches[:CARD_CPU_STEPS])
    for name in ("gcn", "msha"):
        cfg = dataclasses.replace(TrainConfig(), model=name,
                                  in_features=NFEAT)
        runs = []
        for _ in range(2):
            task, model = _build_task(cfg, fg, DEVICE)
            state = TrainState.create(model, task.optimizer)
            step = make_train_step(task)
            gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
            runs.append([float(step(state, *b, gen))
                         for b in batches[:CARD_CPU_STEPS]])
        err = max(abs(a - b) / abs(b) for a, b in zip(*runs))
        log(f"  {name} at dropout {cfg.dropout}, two runs from seed "
            f"{cfg.seed}: {CARD_CPU_STEPS} step losses "
            f"{'bit-equal' if runs[0] == runs[1] else 'differ'}, max rel "
            f"diff {err:.3e}")
        if name == "gcn" and runs[0] != runs[1]:
            raise AssertionError("gcn: two runs from one seed differ")
        if err > TRAIN_LOSS_RTOL:
            raise AssertionError(f"{name}: two runs from one seed differ by "
                                 f"{err:.3e}")
    log(f"  flow training: {json.dumps(summary)}")
    return launches

def phase_flow_presets(fg):
    """Phase 11: the other flow presets (``gat``, ``sage``, ``hgane``) at
    ``TrainConfig()``'s widths on the card, each capped as phase 10b caps
    MSHA: 64 steps and an evaluation of 1,024 test records through the
    trainer ``cli train`` builds, a checkpoint of them read back by ``cli
    eval`` and ``cli predict``, its step's kernels, device time and idle
    share, and the same 64 steps at dropout 0 against the CPU from one
    state (``card_against_cpu``), then both evaluations of the 1,024
    records.  None of the three reaches a kernel of the port (checked)."""
    import contextlib
    import dataclasses
    import io

    from msha_gnn_torch import cli
    from msha_gnn_torch.cli import _build_task
    from msha_gnn_torch.data import train_test_split_records
    from msha_gnn_torch.training import (Trainer, TrainState,
                                         make_train_step, save_checkpoint)
    from msha_gnn_torch.utils import TrainConfig

    base = TrainConfig()
    src, labels = fg.edge_src.numpy(), fg.edge_dst.numpy()
    train_ids, test_ids = train_test_split_records(
        fg.num_records, base.train_fraction, base.seed)
    summary = {}
    with tempfile.TemporaryDirectory() as td:
        data = write_flow_dir(fg, os.path.join(td, "data"))
        for name in FLOW_PRESETS:
            cfg = dataclasses.replace(base, model=name)
            ckpt = os.path.join(td, f"ckpt_{name}")
            task, model = _build_task(cfg, fg, DEVICE)
            state = TrainState.create(model, task.optimizer)
            trainer = Trainer(task=task, src=src, labels=labels,
                              seed=cfg.seed)
            gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
            zero_counts()
            t0 = time.perf_counter()
            state, loss = trainer.train_epoch(
                state, train_ids[:MSHA_TRAIN_IDS], gen, 0)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            report = trainer.evaluate(state, test_ids[:MSHA_TEST_IDS])
            if any(read_counts().values()):
                raise AssertionError(f"{name} launched a kernel: "
                                     f"{read_counts()}")
            if state.step != MSHA_STEPS or not np.isfinite(loss) or not all(
                    np.isfinite(report[k]) for k in ("auc", "accuracy",
                                                     "loss")):
                raise AssertionError(f"{name}: {state.step} steps, loss "
                                     f"{loss}, report {report}")
            save_checkpoint(ckpt, state, step=state.step)
            params = sum(p.numel() for p in model.parameters())
            log(f"  {name} ({params} parameters, dropout {cfg.dropout}): "
                f"{MSHA_STEPS} steps {train_s:.2f} s, loss {loss:.5f}; "
                f"evaluation of {MSHA_TEST_IDS} records: "
                f"{json.dumps(report)}; none of the port's kernels launched")
            common = ["--model", name, "--data_dir", data,
                      "--checkpoint_dir", ckpt]
            for cmd, extra in (("eval", []),
                               ("predict", ["--nodes", "0,1,2"])):
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = cli.main([cmd, *common, *extra])
                secs = time.perf_counter() - t0
                last = out.getvalue().strip().splitlines()[-1]
                log(f"  cli {cmd} --model {name}: exit {rc}, {secs:.2f} s; "
                    f"last line {last}")
                result = json.loads(last)
                if rc != 0 or result["checkpoint_step"] != MSHA_STEPS:
                    raise AssertionError(f"cli {cmd} --model {name}: exit "
                                         f"{rc}, {last}")
                if cmd == "eval" and not all(np.isfinite(
                        result[k]) for k in ("auc", "accuracy", "loss")):
                    raise AssertionError(f"cli eval --model {name}: {last}")
                if cmd == "predict" and result["nodes"] != 3:
                    raise AssertionError(f"cli predict --model {name}: "
                                         f"{last}")
            summary[name] = profile_steps(
                name, make_train_step(task), state,
                stacked_batches(trainer, train_ids[:64 * 47], cfg.seed), gen)
            summary[name]["train_64_steps_s"] = train_s

            batches = stacked_batches(trainer, train_ids[:MSHA_TRAIN_IDS],
                                      cfg.seed)
            state_k, task_k, state_c, task_c = card_against_cpu(
                name, fg, batches, stats_atol_rel=FLOW_STATS_ATOL_REL)
            reports = [Trainer(task=t_, src=src, labels=labels,
                               seed=cfg.seed).evaluate(
                s_, test_ids[:MSHA_TEST_IDS])
                for t_, s_ in ((task_k, state_k), (task_c, state_c))]
            errs = {k: abs(reports[0][k] - reports[1][k])
                    for k in reports[1]}
            log(f"  {name}: the evaluation of {MSHA_TEST_IDS} records after "
                f"the {len(batches)} steps at dropout 0, card vs CPU: loss "
                f"{reports[0]['loss']:.7f} / {reports[1]['loss']:.7f}; max "
                f"abs difference of the other metrics "
                f"{max(v for k, v in errs.items() if k != 'loss'):.3e} "
                f"(bound {REPORT_ATOL})")
            np.testing.assert_allclose(reports[0]["loss"], reports[1]["loss"],
                                       rtol=TRAIN_LOSS_RTOL,
                                       atol=TRAIN_LOSS_ATOL, err_msg=name)
            bad = [k for k, v in errs.items()
                   if k != "loss" and not v <= REPORT_ATOL]
            if bad:
                raise AssertionError(f"{name}: report card vs CPU: {bad}")
    log(f"  flow presets: {json.dumps(summary)}")


def bf16_library(ptr, col, w, xb, n_rows, n_cols):
    """``torch.sparse.mm`` of the CSR matrix with bfloat16 values and the
    bfloat16 rows, where this PyTorch takes it (it rounds the weights and
    the output to bfloat16 too); None where it raises."""
    try:
        a = torch.sparse_csr_tensor(ptr, col, w.to(torch.bfloat16),
                                    size=(n_rows, n_cols))
        torch.sparse.mm(a, xb)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as err:
        reason = str(err).splitlines()[0][:120]
        log(f"    torch.sparse.mm on bfloat16 values: none "
            f"({type(err).__name__}: {reason})")
        return None
    return lambda: torch.sparse.mm(a, xb)


def phase_bf16_kernels(split):
    """Phase 12: the bfloat16 payload's kernels (``csr_spmm_bf16``,
    ``csr_spmm_dw_bf16``, ``r1l_fwd_bf16``, ``r1l_bwd_bf16``) against their
    plain versions on the same bfloat16 rows at the linkpred shapes, at
    the float32 kernels' tolerances (the plain versions compute in float32
    over the widened rows, as the kernels do); event and device times, the
    bound (bfloat16 row bytes), the float32 kernel's times on the same
    values beside them; then ``SpmmOperator(precision="bf16",
    fused_bwd=True)`` under autograd, both directions, with exact launch
    counts (``csr_spmm_dw_bf16``'s main path), against the unfused
    backward.  Returns ``(entries, dw_launches)``."""
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.ops.cuda.spmm import SpmmOperator, operator_for

    bf16 = torch.bfloat16
    g = split["graph"].to(DEVICE)
    spmm = operator_for(g)
    n, e, e_pad, d = g.n_src, g.num_edges, g.num_padded_edges, LP_D
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    h = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    hb, gb = h.to(bf16), gout.to(bf16)
    logits = torch.randn(e_pad, generator=gen, device=DEVICE) * 2
    att = sm.seg_softmax_fwd_plain(spmm.ptr, logits, None, e)[0]
    log(f"  linkpred graph: {n} rows, {e} edges, d {d}; rows in bfloat16, "
        f"every sum float32; tolerances as the float32 kernels'")
    results = []

    def timed(name, kernel, plain, f32_kernel, bnd, library=None):
        ms, dev_ms = time_ms(kernel), device_ms(kernel)
        plain_ms = time_ms(plain, reps=5, iters=5)
        f32_ms, f32_dev = time_ms(f32_kernel), device_ms(f32_kernel)
        lib_ms = lib_dev = None
        if library is not None:
            lib_ms, lib_dev = time_ms(library), device_ms(library)
        log(f"  {name}: kernel {ms:.4f} ms (device {fmt(dev_ms)}), plain "
            f"{plain_ms:.4f} ms, the float32 kernel {f32_ms:.4f} ms (device "
            f"{fmt(f32_dev)}), bound {bnd[0]:.5f} ms ({bnd[1]}, bfloat16 "
            f"rows); library "
            + ("none" if library is None else
               f"torch.sparse.mm on bfloat16 values {lib_ms:.4f} ms (device "
               f"{fmt(lib_dev)})"))
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib_ms, "device_ms": dev_ms,
                "library_device_ms": lib_dev, "f32_ms": f32_ms,
                "f32_device_ms": f32_dev}

    # csr_spmm_bf16: the materialised layer's A(att) h and its dx A(att)^T g
    # (the fused layer's q-weighted dx is the second form)
    w_t = spmm.weights(att, True)
    uses = (("att A h", (spmm.ptr, spmm.col, att[:e].contiguous(), hb, n),
             h, n),
            ("att dx A^T g", (spmm.t_ptr, spmm.t_col, w_t, gb, n), gout, n))
    errs, first = [], None
    for label, args, x32, n_cols in uses:
        got = cuda_spmm.csr_spmm(*args)
        want = cuda_spmm.csr_spmm_plain(*args)
        torch.cuda.synchronize()
        errs.append(close(f"csr_spmm_bf16[{label}]", got, want, SUM_RTOL,
                          SUM_ATOL_REL * float(want.abs().max())))
        same_bits(f"csr_spmm_bf16[{label}]",
                  lambda args=args: cuda_spmm.csr_spmm(*args))
        args32 = (*args[:3], x32, args[4])
        t = timed(f"csr_spmm_bf16[{label}]",
                  lambda args=args: cuda_spmm.csr_spmm(*args),
                  lambda args=args: cuda_spmm.csr_spmm_plain(*args),
                  lambda args32=args32: cuda_spmm.csr_spmm(*args32),
                  spmm_bound(args[0], args[1], args[3], n),
                  bf16_library(args[0], args[1], args[2], args[3], n,
                               n_cols))
        first = first or t
    results.append({**entry("csr_spmm_bf16", "spmm.cu",
                            "msha_gnn_tpu/ops/pallas/spmm.py:244 "
                            "_visit_kernel (bf16 :269) and :747 _hub_kernel "
                            "(bf16 :774)", max(errs), first["ms"],
                            first["plain_ms"],
                            (first["bound_ms"], first["bound_by"]),
                            first["library_ms"]), **first})

    # csr_spmm_dw_bf16: both directions, g and x in bfloat16
    dw_run, dw_group = cuda_spmm.DW_RUN, r1.group_for(d)
    errs, first = [], None
    for label, transpose in (("dw of A x", False), ("dw of A^T x", True)):
        if transpose:
            head = (spmm.ptr, spmm.col, None, att)
        else:
            head = (spmm.t_ptr, spmm.t_col, spmm.t_edge, att)
        args, args32 = (*head, gb, hb, n, e_pad), (*head, gout, h, n, e_pad)
        ws = torch.empty(cuda_spmm.sums_ws_floats(e_pad, dw_run, d),
                         device=DEVICE)
        prime_nan((e_pad,), (n, d), (ws.numel(),))
        dx, dw = cuda_spmm.csr_spmm_dw(*args, ws)
        want_dx, want_dw = cuda_spmm.csr_spmm_dw_plain(*args)
        torch.cuda.synchronize()
        errs += [close(f"csr_spmm_dw_bf16[{label}] dx", dx, want_dx,
                       SUM_RTOL, SUM_ATOL_REL * float(want_dx.abs().max())),
                 close(f"csr_spmm_dw_bf16[{label}] dw", dw, want_dw,
                       KERNEL_RTOL, KERNEL_ATOL)]
        if dw[e:].any():
            raise AssertionError("csr_spmm_dw_bf16 left a pad slot nonzero")
        same_bits(f"csr_spmm_dw_bf16[{label}]",
                  lambda args=args, ws=ws: cuda_spmm.csr_spmm_dw(*args, ws))
        t = timed(f"csr_spmm_dw_bf16[{label}] ({dw_run} slots a run, "
                  f"{dw_group} lanes an edge)",
                  lambda args=args, ws=ws: cuda_spmm.csr_spmm_dw(*args, ws),
                  lambda args=args: cuda_spmm.csr_spmm_dw_plain(*args),
                  lambda args32=args32, ws=ws:
                  cuda_spmm.csr_spmm_dw(*args32, ws),
                  dw_bound(args[0], args[1], args[2], gb, e_pad))
        first = first or t
    results.append({**entry("csr_spmm_dw_bf16", "spmm.cu",
                            "msha_gnn_tpu/ops/pallas/spmm.py:282 "
                            "_visit_dw_kernel (bf16 :315) and :340 "
                            "_hub_dw_kernel (bf16 :370)", max(errs),
                            first["ms"], first["plain_ms"],
                            (first["bound_ms"], first["bound_by"]), None),
                    **first})

    # r1l_fwd_bf16 / r1l_bwd_bf16 on the path's kind of inputs
    op = r1.Rank1GatOperator(g, dst_linear=True)
    c = torch.randn(n, generator=gen, device=DEVICE)
    a = torch.randn(d, generator=gen, device=DEVICE) * 0.3
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=DEVICE)
    (fwd_b, fwd_by), (bwd_b, bwd_by) = r1l_bounds(n, e, d, row_bytes=2)
    fwd_errs, bwd_errs = [], []
    for rate in (0.0, 0.5):
        args = (op.ptr, op.col, c, a, hb, seed, rate, op.slope, n)
        args32 = (op.ptr, op.col, c, a, h, seed, rate, op.slope, n)
        prime_nan((n, d), (n,))
        out, lse = r1.r1l_fwd(*args)
        want_out, want_lse = r1.rank1_gat_plain(*args)
        torch.cuda.synchronize()
        fwd_errs += [close(f"r1l_fwd_bf16[rate {rate}] out", out, want_out,
                           KERNEL_RTOL, KERNEL_ATOL),
                     close(f"r1l_fwd_bf16[rate {rate}] lse", lse, want_lse,
                           KERNEL_RTOL, KERNEL_ATOL)]
        same_bits(f"r1l_fwd_bf16[rate {rate}]",
                  lambda args=args: r1.r1l_fwd(*args))
        fwd_t = timed(f"r1l_fwd_bf16[rate {rate}]",
                      lambda args=args: r1.r1l_fwd(*args),
                      lambda args=args: r1.rank1_gat_plain(*args),
                      lambda args32=args32: r1.r1l_fwd(*args32),
                      (fwd_b, fwd_by))
        bargs = (op.ptr, op.col, c, a, hb, gout, want_out, want_lse, seed,
                 rate, op.slope, n)
        bargs32 = (op.ptr, op.col, c, a, h, gout, want_out, want_lse, seed,
                   rate, op.slope, n)
        prime_nan((e,), (e,), (n,), (e * (2 + d),))
        q, dpre, dc, da = r1.r1l_bwd(*bargs)
        wq, wdpre, wdc, wda = r1.rank1_gat_bwd_plain(*bargs)
        torch.cuda.synchronize()
        bwd_errs += [
            close(f"r1l_bwd_bf16[rate {rate}] q", q, wq, KERNEL_RTOL,
                  KERNEL_ATOL),
            close(f"r1l_bwd_bf16[rate {rate}] dpre", dpre, wdpre, SUM_RTOL,
                  SUM_ATOL_REL * float(wdpre.abs().max())),
            close(f"r1l_bwd_bf16[rate {rate}] dc", dc, wdc, SUM_RTOL,
                  SUM_ATOL_REL * float(wdc.abs().max())),
            close(f"r1l_bwd_bf16[rate {rate}] da", da, wda, SUM_RTOL,
                  SUM_ATOL_REL * float(wda.abs().max()))]
        same_bits(f"r1l_bwd_bf16[rate {rate}]",
                  lambda bargs=bargs: r1.r1l_bwd(*bargs))
        bwd_t = timed(f"r1l_bwd_bf16[rate {rate}]",
                      lambda bargs=bargs: r1.r1l_bwd(*bargs),
                      lambda bargs=bargs: r1.rank1_gat_bwd_plain(*bargs),
                      lambda bargs32=bargs32: r1.r1l_bwd(*bargs32),
                      (bwd_b, bwd_by))
    # the training step's form (rate 0.5) in the kernels line
    results.append({**entry("r1l_fwd_bf16", "rank1_gat.cu",
                            "msha_gnn_tpu/ops/pallas/rank1_gat.py:234 "
                            "_r1l_fwd_kernel (bf16 :295)", max(fwd_errs),
                            fwd_t["ms"], fwd_t["plain_ms"], (fwd_b, fwd_by),
                            None), **fwd_t})
    results.append({**entry("r1l_bwd_bf16", "rank1_gat.cu",
                            "msha_gnn_tpu/ops/pallas/rank1_gat.py:305 "
                            "_r1l_bwd_kernel (bf16 :768)", max(bwd_errs),
                            bwd_t["ms"], bwd_t["plain_ms"], (bwd_b, bwd_by),
                            None), **bwd_t})

    results += broadcast_kernels(g, spmm, gen)

    # the main path of csr_spmm_dw_bf16: the bf16 operator with fused_bwd
    # under autograd, against the same operator without it
    launches = 0
    ops = {fused: SpmmOperator(g, DEVICE, fused_bwd=fused, precision="bf16")
           for fused in (False, True)}
    for label, transpose in (("A x", False), ("A^T x", True)):
        grads = {}
        for fused, bop in ops.items():
            xx, ww = h.clone().requires_grad_(), att.clone().requires_grad_()
            zero_counts(bop)
            out = bop(xx, transpose=transpose, edge_weight=ww)
            out.backward(gout)
            torch.cuda.synchronize()
            counts = read_counts(bop)
            want = (expected(csr_spmm_bf16=1, csr_spmm_dw_bf16=1,
                             csr_spmm_f32_transposed=int(transpose))
                    if fused else
                    expected(csr_spmm_bf16=2, csr_sddmm_f32=1,
                             csr_spmm_f32_transposed=1))
            log(f"  SpmmOperator(precision='bf16', fused_bwd={fused}) "
                f"forward and backward of {label}: {counts}")
            if counts != want:
                raise AssertionError(f"expected {want} launches, got "
                                     f"{counts}")
            grads[fused] = (out.detach(), xx.grad, ww.grad)
        launches += 1
        for name, got, want_g in zip(("out", "dx", "dw"), grads[True],
                                     grads[False]):
            close(f"bf16 fused_bwd vs unfused {label}: {name}", got, want_g,
                  KERNEL_RTOL if name == "dw" else SUM_RTOL,
                  KERNEL_ATOL if name == "dw"
                  else SUM_ATOL_REL * float(want_g.abs().max()))
    return results, launches


def broadcast_kernels(g, spmm, gen):
    """Phase 12, the row broadcast and its adjoint alone (the out-of-core
    step's ``broadcast_rows``): ``seg_expand_f32`` over the linkpred rows
    into NaN-primed slots (the edges' row values bit for bit, the pads 0)
    and ``seg_reduce_f32`` at d = 1 (the sorted row sums) against their
    plain versions, each twice bit for bit; event, device, plain and
    library times (an ``index_select`` of the senders; ``torch.
    segment_reduce``, or ``index_add_`` where it does not run) and the byte
    bounds."""
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    n, e, e_pad = g.n_src, g.num_edges, g.num_padded_edges
    v = torch.randn(n, generator=gen, device=DEVICE)
    gs = torch.randn(e_pad, generator=gen, device=DEVICE)
    senders = g.senders[:e].contiguous()
    results = []

    def expand():
        return sm.seg_expand(spmm.ptr, v, e_pad, e)

    prime_nan((e_pad,))
    got = expand()
    want = sm.seg_expand_plain(spmm.ptr, v, e_pad)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(
            got[:e], v.index_select(0, senders)):
        raise AssertionError("seg_expand_f32 differs from its plain version")
    log(f"  seg_expand_f32: {e} edges ({e_pad} slots) bit for bit equal to "
        f"its plain version, the pads 0")
    same_bits("seg_expand_f32", expand)
    ptr = spmm.ptr.long()

    def gather():
        return v.index_select(0, senders)

    def rowsum():
        return cuda_spmm.row_sums(gs[:, None], spmm.ptr, n_rows=n)

    prime_nan((n, 1))
    got = rowsum()
    want = cuda_spmm.segment_reduce_sorted_plain(gs[:, None], None, spmm.ptr,
                                                 n_src=n)
    torch.cuda.synchronize()
    sum_err = close("seg_reduce_f32[rowsum d=1]", got, want, SUM_RTOL,
                    SUM_ATOL_REL * float(want.abs().max()))
    same_bits("seg_reduce_f32[rowsum d=1]", rowsum)

    def segsum():
        return torch.segment_reduce(gs[:e], "sum", offsets=ptr)

    lib_name = "torch.segment_reduce"
    try:
        segsum()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  torch.segment_reduce does not run here ({exc}): index_add_")
        lib_name = "index_add_"
        rows = g.senders[:e].long()

        def segsum():
            return gs.new_zeros(n).index_add_(0, rows, gs[:e])

    for name, kernel, plain, library, lib, bnd, err, source, replaces in (
            ("seg_expand_f32", expand,
             lambda: sm.seg_expand_plain(spmm.ptr, v, e_pad), gather,
             "index_select of the senders",
             # the pointer and v read once, out [e_pad] written once
             bound(4 * (n + 1) + 4 * n + 4 * e_pad, 0), 0.0, "softmax.cu",
             "msha_gnn_tpu/ops/pallas/softmax.py:86 _expand_kernel"),
            ("seg_reduce_f32[rowsum d=1]", rowsum,
             lambda: cuda_spmm.segment_reduce_sorted_plain(
                 gs[:, None], None, spmm.ptr, n_src=n), segsum, lib_name,
             # the pointer and the E values read once, [n] written; an add
             # an edge
             bound(4 * (n + 1) + 4 * e + 4 * n, e), sum_err, "spmm.cu",
             "msha_gnn_tpu/ops/pallas/softmax.py:102 _rowsum_kernel")):
        ms, dev_ms = time_ms(kernel), device_ms(kernel)
        plain_ms = time_ms(plain, reps=5, iters=5)
        lib_ms, lib_dev = time_ms(library), device_ms(library)
        log(f"  {name}: kernel {ms:.4f} ms (device {fmt(dev_ms)}), plain "
            f"{plain_ms:.4f} ms, {lib} {lib_ms:.4f} ms (device "
            f"{fmt(lib_dev)}), bound {bnd[0]:.5f} ms ({bnd[1]})")
        results.append({**entry(name, source, replaces, err, ms, plain_ms,
                                bnd, lib_ms), "device_ms": dev_ms,
                        "library_device_ms": lib_dev})
    return results


def with_precision(model, precision):
    """A copy of the linkpred model whose encoder streams its rows at
    ``precision`` (the same weights)."""
    from msha_gnn_torch.models import SparseGAT

    enc = model.encoder
    out = copy.deepcopy(model)
    out.encoder = SparseGAT(LP_D, LP_D, LP_D, n_heads=enc.n_heads,
                            dropout=enc.dropout, precision=precision)
    out.encoder.load_state_dict(enc.state_dict())
    return out.to(next(model.parameters()).device)


def loss_and_grads(model, graph, batch, impl, generator=None, state=None):
    """One step's loss and gradients (no optimiser step), the generator
    set to ``state`` first."""
    from msha_gnn_torch.training import linkpred_loss

    if state is not None:
        generator.set_state(state)
    model.zero_grad(set_to_none=True)
    loss = linkpred_loss(model, graph, batch, impl=impl, generator=generator)
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach().clone()
                         for k, p in model.named_parameters()}


def compare_steps(name, got, want, loss_rtol, grad_rtol, grad_atol_rel):
    """Loss at ``loss_rtol`` and every gradient leaf at ``grad_rtol`` and
    ``grad_atol_rel`` of the leaf's largest value."""
    (loss_g, grads_g), (loss_w, grads_w) = got, want
    loss_err = abs(loss_g - loss_w) / abs(loss_w)
    worst, bad = 0.0, []
    for k, w in grads_w.items():
        gk = grads_g[k].to(w.device)
        scale = float(w.abs().max())
        worst = max(worst, float((gk - w).abs().max()) / max(scale, 1e-30))
        if not torch.allclose(gk, w, rtol=grad_rtol,
                              atol=grad_atol_rel * scale):
            bad.append(k)
    log(f"  {name}: loss {loss_g:.7f} vs {loss_w:.7f}, rel err "
        f"{loss_err:.2e} (rtol {loss_rtol}); gradients max abs err "
        f"{worst:.2e} of each leaf's largest (rtol {grad_rtol}, atol "
        f"{grad_atol_rel} of the largest)")
    if bad or loss_err > loss_rtol:
        raise AssertionError(f"{name}: loss or the gradients of {bad}")


BF16_STEP_WANT = {
    "fused": expected(r1l_fwd_bf16=3, r1l_bwd_bf16=3, csr_spmm_bf16=3,
                      csr_spmm_f32=3, csr_spmm_f32_transposed=6,
                      csr_spmm_f32_reduce_edges=3),
    "materialised": expected(csr_spmm_bf16=6, csr_spmm_f32_transposed=3,
                             csr_sddmm_f32=3, seg_softmax_fwd_f32=3,
                             seg_softmax_fwd_f32_dropout=3,
                             seg_softmax_bwd_f32=3,
                             seg_softmax_bwd_f32_dropout=3),
    "flash": STEP_WANT["flash"],
}


def phase_bf16_step(split):
    """Phase 13: a ``SparseGAT(precision="bf16")`` linkpred training step at
    ``LinkPredConfig()`` widths, per impl, from the f32 run's state and
    generator state: exact launch counts (the main path of the bfloat16
    kernels); ``fused`` and ``materialised`` held against their plain
    bfloat16 step (the same step on the CPU, at dropout 0, where both
    devices draw nothing: the plain versions of the same kernels;
    ``materialised`` also against ``impl="torch"`` on the card at dropout
    0.5) at ``BF16_FLIP_TOL``, and against the f32 step at
    ``BF16_STEP_TOL`` of each value's largest; ``flash`` equal to its f32
    step bit for bit (its kernels have no bfloat16 mode); the step's wall,
    kernels, device time and idle share.  Returns the launches of one
    fused and one materialised step."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from msha_gnn_torch.ops.cuda.spmm import operator_for
    from msha_gnn_torch.training import (LinkPredConfig, adam_l2,
                                         build_link_prediction, train_step)
    from msha_gnn_torch.training.link_prediction import epoch_batches

    counts_by_impl = {}
    graph_cpu = split["graph"]
    for impl in ("fused", "materialised", "flash"):
        run = build_link_prediction(split, LinkPredConfig(impl=impl),
                                    device=DEVICE)
        batches = epoch_batches(run)
        batch = batches[0]
        m16 = with_precision(run.model, "bf16")
        gen, state = run.generator, run.generator.get_state()
        f32 = loss_and_grads(run.model, run.graph, batch, impl, gen, state)
        op = operator_for(run.graph, "bf16" if impl == "materialised"
                          else "f32")
        zero_counts(op)
        b16 = loss_and_grads(m16, run.graph, batch, impl, gen, state)
        torch.cuda.synchronize()
        counts = read_counts(op)
        log(f"  {impl}, precision bf16: one step's launches {counts}")
        if counts != BF16_STEP_WANT[impl]:
            raise AssertionError(f"expected {BF16_STEP_WANT[impl]}, got "
                                 f"{counts}")
        counts_by_impl[impl] = counts
        if impl == "flash":
            if b16[0] != f32[0] or not all(torch.equal(b16[1][k], v)
                                           for k, v in f32[1].items()):
                raise AssertionError("flash: the bf16 step differs from the "
                                     "f32 step")
            log("  flash, precision bf16: loss and every gradient bit-equal "
                "to the f32 step (flash has no bfloat16 mode)")
            continue
        compare_steps(f"{impl} bf16 vs f32 step", b16, f32, BF16_STEP_TOL,
                      0.0, BF16_STEP_TOL)
        if impl == "materialised":
            plain = loss_and_grads(m16, run.graph, batch, "torch", gen, state)
            compare_steps("materialised bf16 vs the plain bf16 step "
                          "(impl torch, on the card, dropout 0.5)", b16,
                          plain, STEP_LOSS_RTOL, 0.0, BF16_FLIP_TOL)
        run0 = build_link_prediction(split, LinkPredConfig(
            impl=impl, dropout=0.0), device=DEVICE)
        m0 = with_precision(run0.model, "bf16")
        m0_cpu = copy.deepcopy(m0).cpu()
        card = loss_and_grads(m0, run0.graph, batch, impl)
        t0 = time.perf_counter()
        cpu = loss_and_grads(m0_cpu, graph_cpu, batch.cpu(), impl)
        compare_steps(f"{impl} bf16 at dropout 0, card vs the plain bf16 "
                      f"step on the CPU ({time.perf_counter() - t0:.1f} s)",
                      card, cpu, STEP_LOSS_RTOL, 0.0, BF16_FLIP_TOL)

        # the step's wall, kernels, device time and idle share, bf16 and
        # f32 from the same state in turns
        runs = {"f32": run, "bf16": dataclasses.replace(
            run, model=m16, optimizer=adam_l2(m16.parameters(),
                                              run.cfg.lr))}
        walls = {k: [] for k in runs}
        for i in range(2, 12):
            for k in (("f32", "bf16") if i % 2 else ("bf16", "f32")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(runs[k], batches[i])
                torch.cuda.synchronize()
                walls[k].append((time.perf_counter() - t0) * 1e3)
        for k, r in runs.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for b in batches[12:17]:
                    train_step(r, b)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            on_card = [evt for evt in prof.key_averages()
                       if evt.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(evt, "is_user_annotation", False)]
            busy = sum(getattr(evt, "self_device_time_total", 0.0)
                       or getattr(evt, "self_cuda_time_total", 0.0)
                       for evt in on_card) / 1e3
            log(f"  {impl} {k} step: wall p50 "
                f"{statistics.median(walls[k]):.3f} ms (10 steps, in turns "
                f"with the other precision), "
                f"{sum(evt.count for evt in on_card) / 5} device kernels and "
                f"{busy / 5:.4f} ms of device a step, idle "
                f"{max(0.0, 1 - busy / wall_ms) if busy else None}")
    return counts_by_impl


def build_edges(n_nodes: int, n_edges: int, seed: int = 0):
    """``scripts_scale_train.py::build_edges`` (:29-39), copied (that script
    imports JAX): sorted uniform senders, receivers drawn with p ~ k^-1.5
    (node 0 takes about 38% of the edges)."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n_nodes, n_edges).astype(np.int32))
    p = 1.0 / np.arange(1, n_nodes + 1) ** 1.5
    cdf = np.cumsum(p / p.sum())
    dst = np.minimum(
        np.searchsorted(cdf, rng.random(n_edges)), n_nodes - 1
    ).astype(np.int32)
    return src, dst


def scale_want(k, fused, precision, steps):
    """Launches of ``steps`` out-of-core steps at ``k`` slices.  Fused: a
    slice's r1l_fwd, r1l_bwd and its two dx SpMMs (the q-weighted
    transposed gather and the d = 1 column sum of dpre).  Materialised:
    the sender term's broadcast and its adjoint, the softmax both ways, a
    slice's forward SpMM, its dx SpMM (the transposed operator's slice) and
    its dw SDDMM."""
    if fused:
        fwd, bwd = (("r1l_fwd_bf16", "r1l_bwd_bf16") if precision == "bf16"
                    else ("r1l_fwd_f32", "r1l_bwd_f32"))
        return expected(**{fwd: k * steps, bwd: k * steps,
                           "csr_spmm_f32": 2 * k * steps})
    return expected(seg_expand_f32=steps, seg_reduce_f32=steps,
                    seg_softmax_fwd_f32=steps, seg_softmax_bwd_f32=steps,
                    csr_spmm_f32=2 * k * steps, csr_sddmm_f32=k * steps)


def slice_bounds_ms(s, r, k, d):
    """The mean over the ``k`` slices of CSR-ordered edges ``(s, r)`` of
    each per-slice launch's least time (ms, what bounds it), every input
    read once and every output written once over the slice's distinct
    senders (``n_s``) and receivers (``n_r``): ``r1l_fwd`` (ptr, col, c, a,
    the n_r rows of x in, out and lse out; the aggregation's 2 E d and
    ``t``'s 2 n_r d flops), ``r1l_bwd`` (gout, out and lse in too; q, dpre,
    dc, da out; 4 E d + 4 n_r d), the q-weighted dx SpMM (its pointer over
    n_r rows, col and weight, the n_s rows of gout, [n_r, d] out; 2 E d),
    the d = 1 column sum of dpre (pointer, edge ids, dpre, [n_r] out; E)
    and the materialised dw SDDMM (pointer, col, the n_s and n_r rows, the
    E dots out; 2 E d)."""
    from msha_gnn_torch.ops.chunked import slice_bounds

    sums = {}
    for lo, hi in slice_bounds(len(s), k):
        e = hi - lo
        n_s = int(np.count_nonzero(np.diff(s[lo:hi]))) + 1
        n_r = int(np.unique(r[lo:hi]).size)
        for name, nbytes, flops in (
                ("r1l_fwd", 4 * (n_s + 1) + 4 * e + 4 * n_s + 4 * d
                 + 4 * n_r * d + 4 * n_s * d + 4 * n_s,
                 2 * e * d + 2 * n_r * d),
                ("r1l_bwd", 4 * (n_s + 1) + 4 * e + 4 * n_s + 4 * d
                 + 4 * n_r * d + 3 * 4 * n_s * d + 8 * e + 4 * n_s + 4 * d,
                 4 * e * d + 4 * n_r * d),
                ("dx q A^T g", 4 * (n_r + 1) + 8 * e + 4 * n_s * d
                 + 4 * n_r * d, 2 * e * d),
                ("dpre column sum", 4 * (n_r + 1) + 8 * e + 4 * n_r, e),
                ("dw sddmm", 4 * (n_s + 1) + 4 * e + 4 * (n_s + n_r) * d
                 + 4 * e, 2 * e * d)):
            t, by = bound(nbytes, flops)
            sums[name] = (sums.get(name, (0.0, by))[0] + t / k, by)
    return sums


class ProfiledStep:
    """A ``log`` hook of ``scale._train`` that hands every event on to
    ``sink`` and runs step ``at`` (>= 1) of the training loop itself under
    ``torch.profiler``: its wall (draw, forward, backward, Adam), device
    kernels, device ms and idle share, the largest kernels by name, in
    ``self.out`` once that step has ended."""

    def __init__(self, label, at, sink):
        self.label, self.at, self.sink = label, at, sink
        self.prof = self.out = None
        self.t0 = 0.0

    def __call__(self, ev):
        from torch.profiler import ProfilerActivity, profile

        self.sink(ev)
        if ev.get("step") == self.at - 1:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif ev.get("step") == self.at:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.stop()
            self.out = self.summary(wall_ms)

    def summary(self, wall_ms):
        def us(evt):
            return (getattr(evt, "self_device_time_total", 0.0)
                    or getattr(evt, "self_cuda_time_total", 0.0))

        on_card = [evt for evt in self.prof.key_averages()
                   if evt.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(evt, "is_user_annotation", False)]
        busy_ms = sum(us(evt) for evt in on_card) / 1e3
        out = {"profiled_wall_ms": wall_ms,
               "device_kernels": sum(evt.count for evt in on_card),
               "device_ms": busy_ms or None,
               "device_idle_share": (max(0.0, 1 - busy_ms / wall_ms)
                                     if busy_ms else None)}
        log(f"  {self.label}, step {self.at} profiled: {json.dumps(out)}")
        for evt in sorted(on_card, key=lambda e: -us(e))[:10]:
            short = evt.key.replace("void ", "").replace(
                "at::native::", "").replace("(anonymous namespace)::", "")
            log(f"    {self.label} device: {us(evt) / 1e3:.3f} ms, "
                f"{evt.count} launches: {short[:140]}")
        return out


def loss_and_grad(loss_fn, params0, batch):
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params0.items()}
    loss = loss_fn(params, *batch)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), {k: v.grad for k, v in params.items()}


def scale_params(cfg, n_nodes=None, device=None):
    """``train_chunked``'s initial parameters (a CPU generator seeded
    ``cfg.seed``) on ``device`` (the card's by default)."""
    from msha_gnn_torch.training import scale

    return {key: v.to(device or DEVICE) for key, v in scale._init_params(
        torch.Generator().manual_seed(cfg.seed), n_nodes or SCALE_NODES,
        cfg.d).items()}


class SliceChecks:
    """Each quantity of a run of per-slice checks against float64 plain
    versions: raises at the first slice past its tolerance, and logs the
    worst slice of every quantity once the run is over."""

    def __init__(self, label):
        self.label, self.worst = label, {}

    def __call__(self, name, i, got, want, rtol, atol_rel=None):
        """``got`` (the card's) against the float64 ``want``, at ``rtol``
        and ``atol_rel`` x max|want| (``KERNEL_ATOL`` when None)."""
        want_max = float(want.abs().max()) if want.numel() else 0.0
        atol = KERNEL_ATOL if atol_rel is None else atol_rel * want_max
        got = got.double()
        err = float((got - want).abs().max()) if want.numel() else 0.0
        if not bool(torch.isfinite(got).all()) or not torch.allclose(
                got, want, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{self.label} {name}, slice {i}: max abs err {err:.3e} "
                f"(max |value| {want_max:.3e}; rtol {rtol}, atol "
                f"{atol:.1e}) against its plain version")
        if err >= self.worst.get(name, (-1.0,))[0]:
            self.worst[name] = (err, i, want_max, rtol, atol)

    def report(self):
        for name, (err, i, vmax, rtol, atol) in self.worst.items():
            log(f"  {self.label} {name}: worst max abs err {err:.3e} "
                f"(slice {i}, max |value| {vmax:.3e}; rtol {rtol}, atol "
                f"{atol:.1e})")


def slice_yardstick(name, kernel, library, lib_name):
    """One out-of-core slice's kernel launch beside one PyTorch call that
    computes the same values on the same inputs (held to the kernel's at
    the sums' tolerance): event and device times of both (5 x 5 calls; a
    launch here takes about a millisecond)."""
    got = kernel().reshape(-1)
    try:
        ref = library()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  {name}: {lib_name} does not run here ({exc})")
        return
    if ref.layout == torch.sparse_csr:
        ref = ref.values()
    torch.cuda.synchronize()
    close(f"{name}: {lib_name} vs the kernel", ref.reshape(-1), got,
          SUM_RTOL, SUM_ATOL_REL * float(got.abs().max()))
    ms, dev = time_ms(kernel, reps=5, iters=5), device_ms(kernel, iters=5)
    lib_ms = time_ms(library, reps=5, iters=5)
    lib_dev = device_ms(library, iters=5)
    log(f"  {name}: kernel {ms:.4f} ms (device {fmt(dev)}), {lib_name} "
        f"{lib_ms:.4f} ms (device {fmt(lib_dev)})")


def heaviest(slices, ptr_of):
    """The index of the slice whose CSR ``ptr_of(slice)`` has the longest
    row (the hub receiver's share)."""
    return max(range(len(slices)), key=lambda i: int(
        (ptr_of(slices[i])[1:] - ptr_of(slices[i])[:-1]).max()))


def hold_rank1_slices(op, c, a, x16, gouts, seed):
    """``ChunkedRank1Gat`` ``op`` on the card against its kernels' float64
    plain versions on the same inputs (``x16`` the rows as the kernels read
    them): each slice's ``r1l_fwd`` (out, lse), then for each cotangent
    of ``gouts`` (name -> [n_src, d]) each slice's ``r1l_bwd`` (q, dpre,
    dc, da) and its two ``dx`` SpMMs (over the hub receiver's 1.6 M slots a
    slice); the operator's merged ``(out, lse)`` and ``(dc, da, dx)``
    against a plain assembly of their own: the pieces merged by a scatter
    log-sum-exp, ``dx`` by ``index_add_`` of ``q g + dpre a`` at the
    receivers."""
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain, \
        edge_rows

    check = SliceChecks(f"{op.precision} ChunkedRank1Gat")
    slope, n = op.slope, op.n_src
    c64, a64, x64 = (v.double() for v in (c, a, x16))
    got_out, got_lse = op.forward_state(c, a, x16)
    pieces = []
    for i, rs in enumerate(op.slices):
        sl = rs.sl
        o, l = r1.r1l_fwd(sl.ptr, sl.col, c.index_select(0, sl.rows), a, x16,
                          seed, 0.0, slope, sl.n_rows)
        wo, wl = r1.rank1_gat_plain(sl.ptr, sl.col, c64[sl.rows], a64, x64,
                                    seed, 0.0, slope, sl.n_rows)
        check("r1l_fwd out", i, o, wo, SUM_RTOL, SUM_ATOL_REL)
        check("r1l_fwd lse", i, l, wl, KERNEL_RTOL)
        pieces.append((sl.rows, wo, wl))
    rows = torch.cat([p[0] for p in pieces])
    lse_i = torch.cat([p[2] for p in pieces])
    m = torch.full((n,), float(r1.NEG), dtype=torch.float64, device=DEVICE)
    m = m.scatter_reduce(0, rows, lse_i, "amax", include_self=True)
    w = torch.where(lse_i > r1.NEG / 2, torch.exp(lse_i - m[rows]), 0.0)
    total = torch.zeros(n, dtype=torch.float64, device=DEVICE).index_add_(
        0, rows, w)
    live = total > 0
    want_lse = torch.where(live, m + torch.log(torch.where(live, total, 1.0)),
                           float(r1.NEG))
    want_out = torch.zeros((n, x16.shape[1]), dtype=torch.float64,
                           device=DEVICE)
    for (rows_i, wo, wl), w_i in zip(pieces, torch.split(
            w, [p[0].numel() for p in pieces])):
        want_out.index_add_(0, rows_i, w_i[:, None] * wo)
    want_out /= torch.where(live, total, 1.0)[:, None]
    del pieces, rows, lse_i, m, w, total
    check("merged out", "all", got_out, want_out, SUM_RTOL, SUM_ATOL_REL)
    check("merged lse", "all", got_lse, want_lse, KERNEL_RTOL)
    # the backward a slice against the plain merged state, as f32 rounds it
    out32, lse32 = want_out.float(), want_lse.float()
    out64, lse64 = out32.double(), lse32.double()
    del want_out, want_lse
    for what, gout in gouts.items():
        g64 = gout.double()
        got_dc, got_da, got_dx = op.backward_state(c, a, x16, got_out,
                                                    got_lse, gout)
        want_dc = torch.zeros(n, dtype=torch.float64, device=DEVICE)
        want_da = torch.zeros_like(a64)
        want_dx = torch.zeros_like(x64)
        for i, rs in enumerate(op.slices):
            sl = rs.sl
            q, dpre, dc_i, da_i = r1.r1l_bwd(
                sl.ptr, sl.col, c.index_select(0, sl.rows), a, x16,
                gout.index_select(0, sl.rows), out32.index_select(0, sl.rows),
                lse32.index_select(0, sl.rows), seed, 0.0, slope, sl.n_rows)
            wq, wdpre, wdc, wda = r1.rank1_gat_bwd_plain(
                sl.ptr, sl.col, c64[sl.rows], a64, x64, g64[sl.rows],
                out64[sl.rows], lse64[sl.rows], seed, 0.0, slope, sl.n_rows)
            check(f"{what}: r1l_bwd q", i, q, wq, KERNEL_RTOL, SUM_ATOL_REL)
            for name, got, want in (("dpre", dpre, wdpre), ("dc", dc_i, wdc),
                                    ("da", da_i, wda)):
                check(f"{what}: r1l_bwd {name}", i, got, want, SUM_RTOL,
                      SUM_ATOL_REL)
            n_t = rs.t_rows.numel()
            qt = q.index_select(0, rs.t_edge)
            check(f"{what}: dx q-weighted A^T g (csr_spmm_f32)", i,
                  csr_spmm(rs.t_ptr, rs.t_col, qt, gout, n_t),
                  csr_spmm_plain(rs.t_ptr, rs.t_col, qt.double(), g64, n_t),
                  SUM_RTOL, SUM_ATOL_REL)
            check(f"{what}: dx column sums of dpre (d = 1)", i,
                  csr_spmm(rs.t_ptr, rs.t_edge, None, dpre[:, None], n_t),
                  csr_spmm_plain(rs.t_ptr, rs.t_edge, None,
                                 dpre.double()[:, None], n_t),
                  SUM_RTOL, SUM_ATOL_REL)
            if op.precision == "f32" and what == "dense cotangent" \
                    and i == heaviest(op.slices, lambda r: r.t_ptr):
                # the library yardsticks of the slice's two dx launches
                a_t = torch.sparse_csr_tensor(rs.t_ptr, rs.t_col, qt,
                                              size=(n_t, gout.shape[0]))
                dcol = dpre[:, None].contiguous()
                dsorted = dpre.index_select(0, rs.t_edge)
                t_off = rs.t_ptr.long()
                slice_yardstick(
                    f"slice {i} dx q-weighted A^T g (d {gout.shape[1]}, "
                    f"{qt.numel()} edges, {n_t} rows)",
                    lambda: csr_spmm(rs.t_ptr, rs.t_col, qt, gout, n_t),
                    lambda: torch.sparse.mm(a_t, gout), "torch.sparse.mm")
                slice_yardstick(
                    f"slice {i} dx column sums of dpre (d = 1)",
                    lambda: csr_spmm(rs.t_ptr, rs.t_edge, None, dcol, n_t),
                    lambda: torch.segment_reduce(dsorted, "sum",
                                                 offsets=t_off),
                    "torch.segment_reduce (on dpre gathered to CSC order)")
                del a_t, dcol, dsorted, t_off
            del q, dpre, qt
            want_dc.index_add_(0, sl.rows, wdc)
            want_da += wda
            senders = sl.rows[edge_rows(sl.ptr, sl.col.numel())]
            want_dx.index_add_(0, sl.col.long(), wq[:, None] * g64[senders]
                               + wdpre[:, None] * a64)
            del wq, wdpre, senders
        for name, got, want in (("dc", got_dc, want_dc),
                                ("da", got_da, want_da),
                                ("dx", got_dx, want_dx)):
            check(f"{what}: merged {name}", "all", got, want, SUM_RTOL,
                  SUM_ATOL_REL)
    check.report()


def hold_spmm_slices(s, r, k, cfg, h, c, a_dst, gouts):
    """The materialised aggregation ``ChunkedSpmm.apply(h, att)`` on the
    card, with the attention of the seed's parameters, against float64
    plain versions on the same inputs: each slice's forward SpMM, then for
    each cotangent of ``gouts`` each slice's ``dw`` SDDMM and each
    transposed slice's ``dx`` SpMM (the hub receiver's 1.6 M slots); the
    operator's ``out`` and, under autograd, ``(dx, dw)`` against a plain
    assembly by ``index_add_``."""
    from msha_gnn_torch.ops.chunked import ChunkedSpmm
    from msha_gnn_torch.ops.cuda.sddmm import csr_sddmm, csr_sddmm_plain
    from msha_gnn_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain, \
        edge_rows
    from msha_gnn_torch.ops.segment import segment_softmax

    check = SliceChecks("f32 ChunkedSpmm.apply")
    op = ChunkedSpmm.from_host_coo(s, r, None, n_src=SCALE_NODES,
                                   n_dst=SCALE_NODES, num_slices=k,
                                   assume_sorted=True, device=DEVICE)
    s_dev = torch.from_numpy(s).to(DEVICE).long()
    r_dev = torch.from_numpy(r).to(DEVICE).long()
    att = segment_softmax(torch.nn.functional.leaky_relu(
        c[s_dev] + (h @ a_dst)[r_dev], cfg.negative_slope), s_dev,
        SCALE_NODES)
    del s_dev, r_dev
    hh, ww = h.detach().requires_grad_(), att.detach().requires_grad_()
    got_out = op.apply(hh, ww)
    h64, att64 = h.double(), att.double()
    want_out = torch.zeros_like(h64)
    for i, sl in enumerate(op.slices):
        check("csr_spmm_f32 forward", i,
              csr_spmm(sl.ptr, sl.col, att[sl.lo:sl.hi], h, sl.n_rows),
              csr_spmm_plain(sl.ptr, sl.col, att64[sl.lo:sl.hi], h64,
                             sl.n_rows), SUM_RTOL, SUM_ATOL_REL)
        want_out.index_add_(0, sl.rows, csr_spmm_plain(
            sl.ptr, sl.col, att64[sl.lo:sl.hi], h64, sl.n_rows))
    check("out", "all", got_out.detach(), want_out, SUM_RTOL, SUM_ATOL_REL)
    del want_out
    t = op._transpose_op()
    wt = att[t.input_perm]
    for what, gout in gouts.items():
        got_dx, got_dw = torch.autograd.grad(got_out, (hh, ww), gout,
                                             retain_graph=True)
        g64 = gout.double()
        want_dx = torch.zeros_like(h64)
        want_dw = torch.zeros_like(att64)
        for i, sl in enumerate(op.slices):
            e = sl.hi - sl.lo
            check(f"{what}: csr_sddmm_f32 dw", i,
                  csr_sddmm(sl.ptr, sl.col, gout.index_select(0, sl.rows), h,
                            e),
                  csr_sddmm_plain(sl.ptr, sl.col, g64[sl.rows], h64, e),
                  KERNEL_RTOL, SUM_ATOL_REL)
            if what == "dense cotangent" and i == heaviest(
                    op.slices, lambda v: v.ptr):
                g_rows = gout.index_select(0, sl.rows)
                pattern = torch.sparse_csr_tensor(
                    sl.ptr, sl.col, torch.zeros(e, device=DEVICE),
                    size=(sl.n_rows, h.shape[0]))
                h_t = h.t()
                slice_yardstick(
                    f"slice {i} dw SDDMM (d {h.shape[1]}, {e} edges)",
                    lambda: csr_sddmm(sl.ptr, sl.col, g_rows, h, e),
                    lambda: torch.sparse.sampled_addmm(pattern, g_rows, h_t,
                                                       beta=0.0),
                    "torch.sparse.sampled_addmm")
                del g_rows, pattern, h_t
            senders = sl.rows[edge_rows(sl.ptr, e)]
            cols = sl.col.long()
            want_dx.index_add_(0, cols,
                               att64[sl.lo:sl.hi, None] * g64[senders])
            want_dw[sl.lo:sl.hi] = (g64[senders] * h64[cols]).sum(1)
            del senders, cols
        for i, sl in enumerate(t.slices):
            check(f"{what}: csr_spmm_f32 dx (transposed)", i,
                  csr_spmm(sl.ptr, sl.col, wt[sl.lo:sl.hi], gout, sl.n_rows),
                  csr_spmm_plain(sl.ptr, sl.col, wt[sl.lo:sl.hi].double(),
                                 g64, sl.n_rows), SUM_RTOL, SUM_ATOL_REL)
        check(f"{what}: dx", "all", got_dx, want_dx, SUM_RTOL, SUM_ATOL_REL)
        check(f"{what}: dw", "all", got_dw, want_dw, KERNEL_RTOL,
              SUM_ATOL_REL)
        del got_dx, got_dw, want_dx, want_dw
    check.report()


def hold_to_plain(src, dst, k, cfg):
    """The out-of-core layer at the full graph on the card against float64
    plain versions on the same inputs, slice by slice: the layer's inputs
    at the seed's parameters (``c``, ``a_dst``, ``h``), and two
    cotangents of its output, the first batch's loss's (nonzero at the
    batch's 16 K nodes only) and a dense normal one (every slot of every
    sum)."""
    from msha_gnn_torch.ops.chunked_rank1 import ChunkedRank1Gat
    from msha_gnn_torch.training import scale

    t0 = time.perf_counter()
    params = scale_params(cfg)
    d = cfg.d
    with torch.no_grad():
        h = params["feat"] @ params["W"]
        c, a_dst = h @ params["a"][:d], params["a"][d:].contiguous()
    batch = scale.draw_batch(np.random.default_rng(cfg.seed), src, dst,
                             SCALE_NODES, cfg.batch_edges, DEVICE)
    gouts = None
    for precision in ("f32", "bf16"):
        op = ChunkedRank1Gat(src, dst, n_src=SCALE_NODES, n_dst=SCALE_NODES,
                             num_slices=k, negative_slope=cfg.negative_slope,
                             assume_sorted=True, precision=precision,
                             device=DEVICE)
        if gouts is None:
            # the port's loss's cotangent of the layer's output
            leaf = op(c, a_dst, h).detach().requires_grad_()
            loss = scale._make_loss(None, None, SCALE_NODES, None, cfg,
                                    attention_fn=lambda *_: leaf)(
                params, *batch)
            (g_loss,) = torch.autograd.grad(loss, leaf)
            gouts = {"loss cotangent": g_loss.contiguous(),
                     "dense cotangent": torch.randn(
                         h.shape, device=DEVICE, generator=torch.Generator(
                             device=DEVICE).manual_seed(cfg.seed + 1))}
            del leaf, loss, g_loss
        x16 = h.to(torch.bfloat16) if precision == "bf16" else h
        hold_rank1_slices(op, c, a_dst, x16, gouts, op._seed)
        op = x16 = None
        gc_cuda()
    hold_spmm_slices(src, dst, k, cfg, h, c, a_dst, gouts)
    gc_cuda()
    log(f"  {k} slices against float64 plain versions: "
        f"{time.perf_counter() - t0:.1f} s")


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_out_of_core():
    """Phase 14: single-card out-of-core training (``train_chunked``) at
    the repo's own size, on edges put in (sender, receiver) order once
    (phase 18b's ``train_distributed`` draws its batches from that order,
    so the two drivers' losses agree), fused f32 and bf16 and
    materialised; the 12-slice step against a 1-slice one, every slice's
    kernels and the layers' gradients against float64 plain versions, the
    modes against each other, and a cut graph against the CPU.  Returns
    the launches of the materialised run's broadcast kernels (its main
    path)."""
    import dataclasses

    from msha_gnn_torch.training import scale

    t0 = time.perf_counter()
    src, dst = build_edges(SCALE_NODES, SCALE_EDGES, seed=0)
    hub = float((dst == 0).mean())
    log(f"  graph: {SCALE_NODES} nodes, {SCALE_EDGES} edges (build_edges of "
        f"scripts_scale_train.py, seed 0) in {time.perf_counter() - t0:.1f} "
        f"s; receiver 0 takes {hub:.3f} of the edges")
    t0 = time.perf_counter()
    src, dst = scale.sort_edges(src, dst, SCALE_NODES)
    log(f"  edges put in (sender, receiver) order on the host (sort_edges, "
        f"for phases 14 and 18b): {time.perf_counter() - t0:.2f} s")
    base = scale.ScaleConfig(steps=SCALE_STEPS)
    k = scale.num_slices_for(SCALE_EDGES, base.d)
    log(f"  ScaleConfig(): d {base.d}, batch {base.batch_edges}, lr "
        f"{base.lr}, seed {base.seed}; {k} slices from the formula")
    runs, launches = {}, {}
    for label, fused, precision in SCALE_MODES:
        cfg = dataclasses.replace(base, precision=precision)
        events, steps = [], []
        # the last step runs under the profiler, the ones before it are
        # timed bare
        hook = ProfiledStep(label, cfg.steps - 1, lambda ev: (
            events if "event" in ev else steps).append(ev))
        gc_cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        res = scale.train_chunked(src, dst, SCALE_NODES, cfg, fused=fused,
                                  device=DEVICE, log=hook)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {key: v for key, v in scale_want(
            res["num_slices"], fused, precision, cfg.steps).items()
            if key in counts}
        per_step = {key: v / cfg.steps for key, v in counts.items() if v}
        log(f"  {label}: layout {events[0]['seconds']} s ({k} slices); "
            f"train_chunked {wall:.1f} s (the last step profiled); losses "
            f"{[round(x, 6) for x in res['loss_history']]}; steps "
            f"{[round(x['seconds'], 4) for x in steps]} s")
        p50 = statistics.median(x["seconds"] for x in steps[2:-1])
        log(f"  {label}: steady step wall p50 {p50 * 1e3:.1f} ms (steps "
            f"2-{cfg.steps - 2}), {SCALE_EDGES / p50:.4g} edges/s; peak "
            f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; "
            f"launches a step {per_step}")
        if res["num_slices"] != k or counts != want:
            raise AssertionError(f"{label}: expected {want} launches at {k} "
                                 f"slices, got {counts}")
        if not all(np.isfinite(res["loss_history"])):
            raise AssertionError(f"{label}: a loss is not finite")
        runs[label] = dict(res=res, p50=p50, peak=peak, prof=hook.out,
                           layout=events[0]["seconds"], per_step=per_step)
        if not fused:
            launches = {"seg_expand_f32": counts["seg_expand_f32"],
                        "seg_reduce_f32[rowsum d=1]":
                            counts["seg_reduce_f32"]}
        if label == "fused f32":
            bnds = slice_bounds_ms(src, dst, k, cfg.d)
            log("  a slice's launch, least time (mean over the slices): "
                + ", ".join(f"{name} {t:.5f} ms ({by})"
                            for name, (t, by) in bnds.items()))
            # the 12-slice step against one slice, same parameters and batch
            loss_fn, s, r, _ = scale.build_chunked(
                src, dst, SCALE_NODES, cfg, device=DEVICE)
            params0 = scale_params(cfg)
            batch = scale.draw_batch(np.random.default_rng(cfg.seed), s, r,
                                     SCALE_NODES, cfg.batch_edges, DEVICE)
            loss12, g12 = loss_and_grad(loss_fn, params0, batch)
            loss_fn = None
            one_fn, *_ = scale.build_chunked(src, dst, SCALE_NODES, cfg,
                                             num_slices=1, device=DEVICE)
            loss1, g1 = loss_and_grad(one_fn, params0, batch)
            one_fn = None
            for name, got, want_v in [("loss", loss12, loss1)] + [
                    (f"d{key}", g12[key], g1[key]) for key in g1]:
                close(f"{k} slices vs 1 slice {name}", got, want_v, 0.0,
                      SCALE_SLICE_REL * float(want_v.abs().max()))
    gc_cuda()
    hold_to_plain(src, dst, k, base)
    first = {label: v["res"]["first_loss"] for label, v in runs.items()}
    gap = abs(first["fused f32"] - first["materialised f32"])
    log(f"  fused vs materialised first loss: {first['fused f32']:.7f} / "
        f"{first['materialised f32']:.7f}, |diff| {gap:.2e} (bound "
        f"{SCALE_PATHS_TOL})")
    if gap > SCALE_PATHS_TOL:
        raise AssertionError("fused and materialised first losses differ")
    f32 = np.array(runs["fused f32"]["res"]["loss_history"])
    b16 = np.array(runs["fused bf16"]["res"]["loss_history"])
    rel = float(np.max(np.abs(b16 - f32) / np.abs(f32)))
    log(f"  bf16 vs f32 losses: max rel diff {rel:.2e} (bound "
        f"{SCALE_BF16_REL})")
    if rel > SCALE_BF16_REL:
        raise AssertionError("the bf16 losses leave the f32 ones")

    # the cut graph, card against the CPU from the same parameters and
    # batches (train_chunked draws both from its seed)
    src_c, dst_c = build_edges(SCALE_CUT_NODES, SCALE_CUT_EDGES, seed=0)
    for label, fused, precision in SCALE_MODES:
        cfg = dataclasses.replace(base, precision=precision,
                                  steps=SCALE_CUT_STEPS)
        got, want_c = (scale.train_chunked(
            src_c, dst_c, SCALE_CUT_NODES, cfg, num_slices=k, fused=fused,
            device=dev)["loss_history"] for dev in (DEVICE, "cpu"))
        rel = float(np.max(np.abs(np.array(got) - want_c)
                           / np.abs(want_c)))
        log(f"  cut graph ({SCALE_CUT_NODES} nodes, {SCALE_CUT_EDGES} edges, "
            f"{k} slices) {label}, card vs CPU losses: {got} / {want_c}; "
            f"max rel diff {rel:.2e} (bound {SCALE_CARD_CPU_RTOL})")
        if rel > SCALE_CARD_CPU_RTOL:
            raise AssertionError(f"cut graph {label}: card and CPU differ")
        if precision != "f32":
            continue
        # the first step's gradients (bf16 rows of an h whose last bits
        # differ between the devices could round apart: the bf16 kernels
        # are held above on the same rows)
        grads = {}
        for dev in (DEVICE, "cpu"):
            loss_fn, s_c, r_c, _ = scale.build_chunked(
                src_c, dst_c, SCALE_CUT_NODES, cfg, num_slices=k,
                fused=fused, device=dev)
            batch = scale.draw_batch(np.random.default_rng(cfg.seed), s_c,
                                     r_c, SCALE_CUT_NODES, cfg.batch_edges,
                                     dev)
            grads[dev] = loss_and_grad(
                loss_fn, scale_params(cfg, SCALE_CUT_NODES, dev), batch)
        (loss_g, g_g), (loss_c, g_c) = grads[DEVICE], grads["cpu"]
        for name, got_v, want_v in [("loss", loss_g, loss_c)] + [
                (f"d{key}", g_g[key], g_c[key]) for key in g_c]:
            close(f"cut graph {label}, card vs CPU first step {name}",
                  got_v.cpu(), want_v, SUM_RTOL,
                  SUM_ATOL_REL * float(want_v.abs().max()))
    summary = {label: {key: v[key] for key in ("p50", "peak", "layout",
                                                "per_step", "prof")}
               for label, v in runs.items()}
    log(f"  out-of-core summary: {json.dumps(summary)}")
    return launches, {"edges": (src, dst), "losses": {
        label: v["res"]["loss_history"] for label, v in runs.items()}}


def profile_calls(name, fn, calls):
    """``torch.profiler`` over ``calls`` calls of ``fn`` (each a training
    step), each ended by a synchronise: device kernels and device ms a
    call, the idle share of their wall, the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    def us(evt):
        return (getattr(evt, "self_device_time_total", 0.0)
                or getattr(evt, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [evt for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False)]
    busy_ms = sum(us(evt) for evt in on_card) / 1e3
    out = {"device_kernels_per_step": sum(e.count for e in on_card) / calls,
           "device_ms_per_step": busy_ms / calls if busy_ms else None,
           "device_idle_share": (max(0.0, 1 - busy_ms / wall_ms)
                                 if busy_ms else None),
           "profiled_wall_ms_per_step": wall_ms / calls}
    log(f"  {name}, {calls} profiled steps: {json.dumps(out)}")
    for evt in sorted(on_card, key=lambda e: -us(e))[:5]:
        short = evt.key.replace("void ", "").replace(
            "at::native::", "").replace("(anonymous namespace)::", "")
        log(f"    {name} device: {us(evt) / 1e3 / calls:.4f} ms, "
            f"{evt.count / calls} a step: {short[:140]}")
    return out


def timed_epoch_data(run):
    """``link_prediction.epoch_data(run)`` with its pieces timed where the
    run calls them (ms): the sampler (``from_coo`` included), ``from_coo``
    alone, the operators' build from the host arrays, the batches' draw
    and copy; the rest is the subgraph's copy to the card."""
    from msha_gnn_torch import graph as tgraph
    from msha_gnn_torch.training import link_prediction as lp

    times = {}

    def timed(key, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[key] = times.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    saved = (lp.neighbor_sample_subgraph, lp.prepare_operators,
             lp.epoch_batches, tgraph.BipartiteGraph.from_coo)
    lp.neighbor_sample_subgraph = timed("sample", saved[0])
    lp.prepare_operators = timed("operator build", saved[1])
    lp.epoch_batches = timed("batches", saved[2])
    tgraph.BipartiteGraph.from_coo = staticmethod(timed("from_coo", saved[3]))
    try:
        t0 = time.perf_counter()
        graph, batches = lp.epoch_data(run)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        (lp.neighbor_sample_subgraph, lp.prepare_operators,
         lp.epoch_batches) = saved[:3]
        tgraph.BipartiteGraph.from_coo = staticmethod(saved[3])
    times["copy to the card"] = (total - times["sample"]
                                 - times["operator build"] - times["batches"])
    times["total"] = total
    return graph, batches, times


def sampled_kernels(graph):
    """Phase 15a: the three kernels of the sampled fused step on the
    epoch's subgraph, at the path's shapes (d 64, rate 0.5), against their
    plain versions: ``r1l_fwd_f32``, ``r1l_bwd_f32`` and the dx reduce
    (``csr_spmm_f32``, ``q``-weighted and the d = 1 column sum of
    ``dpre``); times, bounds, library; their kernels-line entries."""
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda.spmm import operator_for

    spmm = operator_for(graph)
    n, e, d = graph.n_src, graph.num_edges, LP_D
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    c = torch.randn(n, generator=gen, device=DEVICE)
    a = torch.randn(d, generator=gen, device=DEVICE) * 0.3
    x = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=DEVICE)
    slope, rate = 0.2, 0.5
    (fwd_b, fwd_by), (bwd_b, bwd_by) = r1l_bounds(n, e, d)
    fwd_args = (spmm.ptr, spmm.col, c, a, x, seed, rate, slope, n)
    prime_nan((n, d), (n,))
    out, lse = r1.r1l_fwd(*fwd_args)
    w_out, w_lse = r1.rank1_gat_plain(*fwd_args)
    torch.cuda.synchronize()
    fwd_err = max(close("r1l_fwd_f32[sampled] out", out, w_out, KERNEL_RTOL,
                        KERNEL_ATOL),
                  close("r1l_fwd_f32[sampled] lse", lse, w_lse, KERNEL_RTOL,
                        KERNEL_ATOL))
    bwd_args = (spmm.ptr, spmm.col, c, a, x, gout, w_out, w_lse, seed, rate,
                slope, n)
    q, dpre, dc, da = r1.r1l_bwd(*bwd_args)
    wq, wdpre, wdc, wda = r1.rank1_gat_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    bwd_err = max(
        close("r1l_bwd_f32[sampled] q", q, wq, KERNEL_RTOL, KERNEL_ATOL),
        *(close(f"r1l_bwd_f32[sampled] {name}", got, want, SUM_RTOL,
                SUM_ATOL_REL * float(want.abs().max()))
          for name, got, want in (("dpre", dpre, wdpre), ("dc", dc, wdc),
                                  ("da", da, wda))))
    results = []
    for name, kernel, plain, err, (bnd, by), src_line in (
            ("r1l_fwd_f32[sampled, rate 0.5]",
             lambda: r1.r1l_fwd(*fwd_args),
             lambda: r1.rank1_gat_plain(*fwd_args), fwd_err, (fwd_b, fwd_by),
             "msha_gnn_tpu/ops/pallas/rank1_gat.py:234 _r1l_fwd_kernel"),
            ("r1l_bwd_f32[sampled, rate 0.5]",
             lambda: r1.r1l_bwd(*bwd_args),
             lambda: r1.rank1_gat_bwd_plain(*bwd_args), bwd_err,
             (bwd_b, bwd_by),
             "msha_gnn_tpu/ops/pallas/rank1_gat.py:305 _r1l_bwd_kernel")):
        same_bits(name, kernel)
        ms, dev_ms = time_ms(kernel), device_ms(kernel)
        plain_ms = time_ms(plain, reps=5, iters=5)
        log(f"  {name}: {e} edges: kernel {ms:.4f} ms (device "
            f"{fmt(dev_ms)}), plain {plain_ms:.4f} ms, bound {bnd:.5f} ms "
            f"({by}); library none: no PyTorch call computes the row "
            "softmax, the hashed dropout and the aggregation together")
        results.append({**entry(name, "rank1_gat.cu", src_line, err, ms,
                                plain_ms, (bnd, by), None),
                        "device_ms": dev_ms, "library_device_ms": None})
    w_t = spmm.weights(q, True)
    dcol = dpre[:, None].contiguous()
    rcv = graph.receivers[:e].long()
    a_csr = torch.sparse_csr_tensor(spmm.t_ptr, spmm.t_col, w_t, size=(n, n))
    results.append(spmm_use(
        "sampled r1l dx q A^T g", (spmm.t_ptr, spmm.t_col, w_t, gout, n),
        lambda: torch.sparse.mm(a_csr, gout), "torch.sparse.mm"))
    results.append(spmm_use(
        "sampled r1l dpre column sum",
        (spmm.t_ptr, spmm.t_edge, None, dcol, n),
        lambda: dcol.new_zeros((n, 1)).index_add_(0, rcv, dcol),
        "index_add_"))
    return results


def phase_sampled_linkpred(split):
    """Phase 15a: ``LinkPredConfig(neighbor_fanout=16)`` on the linkpred
    data, 2 epochs (cut from 10), ``impl="auto"`` -> ``"fused"``, each
    epoch on a subgraph drawn on the host.  Per epoch: the draw's pieces
    (ms), the subgraph's edges, the step wall p50 and one profiled step,
    peak memory; the subgraph and the batches bit-equal to a CPU run's
    draws and to a plain (``impl="torch"``) run's on the card; the first
    subgraph's kernels against their plain versions (``sampled_kernels``,
    before the counts go to 0); the first step's launches exactly the
    fused step's, its loss and gradients against the plain step from the
    same state; every step's loss against the plain run's at
    ``EPOCH_LOSS_RTOL``.  Returns the kernel entries with their launches
    on this main path."""
    import dataclasses

    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.training import (LinkPredConfig,
                                         build_link_prediction, evaluate)
    from msha_gnn_torch.training import link_prediction as lp

    cfg = LinkPredConfig(neighbor_fanout=SAMPLED_FANOUT,
                         epochs=SAMPLED_EPOCHS)
    run = build_link_prediction(split, cfg, device=DEVICE)
    if run.impl != "fused":
        raise AssertionError(f"impl auto resolved to {run.impl} on CUDA")
    plain = build_link_prediction(split, dataclasses.replace(
        cfg, impl="torch"), device=DEVICE)
    on_cpu = build_link_prediction(split, dataclasses.replace(
        cfg, impl="torch"), device="cpu")
    log(f"  LinkPredConfig(neighbor_fanout={SAMPLED_FANOUT}): hidden "
        f"{cfg.hidden}, {cfg.n_heads} heads, batch {cfg.batch_size}, "
        f"{cfg.epochs} epochs; full graph {run.graph.num_edges} edges")
    entries = None
    fused_losses, plain_losses, alloc = [], [], []
    op_counts = {"csr_spmm_f32 transposed": 0,
                 "csr_spmm_f32 reduce_edges": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for epoch in range(cfg.epochs):
        t_ep = time.perf_counter()
        graph, batches, times = timed_epoch_data(run)
        g_plain, b_plain = lp.epoch_data(plain)
        g_cpu, b_cpu = lp.epoch_data(on_cpu)
        for name in ("senders", "receivers", "weight", "row_ptr"):
            ref = getattr(g_cpu, name)
            if not (torch.equal(getattr(graph, name).cpu(), ref)
                    and torch.equal(getattr(g_plain, name).cpu(), ref)):
                raise AssertionError(f"epoch {epoch}: the subgraph's {name} "
                                     "differs from the CPU draw")
        if not (torch.equal(batches.cpu(), b_cpu)
                and torch.equal(b_plain, batches)):
            raise AssertionError(f"epoch {epoch}: the batches differ from "
                                 "the CPU draw")
        e = graph.num_edges
        log(f"  epoch {epoch}: subgraph {e} edges ({e / run.graph.num_edges:.3f}"
            f" of the graph, {graph.num_padded_edges} slots), bit-equal to "
            f"the CPU draw and the plain run's, batches too; the draw: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items()))
        op = cuda_spmm.operator_for(graph)
        if epoch == 0:
            entries = sampled_kernels(graph)
            # the main path: counts to 0 just before its first step
            zero_counts()
        step_ms = []
        for i, batch in enumerate(batches):
            if epoch == 0 and i == 0:
                before = read_counts(op)
                state = run.generator.get_state()
                model0 = copy.deepcopy(run.model)
                loss = float(lp.train_step(run, batch, graph))
                torch.cuda.synchronize()
                after = read_counts(op)
                delta = {k: after[k] - before[k] for k in after}
                log(f"  one sampled fused step's launches: {delta}")
                if delta != STEP_WANT["fused"]:
                    raise AssertionError(f"expected {STEP_WANT['fused']}, "
                                         f"got {delta}")
                got = (loss, {k: p.grad.detach().clone()
                              for k, p in run.model.named_parameters()})
                gen = torch.Generator(device=DEVICE)
                want = loss_and_grads(model0, graph, batch, "torch", gen,
                                      state)
                if read_counts(op) != after:
                    raise AssertionError("the plain step launched a kernel")
                compare_steps("sampled fused step vs the plain step (impl "
                              "torch, the same subgraph and state)", got,
                              want, STEP_LOSS_RTOL, STEP_GRAD_RTOL,
                              STEP_GRAD_ATOL_REL)
            elif i == SAMPLED_PROFILED_STEP:
                holder = []
                profile_calls(f"epoch {epoch} sampled fused step",
                              lambda b=batch: holder.append(float(
                                  lp.train_step(run, b, graph))), 1)
                loss = holder[0]
            else:
                t0 = time.perf_counter()
                loss = float(lp.train_step(run, batch, graph))
                step_ms.append((time.perf_counter() - t0) * 1e3)
            fused_losses.append(loss)
        for batch in b_plain:
            plain_losses.append(float(lp.train_step(plain, batch, g_plain)))
        counts = read_counts(op)
        for k in op_counts:
            op_counts[k] += counts[k]
        lp.end_epoch(run, graph)
        lp.end_epoch(plain, g_plain)
        graph = g_plain = op = None
        torch.cuda.synchronize()
        alloc.append(torch.cuda.memory_allocated())
        log(f"  epoch {epoch}: {len(batches)} steps, step wall p50 "
            f"{statistics.median(step_ms):.3f} ms (steps but the first and "
            f"the profiled one), epoch wall {time.perf_counter() - t_ep:.2f} "
            f"s (the plain run's epoch and the checks included); memory "
            f"allocated {alloc[-1] / 2**20:.1f} MiB, peak "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; cached "
            f"operators {len(cuda_spmm._OPS)}")
    totals = read_counts()
    if alloc[-1] > alloc[0] + 16 * 2**20:
        raise AssertionError(f"memory grew across epochs: {alloc}")
    # each step of the first epoch, as phases 6 and 7 hold theirs, and
    # each epoch's mean loss (the run's logged loss); the same function
    # from the same state, float32 sums in another order through Adam
    # steps, so the drift grows with the steps
    first = len(fused_losses) // cfg.epochs
    errs = [abs(a - b) / abs(b) for a, b in zip(fused_losses[:first],
                                                plain_losses[:first])]
    means = [(statistics.mean(fused_losses[i * first:(i + 1) * first]),
              statistics.mean(plain_losses[i * first:(i + 1) * first]))
             for i in range(cfg.epochs)]
    mean_err = max(abs(a - b) / abs(b) for a, b in means)
    last = max(abs(a - b) / abs(b) for a, b in zip(fused_losses[first:],
                                                   plain_losses[first:]))
    log(f"  fused vs the plain run: epoch 0's {first} step losses max rel "
        f"err {max(errs):.2e}; the epochs' mean losses "
        + ", ".join(f"{a:.6f} / {b:.6f}" for a, b in means)
        + f", max rel err {mean_err:.2e} (both rtol {EPOCH_LOSS_RTOL}); "
        f"epoch 1's steps, for the record, max rel err {last:.2e}; "
        f"first-5 mean {statistics.mean(fused_losses[:5]):.5f}, last-5 mean "
        f"{statistics.mean(fused_losses[-5:]):.5f}")
    if len(plain_losses) != len(fused_losses) or max(errs) > EPOCH_LOSS_RTOL \
            or mean_err > EPOCH_LOSS_RTOL:
        raise AssertionError("the sampled fused epochs leave the plain run")
    if not all(np.isfinite(fused_losses)):
        raise AssertionError("a sampled step's loss is not finite")
    t0 = time.perf_counter()
    metrics = evaluate(run)
    log(f"  evaluation on the full graph ({time.perf_counter() - t0:.2f} s): "
        f"{json.dumps(metrics)}")
    launches = {
        "r1l_fwd_f32[sampled, rate 0.5]": totals["r1l_fwd_f32"],
        "r1l_bwd_f32[sampled, rate 0.5]": totals["r1l_bwd_f32"],
        "csr_spmm_f32[sampled r1l dx q A^T g]":
            (op_counts["csr_spmm_f32 transposed"]
             - op_counts["csr_spmm_f32 reduce_edges"]),
        "csr_spmm_f32[sampled r1l dpre column sum]":
            op_counts["csr_spmm_f32 reduce_edges"]}
    log(f"  main path launches over {len(fused_losses)} steps: {launches}")
    for k in entries:
        k["launches"] = launches[k["name"]]
    return entries


def phase_sampled_kd(split):
    """Phase 15b: ``use_kd=True`` on a sampled subgraph at full width: one
    fused step's exact launches (the student adds none), its loss parts
    and gradients (the student's too) against the plain step from the same
    state."""
    from msha_gnn_torch.ops.cuda.spmm import operator_for
    from msha_gnn_torch.training import (LinkPredConfig,
                                         build_link_prediction,
                                         linkpred_loss_parts)
    from msha_gnn_torch.training import link_prediction as lp

    run = build_link_prediction(split, LinkPredConfig(
        neighbor_fanout=SAMPLED_FANOUT, use_kd=True), device=DEVICE)
    graph, batches = lp.epoch_data(run)
    op = operator_for(graph)
    model0 = copy.deepcopy(run.model)
    state = run.generator.get_state()
    before = read_counts(op)
    parts = lp.step_parts(run, batches[0], graph)
    torch.cuda.synchronize()
    after = read_counts(op)
    delta = {k: after[k] - before[k] for k in after}
    if delta != STEP_WANT["fused"]:
        raise AssertionError(f"KD step: expected {STEP_WANT['fused']}, got "
                             f"{delta}")
    got_parts = {k: float(v) for k, v in parts.items()}
    got = (got_parts["loss"], {k: p.grad.detach().clone()
                               for k, p in run.model.named_parameters()})
    gen = torch.Generator(device=DEVICE)
    gen.set_state(state)
    total, want_parts = linkpred_loss_parts(model0, graph, batches[0],
                                            impl="torch", generator=gen)
    total.backward()
    want = (total.item(), {k: p.grad.detach().clone()
                           for k, p in model0.named_parameters()})
    want_parts = {k: v.item() for k, v in want_parts.items()}
    log(f"  KD step ({graph.num_edges} edges): launches as the fused step; "
        "parts " + ", ".join(f"{k} {got_parts[k]:.7f} (plain {v:.7f})"
                             for k, v in want_parts.items()))
    for k, v in want_parts.items():
        if abs(got_parts[k] - v) > STEP_LOSS_RTOL * abs(v):
            raise AssertionError(f"KD step: {k} vs the plain step")
    if not any(k.startswith("student.") for k in got[1]):
        raise AssertionError("the KD model has no student")
    compare_steps("KD sampled fused step vs the plain step", got, want,
                  STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL_REL)
    lp.end_epoch(run, graph)


def phase_llp(fg):
    """Phase 15c: ``run_llp`` at ``LLPConfig()`` (hidden 32 = M, 2 teacher
    heads, batch 4096) on the phase-3 graph, 2 epochs (cut from 10),
    with 4,096 'nb' sampled anchors an epoch and with the margin-rank
    term; the step's wall, kernels and idle share; at dropout 0, the
    teacher's embedding and the first ``CARD_CPU_STEPS`` losses on the
    card against the CPU."""
    from msha_gnn_torch.training import kd
    from msha_gnn_torch.utils import LLPConfig

    for label, cfg in (("ps nb", LLPConfig(epochs=LLP_EPOCHS,
                                           ps_samples=4096, ps_method="nb")),
                       ("kd_rank", LLPConfig(epochs=LLP_EPOCHS,
                                             kd_rank=0.1))):
        logs = []
        t0 = time.perf_counter()
        result = kd.run_llp(cfg, log=logs.append, fg=fg, device=DEVICE)
        wall = time.perf_counter() - t0
        epochs = [r for r in logs if r["event"] == "llp_train_epoch"]
        log(f"  run_llp ({label}): {wall:.2f} s; epochs "
            + "; ".join(f"{r['seconds']:.3f} s, loss {r['loss']:.5f}"
                        for r in epochs) + f"; {json.dumps(result)}")
        if len(epochs) != LLP_EPOCHS or not all(
                np.isfinite(v) for v in result.values()):
            raise AssertionError(f"run_llp ({label}): {result}")
        if label == "kd_rank" and not all("kd_rank" in r for r in epochs):
            raise AssertionError("run_llp: no kd_rank part")

    run = kd.build_llp(LLPConfig(ps_samples=4096), fg, DEVICE)
    idx, wl = kd.epoch_tensors(run)
    log(f"  an LLP epoch: {idx.shape[0]} steps of {idx.shape[2]} pairs")
    for i in range(3):
        kd.llp_step(run, idx[i], wl[i])
    walls = []
    for i in range(3, 23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kd.llp_step(run, idx[i], wl[i])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"  LLP step wall p50 {statistics.median(walls):.3f} ms (20 steps)")
    later = iter(range(23, 33))

    def one_step():
        i = next(later)
        kd.llp_step(run, idx[i], wl[i])

    profile_calls("LLP step", one_step, 10)

    cfg0 = LLPConfig(ps_samples=4096, dropout=0.0)
    card, cpu = kd.build_llp(cfg0, fg, DEVICE), kd.build_llp(cfg0, fg, "cpu")
    close("LLP teacher embedding [N, M] (log-softmax), card vs CPU",
          card.t_h.cpu(), cpu.t_h, MSHA_RTOL, MSHA_ATOL)
    (idx_c, wl_c), (idx_p, wl_p) = kd.epoch_tensors(card), \
        kd.epoch_tensors(cpu)
    if not (torch.equal(idx_c.cpu(), idx_p) and torch.equal(wl_c.cpu(), wl_p)):
        raise AssertionError("LLP: the epoch's arrays differ card vs CPU")
    losses_c, losses_p = [], []
    for i in range(CARD_CPU_STEPS):
        losses_c.append(float(kd.llp_step(card, idx_c[i], wl_c[i])[0]))
        losses_p.append(float(kd.llp_step(cpu, idx_p[i], wl_p[i])[0]))
    log(f"  LLP at dropout 0, {CARD_CPU_STEPS} steps: card {losses_c[0]:.7f} "
        f".. {losses_c[-1]:.7f}, max rel err vs CPU "
        f"{max(abs(a - b) / abs(b) for a, b in zip(losses_c, losses_p)):.2e} "
        f"(rtol {TRAIN_LOSS_RTOL}, atol {TRAIN_LOSS_ATOL})")
    np.testing.assert_allclose(losses_c, losses_p, rtol=TRAIN_LOSS_RTOL,
                               atol=TRAIN_LOSS_ATOL, err_msg="LLP steps")


def phase_sgae(fg):
    """Phase 15d: ``run_sgae`` at ``SGAEConfig(pretrain_epochs=1,
    epochs=1)`` on the phase-3 graph and the temporal pretrain over it and
    a second synthetic year; the pretrain losses (no dropout) and the
    fine-tune's first ``CARD_CPU_STEPS`` losses on the card against the
    CPU; the walls."""
    from msha_gnn_torch.data import synthetic_flow, train_test_split_records
    from msha_gnn_torch.training import (Trainer, TrainState,
                                         make_train_step, sage_task, sgae)
    from msha_gnn_torch.utils import SGAEConfig

    cfg = SGAEConfig(pretrain_epochs=1, epochs=1)
    logs = []
    t0 = time.perf_counter()
    result = sgae.run_sgae(cfg, log=logs.append, fg=fg, device=DEVICE)
    wall = time.perf_counter() - t0
    pre = [r for r in logs if r["event"] == "sgae_pretrain"]
    fit = [r for r in logs if r["event"] == "train_epoch"]
    log(f"  run_sgae: {wall:.2f} s (pretrain {pre[0]['seconds']:.3f} s, "
        f"fine-tune epoch {fit[0]['seconds']:.3f} s); {json.dumps(result)}")
    if not np.isfinite(result["finetune"]["train_loss"]):
        raise AssertionError(f"run_sgae: {result}")

    fg2 = synthetic_flow(20000, M, 150, N_PROV, 100000, seed=1)
    walls, hist = {}, {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        z_src, _, h1 = sgae.pretrain_autoencoder(
            fg, dim=cfg.in_features, epochs=2, lr=cfg.lr, seed=cfg.seed,
            device=dev)
        t1 = time.perf_counter()
        _, _, h2 = sgae.pretrain_autoencoder_temporal(
            {"2015": fg, "2016": fg2}, dim=cfg.in_features, epochs=1,
            lr=cfg.lr, seed=cfg.seed, device=dev)
        walls[dev] = (t1 - t0, time.perf_counter() - t1)
        hist[dev] = (h1, h2, z_src)
    log(f"  pretrain (2 epochs) {walls[DEVICE][0]:.2f} s, temporal pretrain "
        f"(2015 and a 100,000-record year, 1 epoch) {walls[DEVICE][1]:.2f} "
        f"s on the card ({walls['cpu'][0]:.2f} / {walls['cpu'][1]:.2f} s on "
        f"the CPU); losses card {hist[DEVICE][0]} / {hist[DEVICE][1]}, CPU "
        f"{hist['cpu'][0]} / {hist['cpu'][1]}")
    np.testing.assert_allclose(hist[DEVICE][0], hist["cpu"][0],
                               rtol=TRAIN_LOSS_RTOL, atol=TRAIN_LOSS_ATOL)
    for y, h in hist["cpu"][1].items():
        np.testing.assert_allclose(hist[DEVICE][1][y], h,
                                   rtol=TRAIN_LOSS_RTOL, atol=TRAIN_LOSS_ATOL)

    # the fine-tune from the card's embeddings, card vs CPU in lockstep
    z = hist[DEVICE][2]
    states, steps = {}, {}
    for dev in (DEVICE, "cpu"):
        task, model = sage_task(fg, in_features=cfg.in_features,
                                dropout=cfg.dropout, lr=cfg.lr,
                                weight_decay=cfg.weight_decay, seed=cfg.seed,
                                device=dev)
        with torch.no_grad():
            model.Sfeatures.copy_(z.to(dev))
        states[dev] = TrainState.create(model, task.optimizer)
        steps[dev] = make_train_step(task)
        trainer = Trainer(task=task, src=fg.edge_src.numpy(),
                          labels=fg.edge_dst.numpy(),
                          batch_size=cfg.batch_size, seed=cfg.seed)
    train_ids, _ = train_test_split_records(fg.num_records, 0.9, cfg.seed)
    batches = stacked_batches(trainer, train_ids, cfg.seed)[:CARD_CPU_STEPS]
    card = [float(steps[DEVICE](states[DEVICE], *b)) for b in batches]
    cpu = [float(steps["cpu"](states["cpu"], *(x.cpu() for x in b)))
           for b in batches]
    log(f"  SGAE fine-tune, {len(card)} steps: card {card[0]:.7f} .. "
        f"{card[-1]:.7f}, max rel err vs CPU "
        f"{max(abs(a - b) / abs(b) for a, b in zip(card, cpu)):.2e}")
    np.testing.assert_allclose(card, cpu, rtol=TRAIN_LOSS_RTOL,
                               atol=TRAIN_LOSS_ATOL, err_msg="SGAE fine-tune")


# ---------------------------------------------------------------------------
# Phase 16: the raw-data pipeline, joint multi-year training, attention
# explanation, scorer export and the NaN guard
# ---------------------------------------------------------------------------

def raw_records(seed, n_records, provinces):
    """``n_records`` synthetic raw records drawn from ``RAW_POOL`` node
    identities (a county each, with a home province, a city, a gender, a
    major from the shipped override table and a family status); the
    school province follows the home province, as ``synthetic_flow``'s
    recipient does.  Returns the records and a county -> GDP table in
    which every 50th county is missing (the pipeline's fallback)."""
    from msha_gnn_torch.data.raw import RawRecord, load_major_table

    rng = np.random.default_rng(seed)
    majors = sorted(load_major_table())
    home = rng.integers(0, N_PROV, RAW_POOL)
    city = home * 10 + rng.integers(0, 10, RAW_POOL)
    major = rng.integers(0, len(majors), RAW_POOL)
    gender = rng.integers(0, 2, RAW_POOL)
    family = rng.integers(0, 3, RAW_POOL)
    node = rng.integers(0, RAW_POOL, n_records)
    school = (home[node] + rng.integers(0, 3, n_records)) % len(provinces)
    records = [RawRecord(f"H{home[i]}", f"C{city[i]}", f"K{i}",
                         "FM"[gender[i]], majors[major[i]],
                         "abc"[family[i]], provinces[s])
               for i, s in zip(node.tolist(), school.tolist())]
    gdp = {f"K{i}": float(v) for i, v in
           enumerate(rng.lognormal(10.0, 1.0, RAW_POOL)) if i % 50}
    return records, gdp


def phase_raw_dataset(td):
    """Phase 16a: 2015 and 2016 at the 2015 data's shape and a 2017
    without flow records, through ``anonymize`` and
    ``write_anonymous_dataset`` into ``td/data``, loaded back with
    ``load_flow_graph``; then ``td/train``, the same files with each
    year's flows cut to the first ``TEMPORAL_RECORDS``.  Returns the two
    directories."""
    import shutil

    from msha_gnn_torch.data import load_flow_graph, load_index_match
    from msha_gnn_torch.data.raw import (anonymize, derive_prefix_table,
                                         load_major_table,
                                         write_anonymous_dataset)

    data_dir, train_dir = os.path.join(td, "data"), os.path.join(td, "train")
    overrides = load_major_table()
    table = derive_prefix_table(overrides)
    provinces = [f"P{j:02d}" for j in range(M)]
    maps = {}
    for year, seed, n_records in (("2015", 0, RAW_RECORDS),
                                  ("2016", 1, RAW_RECORDS),
                                  ("2017", 2, RAW_RECORDS // 4)):
        t0 = time.perf_counter()
        records, gdp = raw_records(seed, n_records, provinces)
        t1 = time.perf_counter()
        out = anonymize(records, gdp, table, overrides)
        t2 = time.perf_counter()
        write_anonymous_dataset(data_dir, year, out)
        t3 = time.perf_counter()
        if year == "2017":
            os.remove(os.path.join(data_dir, "Flow2017.csv"))
        fg = load_flow_graph(year, data_dir)
        t4 = time.perf_counter()
        _, _, maps[year] = load_index_match(
            os.path.join(data_dir, f"Adjacent{year}.json"))
        log(f"  {year}: {n_records} raw records ({t1 - t0:.2f} s to draw) "
            f"-> anonymize {t2 - t1:.2f} s ({out['flows'].shape[0]} kept, "
            f"{len(out['source_index'])} sources, "
            f"{len(out['recipient_index'])} recipients), write "
            f"{t3 - t2:.2f} s, load_flow_graph {t4 - t3:.2f} s: "
            f"{fg.n_src} x {fg.n_dst}, {fg.num_records} records, "
            f"{fg.inter.num_edges} edges")
        want_records = 0 if year == "2017" else out["flows"].shape[0]
        if fg.n_dst != M or fg.num_records != want_records or \
                not 0.95 * RAW_POOL * (1 if year != "2017" else 0.2) \
                <= fg.n_src <= RAW_POOL or \
                not bool(((fg.gdp >= 0) & (fg.gdp <= 1)).all()):
            raise AssertionError(f"{year}: the loaded graph's shape")
    if maps["2015"] == maps["2016"] or set(maps["2015"]) != set(provinces):
        raise AssertionError("2015 and 2016 should name the same recipients "
                             "in different orders")
    log(f"  recipient order 2015 {list(maps['2015'])[:4]}..., 2016 "
        f"{list(maps['2016'])[:4]}...")
    os.makedirs(train_dir)
    for name in os.listdir(data_dir):
        src = os.path.join(data_dir, name)
        if name.startswith("Flow"):
            with open(src) as f:
                lines = f.readlines()[: TEMPORAL_RECORDS + 1]
            with open(os.path.join(train_dir, name), "w") as f:
                f.writelines(lines)
        else:
            shutil.copy(src, train_dir)
    return data_dir, train_dir


def phase_temporal(train_dir):
    """Phase 16b: ``cli train --years 2015,2016,2017 --epochs 1`` at
    ``TrainConfig()``'s widths on the cut data: the 2017 skip logged, each
    step's loss finite, each year's last 50 below its first 50, every
    other year's table bit-equal before and after each step; no kernel of
    the port (plain PyTorch); then one step's loss and gradients at
    dropout 0 against the CPU (phase 10's bounds) and the step's wall,
    kernels, device time and idle share."""
    import contextlib
    import io

    from msha_gnn_torch import cli
    from msha_gnn_torch.data import load_flow_graph, load_index_match
    from msha_gnn_torch.training import temporal
    from msha_gnn_torch.utils import TrainConfig

    cfg = TrainConfig()
    real = temporal.temporal_step
    losses = {y: [] for y in TEMPORAL_YEARS}
    checked = [0]

    def step_checked(run, year, batch, labels, generator=None):
        others = {y: run.state.model.table(y).detach().clone()
                  for y in run.years if y != year}
        loss = real(run, year, batch, labels, generator)
        for y, before in others.items():
            if not torch.equal(run.state.model.table(y), before):
                raise AssertionError(f"a {year} step moved Sfeatures_{y}")
        checked[0] += len(others)
        losses[year].append(float(loss))
        return loss

    log_path = os.path.join(train_dir, "log.jsonl")
    out = io.StringIO()
    temporal.temporal_step = step_checked
    try:
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train", "--years", ",".join(TEMPORAL_YEARS),
                           "--data_dir", train_dir, "--epochs", "1",
                           "--log_path", log_path])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        temporal.temporal_step = real
    if rc != 0:
        raise AssertionError(f"cli train --years exited {rc}")
    if any(read_counts().values()):
        raise AssertionError(f"the joint run launched a kernel: "
                             f"{read_counts()}")
    with open(log_path) as f:
        events = [json.loads(line) for line in f]
    skipped = [e["year"] for e in events
               if e["event"] == "temporal_skip_year"]
    epoch = [e for e in events if e["event"] == "temporal_epoch"]
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    steps = int(cfg.train_fraction * TEMPORAL_RECORDS) // cfg.batch_size
    log(f"  cli train --years {','.join(TEMPORAL_YEARS)}: exit {rc}, "
        f"{secs:.2f} s (epoch {epoch[0]['seconds']:.2f} s), skipped "
        f"{skipped}, steps {{'2015': {len(losses['2015'])}, '2016': "
        f"{len(losses['2016'])}}}; {checked[0]} frozen tables bit-equal "
        f"across the steps; none of the port's kernels launched; "
        f"{json.dumps(report)}")
    if skipped != ["2017"] or len(epoch) != 1 or set(report) != {"2015",
                                                                 "2016"}:
        raise AssertionError(f"skipped {skipped}, report {report}")
    for y in ("2015", "2016"):
        ls = losses[y]
        first, last = np.mean(ls[:50]), np.mean(ls[-50:])
        log(f"  {y}: {len(ls)} step losses, first 50 mean {first:.5f}, "
            f"last 50 mean {last:.5f}; report train_loss "
            f"{report[y]['train_loss']:.5f}, accuracy "
            f"{report[y]['accuracy']:.4f}, auc {report[y]['auc']:.4f}")
        if len(ls) != steps or not np.isfinite(ls).all() or not last < first:
            raise AssertionError(f"{y}: {len(ls)} steps (want {steps}), "
                                 f"losses {first} -> {last}")
        if not np.isclose(report[y]["train_loss"], np.mean(ls), rtol=1e-5):
            raise AssertionError(f"{y}: train_loss {report[y]['train_loss']}"
                                 f" is not the mean step loss")

    fgs = {y: load_flow_graph(y, train_dir) for y in TEMPORAL_YEARS}
    maps = {y: load_index_match(os.path.join(
        train_dir, f"Adjacent{y}.json"))[2] for y in TEMPORAL_YEARS}
    runs = {dev: temporal.build_temporal(fgs, maps, dropout=0.0, device=dev)
            for dev in (DEVICE, "cpu")}
    runs["cpu"].state.model.load_state_dict(
        {k: v.cpu() for k, v in runs[DEVICE].state.model.state_dict()
         .items()})
    ids = runs["cpu"].splits["2015"][0][:cfg.batch_size]
    got = {}
    for dev, run in runs.items():
        b = torch.from_numpy(run.src["2015"][ids]).to(run.device)
        lab = torch.from_numpy(run.dst["2015"][ids]).to(run.device)
        loss = temporal.temporal_loss(run, "2015", b, lab)
        loss.backward()
        got[dev] = (float(loss.detach()), {n: None if p.grad is None else
                                  p.grad.cpu()
                                  for n, p in run.state.model
                                  .named_parameters()})
    (loss_k, grads_k), (loss_c, grads_c) = got[DEVICE], got["cpu"]
    scale = max(float(g.abs().max()) for g in grads_c.values()
                if g is not None)
    grad_err = max(float((grads_k[n] - g).abs().max()) / scale
                   for n, g in grads_c.items() if g is not None)
    none = sorted(n for n, g in grads_c.items() if g is None)
    log(f"  one 2015 step at dropout 0, card vs CPU: loss {loss_k:.7f} / "
        f"{loss_c:.7f}; gradients max abs err {grad_err:.3e} of the "
        f"largest (bound {TRAIN_GRAD_REL}); no gradient: {none}")
    np.testing.assert_allclose(loss_k, loss_c, rtol=TRAIN_LOSS_RTOL,
                               atol=TRAIN_LOSS_ATOL)
    if grad_err > TRAIN_GRAD_REL or none != [
            "Sfeatures_2016", "Sfeatures_2017"] or any(
            grads_k[n] is not None for n in none):
        raise AssertionError("the temporal step's gradients, card vs CPU")
    del runs

    run = temporal.build_temporal(fgs, maps, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
    perm = np.random.default_rng(0).permutation(run.splits["2015"][0])
    batches = [(torch.from_numpy(run.src["2015"][c]).to(DEVICE),
                torch.from_numpy(run.dst["2015"][c]).to(DEVICE), None)
               for c in perm[: 47 * cfg.batch_size].reshape(47, -1)]

    def step(state, batch, labels, _w, generator):
        return temporal.temporal_step(run, "2015", batch, labels, generator)

    return profile_steps("temporal msha", step, run.state, batches, gen)


def phase_explain(data_dir, td):
    """Phase 16c: ``cli explain --npz_path`` on 2015 (one epoch of MSHA at
    32 / 16 wide, batch 1024, then the record forward over all N rows):
    the card's recorded attention and intra weights against a CPU record
    forward of the same model; every top-K list of the JSON against the
    CPU's attention (each listed index's CPU value equals the CPU's top-K
    value at that rank: ties make the indices themselves unstable across
    two summation orders); dense clique rows rebuilt from the npz."""
    import contextlib
    import io

    from msha_gnn_torch import cli, explain
    from msha_gnn_torch.data import load_index_match

    captured = {}
    real = explain.record_attention

    def capture(model, fg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(model, fg)
        captured.update(model=model, fg=fg,
                        record_s=time.perf_counter() - t0)
        return out

    npz_path = os.path.join(td, "att.npz")
    json_path = os.path.join(td, "explain.json")
    explain.record_attention = capture
    try:
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["explain", "--data_dir", data_dir, "--npz_path",
                           npz_path, "--output", json_path])
        secs = time.perf_counter() - t0
    finally:
        explain.record_attention = real
    if rc != 0 or any(read_counts().values()):
        raise AssertionError(f"cli explain: exit {rc}, {read_counts()}")
    model, fg = captured["model"], captured["fg"]
    record_dev = device_ms(lambda: real(model, fg), iters=5)
    log(f"  cli explain: exit {rc}, {secs:.2f} s; the record forward over "
        f"{fg.n_src} rows {captured['record_s'] * 1e3:.1f} ms (wall, with "
        f"the copies to the host; device {fmt(record_dev)}); none of the "
        f"port's kernels launched")
    npz = np.load(npz_path)
    att_c, cw_c, pw_c = real(copy.deepcopy(model).cpu(), fg)
    for key, want in (("Coeff12_heads", att_c), ("city_w_heads", cw_c),
                      ("province_w_heads", pw_c)):
        close(f"recorded {key} {tuple(want.shape)}, card vs CPU",
              torch.from_numpy(npz[key]), torch.from_numpy(want),
              EXPLAIN_RTOL, EXPLAIN_ATOL)
    t0 = time.perf_counter()
    with open(json_path) as f:
        data = json.load(f)
    _, _, names = load_index_match(os.path.join(data_dir,
                                                "Adjacent2015.json"))
    att = att_c[-1]
    k_src = len(data["InterAttS"]["0"])
    idx = np.asarray([[names[s] for s in data["InterAttS"][str(i)]]
                      for i in range(fg.n_src)])
    want = -np.sort(-att, axis=1)[:, :k_src]
    close(f"InterAttS: CPU attention at the card's top {k_src} of each of "
          f"{fg.n_src} sources vs the CPU's top {k_src}",
          torch.from_numpy(np.take_along_axis(att, idx, axis=1)),
          torch.from_numpy(want), EXPLAIN_RTOL, EXPLAIN_ATOL)
    k_rec = min(EXPLAIN_TOP_K, fg.n_src)
    ridx = np.asarray([data["InterAttR"][n] for n in sorted(
        names, key=names.get)])
    want = -np.sort(-att.T, axis=1)[:, :k_rec]
    close(f"InterAttR: CPU attention at the card's top {k_rec} sources of "
          f"each of {fg.n_dst} recipients vs the CPU's",
          torch.from_numpy(np.take_along_axis(att.T, ridx, axis=1)),
          torch.from_numpy(want), EXPLAIN_RTOL, EXPLAIN_ATOL)
    if data["InterAttS"] != data["InterAttS_heads"][-1] or \
            len(data["InterAttS_heads"]) != 2 or ridx.shape[1] != k_rec:
        raise AssertionError("explain.json: heads or list lengths")
    gid = npz["city_gid"]
    for i in (0, fg.n_src // 2, fg.n_src - 1):
        row = explain.reconstruct_intra_row(npz, "city", i)
        if not (np.array_equal(np.flatnonzero(row),
                               np.flatnonzero(gid == gid[i]))
                and np.all(row[row != 0] == npz["city_w_heads"][-1][i])):
            raise AssertionError(f"reconstruct_intra_row({i})")
    log(f"  explain.json ({os.path.getsize(json_path) / 2**20:.1f} MiB) "
        f"read and checked in {time.perf_counter() - t0:.2f} s; clique rows "
        f"rebuilt from the npz")


class SpmmRows(TorchDispatchMode):
    """Records the ``n_rows`` of each call of the registered operator
    ``msha_gnn_torch::csr_spmm`` (an exported program calls the kernel
    through it): ``n_dst`` for gc1's ``A^T x``, ``n_src`` for gc2's
    ``A x``."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ == "csr_spmm":
            self.rows.append(args[4])
        return func(*args, **(kwargs or {}))


def phase_export(data_dir, td):
    """Phase 16d: ``cli export`` of a GCN checkpoint (``cli train --model
    gcn``, 1 epoch) as a portable table and of a full MSHA checkpoint (64
    steps at ``TrainConfig()``) as batches of ``PREDICT_BATCH``; each
    loaded afresh from its file and held to the live ``Predictor`` on
    ``EXPORT_IDS`` ids.  One exported GCN table call launches exactly one
    transposed (gc1) and one plain (gc2) ``csr_spmm_f32``; the portable
    table loaded on the CPU launches none.  Returns the launches of that
    call by layer, from the rows of its operator calls."""
    import contextlib
    import dataclasses
    import io

    from msha_gnn_torch import cli
    from msha_gnn_torch.cli import _build_task
    from msha_gnn_torch.data import load_flow_graph, train_test_split_records
    from msha_gnn_torch.export import load_scorer
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.ops.cuda.spmm import operator_for
    from msha_gnn_torch.serving import restore_predictor
    from msha_gnn_torch.training import Trainer, TrainState, save_checkpoint
    from msha_gnn_torch.utils import TrainConfig

    def run_cli(args):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(args)
        secs = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli {args[0]} exited {rc}")
        return json.loads(out.getvalue().strip().splitlines()[-1]), secs

    rng = np.random.default_rng(0)
    fg = load_flow_graph("2015", data_dir)
    ids = rng.integers(0, fg.n_src, EXPORT_IDS)
    results = {}
    gcn = ["--model", "gcn", "--in_features", str(NFEAT), "--data_dir",
           data_dir, "--checkpoint_dir", os.path.join(td, "ckpt_gcn")]
    report, secs = run_cli(["train", *gcn, "--epochs", "1"])
    log(f"  cli train --model gcn --epochs 1: {secs:.2f} s, accuracy "
        f"{report['accuracy']:.4f}")

    cfg = dataclasses.replace(TrainConfig(), model="msha", data_dir=data_dir,
                              checkpoint_dir=os.path.join(td, "ckpt_msha"))
    task, model = _build_task(cfg, fg, DEVICE)
    state = TrainState.create(model, task.optimizer)
    trainer = Trainer(task=task, src=fg.edge_src.numpy(),
                      labels=fg.edge_dst.numpy(), seed=cfg.seed)
    train_ids, _ = train_test_split_records(fg.num_records,
                                            cfg.train_fraction, cfg.seed)
    state, _ = trainer.train_epoch(
        state, train_ids[:MSHA_TRAIN_IDS],
        torch.Generator(device=DEVICE).manual_seed(cfg.seed), 0)
    save_checkpoint(cfg.checkpoint_dir, state, step=state.step)
    msha = ["--data_dir", data_dir, "--checkpoint_dir", cfg.checkpoint_dir]

    for name, args, kind in (
            ("gcn", [*gcn, "--kind", "table", "--portable", "1"], "table"),
            ("msha", [*msha, "--kind", "batch", "--predict_batch",
                      str(PREDICT_BATCH)], "batch")):
        path = os.path.join(td, f"{name}.mshax")
        summary, export_s = run_cli(["export", *args, "--output", path])
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            blob = f.read()
        scorer = load_scorer(blob)
        load_s = time.perf_counter() - t0
        cfg_p = dataclasses.replace(
            TrainConfig(), model=name, data_dir=data_dir,
            in_features=NFEAT if name == "gcn" else TrainConfig().in_features,
            checkpoint_dir=(gcn[-1] if name == "gcn" else
                            cfg.checkpoint_dir))
        predictor, _, _ = restore_predictor(cfg_p, PREDICT_BATCH, DEVICE)
        zero_counts()
        with SpmmRows() as calls:
            got = scorer(ids)
            torch.cuda.synchronize()
        launches, rows = read_counts(), calls.rows
        want = predictor.log_scores(ids)
        err = float(np.abs(got.cpu().numpy() - want).max())
        log(f"  {name}: cli export --kind {kind} {export_s:.2f} s "
            f"({summary['bytes'] / 2**20:.2f} MiB, platforms "
            f"{summary['platforms']}), load_scorer {load_s:.2f} s; "
            f"{EXPORT_IDS} ids against the live Predictor: max abs err "
            f"{err:.3e} (rtol {EXPORT_RTOL}, atol {EXPORT_ATOL}); the call's "
            f"launches: csr_spmm_f32 {launches['csr_spmm_f32']} (rows "
            f"{rows})")
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=EXPORT_RTOL,
                                   atol=EXPORT_ATOL, err_msg=name)
        if summary["kind"] != kind or \
                scorer.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"{name}: {summary}, {scorer.device}")
        if name == "msha":
            if any(launches.values()):
                raise AssertionError(f"msha export launched {launches}")
            continue
        want_launches = {k: v for k, v in expected(csr_spmm_f32=2).items()
                         if k in launches}
        if launches != want_launches or rows != [fg.n_dst, fg.n_src]:
            raise AssertionError(f"an exported gcn table call launched "
                                 f"{launches}, rows {rows}")
        results = {"gc1": rows.count(fg.n_dst), "gc2": rows.count(fg.n_src)}
        table = scorer._fn
        fill = (lambda: predictor.task.full_scores(predictor.model))
        ms = {"exported": (time_ms(table), device_ms(table)),
              "eager": (time_ms(fill), device_ms(fill))}
        log(f"  gcn table [{fg.n_src}, {fg.n_dst}]: the exported call "
            f"{ms['exported'][0]:.4f} ms (device "
            f"{fmt(ms['exported'][1])}), the eager fill (phase 4's path) "
            f"{ms['eager'][0]:.4f} ms (device {fmt(ms['eager'][1])})")
        # the operator's host cost a call: the same launch back to back
        # through the wrapper and through the registered operator
        x = torch.rand((fg.n_src, fg.n_dst), device=DEVICE)
        op = operator_for(predictor.task.graph)
        args = (op.t_ptr, op.t_col, op.t_w, x, fg.n_dst)
        direct = time_ms(lambda: cuda_spmm.csr_spmm(*args))
        through = time_ms(lambda: cuda_spmm.csr_spmm_op(*args))
        # in a fresh interpreter: the operator's first call (the device
        # warmed first) and that it imports no torch._dynamo
        # (torch.library.custom_op's kernels run under
        # torch._dynamo.disable, which imports it at their first call)
        script = (
            "import sys, time, torch\n"
            "from msha_gnn_torch.ops.cuda import spmm\n"
            f"dev = torch.device({DEVICE!r})\n"
            "ptr = torch.tensor([0, 2, 3], dtype=torch.int32, device=dev)\n"
            "col = torch.tensor([0, 1, 1], dtype=torch.int32, device=dev)\n"
            "x = torch.ones((2, 4), device=dev)\n"
            "spmm.csr_spmm(ptr, col, None, x, 2).sum().item()\n"
            "t0 = time.perf_counter()\n"
            "spmm.csr_spmm_op(ptr, col, None, x, 2).sum().item()\n"
            "t1 = time.perf_counter()\n"
            "print(t1 - t0, 'torch._dynamo' in sys.modules)\n")
        first = subprocess.run(
            [sys.executable, "-c", script], check=True, capture_output=True,
            text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        first_s, loaded = first.stdout.split()
        log(f"  csr_spmm_f32 [gc1 A^T x] back to back: the wrapper "
            f"{direct:.4f} ms a call, the registered operator "
            f"{through:.4f} ms (events; below about 20 us a call they "
            f"measure the host); in a fresh interpreter the operator's "
            f"first call {float(first_s) * 1e3:.2f} ms, torch._dynamo "
            f"imported by it: {loaded}")
        if loaded != "False":
            raise AssertionError("the operator's first call imported "
                                 "torch._dynamo")
        zero_counts()
        on_cpu = load_scorer(blob, device="cpu")(ids)
        if any(read_counts().values()):
            raise AssertionError("the portable table on the cpu launched "
                                 f"{read_counts()}")
        close("gcn: the portable table loaded on the cpu (the plain SpMM) "
              "vs the card", on_cpu, got.cpu(), SLICE_TOL, SLICE_TOL)
    return results


def phase_nan_guard(data_dir):
    """Phase 16e: a NaN put into one source feature of full MSHA raises
    under ``nan_guard()`` naming an operator, and the same forward runs
    without the guard; a NaN row into ``csr_spmm_f32`` raises from the
    kernel's own check under the guard (the kernel is outside the
    dispatcher)."""
    from msha_gnn_torch import normalize_by_dst_degree
    from msha_gnn_torch.data import load_flow_graph
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.training import msha_task
    from msha_gnn_torch.utils.debug import nan_guard

    fg = load_flow_graph("2015", data_dir)
    task, model = msha_task(fg, device=DEVICE)
    with torch.no_grad():
        model.Sfeatures[7, 3] = float("nan")
    batch = torch.arange(PREDICT_BATCH, device=DEVICE)
    op = cuda_spmm.SpmmOperator(normalize_by_dst_degree(fg.inter).to(DEVICE),
                                DEVICE)
    x = torch.rand((fg.n_dst, M), device=DEVICE)
    x[3, 0] = float("nan")
    cases = (("msha forward", "aten.",
              lambda: task.forward(model, batch, train=False)[0]),
             ("csr_spmm_f32", "kernel csr_spmm_f32",
              lambda: cuda_spmm.csr_spmm(op.ptr, op.col, op.w, x, fg.n_src)))
    messages = []
    for label, named, fn in cases:
        try:
            with nan_guard():
                fn()
        except FloatingPointError as e:
            messages.append(f"{label}: {e}")
        else:
            raise AssertionError(f"{label}: no error under nan_guard()")
        if named not in messages[-1]:
            raise AssertionError(f"nan_guard named no {named!r}: "
                                 f"{messages[-1]}")
        out = fn()
        torch.cuda.synchronize()
        if not bool(torch.isnan(out).any()):
            raise AssertionError(f"{label}: no NaN reached the output")
    log(f"  under nan_guard(): {'; '.join(messages)}; without it both run "
        "and the NaN reaches their outputs")


def dense_reference(fg, model):
    """Float64 dense GCN forward from the model's weights (numpy)."""
    from msha_gnn_torch import normalize_by_dst_degree

    a = normalize_by_dst_degree(fg.inter).to_dense().double().numpy()
    sd = {k: v.detach().cpu().double().numpy()
          for k, v in model.state_dict().items()}
    h = np.maximum(a.T @ (sd["features"] @ sd["gc1.weight"])
                   + sd["gc1.bias"], 0)
    h = np.maximum(a @ (h @ sd["gc2.weight"]) + sd["gc2.bias"], 0)
    h = h - h.max(axis=1, keepdims=True)
    return h - np.log(np.exp(h).sum(axis=1, keepdims=True))


def post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def phase_slice(fg):
    """Phase 4: the GCN serving path at full width on the card."""
    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.ops.cuda.spmm import operator_for
    from msha_gnn_torch.server import ModelService, make_server
    from msha_gnn_torch.serving import Predictor
    from msha_gnn_torch.training import (gcn_task, restore_checkpoint,
                                         save_checkpoint)

    t0 = time.perf_counter()
    task, model = gcn_task(fg, nfeat=NFEAT, seed=0, device=DEVICE)
    log(f"  gcn_task (nfeat {NFEAT}, features "
        f"{tuple(model.features.shape)}): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, model, step=1)
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        model, _, step = restore_checkpoint(td, model)
    for k, v in model.state_dict().items():
        if not torch.equal(v, saved[k]):
            raise AssertionError(f"checkpoint round trip changed {k}")
    log(f"  checkpoint round trip (step {step}): bit-exact")

    op = operator_for(task.graph)
    predictor = Predictor.from_state(task, model)
    # the main path: counts set to 0 just before, read just after
    cuda_spmm.launches = 0
    op.launches = op.launches_transposed = 0
    t0 = time.perf_counter()
    full = predictor._full_scores()
    torch.cuda.synchronize()
    fill_ms = (time.perf_counter() - t0) * 1e3

    service = ModelService(predictor, n_src=fg.n_src,
                           class_names={i: f"P{i}" for i in range(fg.n_dst)},
                           metadata={"model": "gcn", "n_dst": fg.n_dst})
    httpd = make_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(0)
    req_ms = []
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                raise AssertionError("/healthz")
        for i in range(40):
            nodes = rng.integers(0, fg.n_src, 64).tolist()
            t0 = time.perf_counter()
            if i % 2 == 0:
                body = post(base + "/v1/predict", {"nodes": nodes, "k": 5})
                req_ms.append((time.perf_counter() - t0) * 1e3)
                for res, node in zip(body["results"], nodes):
                    ps = [e["p"] for e in res["top"]]
                    if res["node"] != node or len(ps) != 5 or \
                            ps != sorted(ps, reverse=True):
                        raise AssertionError(f"bad top-k {res}")
            else:
                body = post(base + "/v1/scores", {"nodes": nodes})
                req_ms.append((time.perf_counter() - t0) * 1e3)
                got = np.asarray(body["log_scores"])
                if got.shape != (64, fg.n_dst) or not np.allclose(
                        np.exp(got).sum(axis=1), 1.0, atol=1e-4):
                    raise AssertionError("/v1/scores rows are not "
                                         "distributions")
                want = full[torch.as_tensor(nodes, device=DEVICE)]
                if not np.array_equal(got.astype(np.float32),
                                      want.cpu().numpy()):
                    raise AssertionError("/v1/scores differs from the "
                                         "cached matrix")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    launches = {"total": cuda_spmm.launches,
                "transposed": op.launches_transposed,
                "plain": op.launches - op.launches_transposed}
    log(f"  main path launches of csr_spmm_f32: {launches}")
    if launches != {"total": 2, "transposed": 1, "plain": 1}:
        raise AssertionError(f"expected exactly 2 kernel launches per "
                             f"full-score fill, got {launches}")

    if tuple(full.shape) != (fg.n_src, fg.n_dst) or not bool(
            torch.isfinite(full).all()):
        raise AssertionError(f"full scores: shape {tuple(full.shape)} or "
                             "non-finite values")
    row_err = float((full.exp().sum(dim=1) - 1).abs().max())
    if row_err > 1e-4:
        raise AssertionError(f"rows are not distributions ({row_err:.2e})")

    task_t, model_t = gcn_task(fg, nfeat=NFEAT, seed=0, impl="torch",
                               device=DEVICE)
    model_t.load_state_dict(model.state_dict())
    before = cuda_spmm.launches
    full_t = task_t.full_scores(model_t)
    torch.cuda.synchronize()
    if cuda_spmm.launches != before:
        raise AssertionError("impl='torch' launched the CUDA kernel")
    slice_err = float((full - full_t).abs().max())
    log(f"  full scores [{fg.n_src}, {fg.n_dst}]: kernel path vs plain "
        f"path on the card: max abs err {slice_err:.3e} (atol {SLICE_TOL})")
    if slice_err > SLICE_TOL:
        raise AssertionError("kernel path disagrees with the plain path")

    small = synthetic_flow(600, 8, 20, 6, 4000, seed=1)
    task_s, model_s = gcn_task(small, nfeat=16, seed=1, device=DEVICE)
    got_s = task_s.full_scores(model_s).cpu().double().numpy()
    ref_err = float(np.abs(got_s - dense_reference(small, model_s)).max())
    log(f"  small graph (600 x 8): kernel path vs float64 dense reference: "
        f"max abs err {ref_err:.3e} (atol {REF_TOL})")
    if ref_err > REF_TOL:
        raise AssertionError("kernel path disagrees with the dense reference")

    refill_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        task.full_scores(model)
        torch.cuda.synchronize()
        refill_ms.append((time.perf_counter() - t0) * 1e3)
    summary = {
        "first_fill_ms": fill_ms,
        "fill_ms_p50": statistics.median(refill_ms),
        "request_ms_p50": statistics.median(req_ms),
        "requests": len(req_ms), "nodes_per_request": 64,
    }
    log(f"  slice: {json.dumps(summary)}")
    return launches


# ---------------------------------------------------------------------------
# Phase 17: cli bench, the benchmarks module on the card
# ---------------------------------------------------------------------------

def coalesced_csr(ptr, col, w, shape):
    """The CSR matrix of these slots with duplicate pairs summed, the
    library yardsticks' operand (their invariants want each pair once)."""
    from msha_gnn_torch.ops.cuda.spmm import edge_rows

    rows = edge_rows(ptr, col.numel())
    return torch.sparse_coo_tensor(torch.stack([rows, col.long()]), w,
                                   shape).coalesce().to_sparse_csr()


def sddmm_library(ptr, col, a, b, n_out):
    """``torch.sparse.sampled_addmm`` on the CSR pattern of these slots,
    ``(call, values, name)`` for :func:`kernel_use`, or None where this
    PyTorch refuses it."""
    e = col.numel()
    pattern = torch.sparse_csr_tensor(ptr, col, torch.zeros(e, device=DEVICE),
                                      size=(ptr.numel() - 1, b.shape[0]))
    bt = b.t()

    def call():
        return torch.sparse.sampled_addmm(pattern, a, bt, beta=0.0)

    try:
        call()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  torch.sparse.sampled_addmm does not run here: {exc}")
        return None
    return (call,
            lambda out: torch.cat([out.values(), out.values().new_zeros(
                n_out - e)]),
            "torch.sparse.sampled_addmm")


def phase_bench_kernels():
    """Phase 17a: ``csr_spmm_f32`` and ``csr_sddmm_f32`` at d 128 on
    ``bench_spmm`` / ``bench_sddmm``'s own inputs, before any timing:
    ``make_powerlaw_graph(131072, 131072, 2_000_000)`` (its x 16-byte
    aligned, so the SpMM takes its float4 rows), each against its plain
    version at the sums' tolerance (dots and row sums of 128 standard
    normal products), twice bit for bit, once through its C entry into a
    NaN-filled output; times, bounds and yardsticks as in phase 3."""
    from msha_gnn_torch import bench
    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.ops.cuda.rank1_gat import group_for
    from msha_gnn_torch.ops.cuda.spmm import SpmmOperator

    n, e, d = BENCH_NODES, BENCH_EDGES, BENCH_D
    g, x = bench.make_powerlaw_graph(n, n, e, d, device=DEVICE)
    op = SpmmOperator.build(g)
    e_pad = g.num_padded_edges
    hub = torch.bincount(op.col.long(), minlength=n)
    log(f"  graph: {n} x {n}, {e} edges ({e_pad} padded), rows {e / n:.1f} "
        f"edges on average, {int(op.ptr.diff().max())} at most; column 0 "
        f"takes {int(hub[0])} edges ({float(hub[0]) / e:.3f}), "
        f"{int((op.t_ptr.diff() > 0).sum())} columns any; x [{n}, {d}] at "
        f"{x.data_ptr() % 256} bytes past a 256-byte boundary")
    if x.data_ptr() % 16:
        raise AssertionError("x is not 16-byte aligned: csr_spmm_f32 would "
                             "skip its float4 rows")

    args = (op.ptr, op.col, op.w, x, n)
    a_csr = coalesced_csr(op.ptr, op.col, op.w, (n, n))
    spmm_entry = spmm_use("bench A x d128", args,
                          lambda: torch.sparse.mm(a_csr, x),
                          "torch.sparse.mm (duplicate pairs summed)")
    spmm_entry["replaces"] = "msha_gnn_tpu/ops/pallas/spmm.py:747 _hub_kernel"
    run = cuda_spmm.run_for(e, d)
    nan_filled(
        "csr_spmm_f32[bench A x d128]",
        ((n, d), (cuda_spmm.sums_ws_floats(e, run, d),)),
        lambda out, ws: cuda_spmm._kernel_lib().csr_spmm_f32(
            op.ptr.data_ptr(), op.col.data_ptr(), op.w.data_ptr(),
            x.data_ptr(), out.data_ptr(), ws.data_ptr(), n, e, run, d,
            torch.cuda.current_stream().cuda_stream),
        (cuda_spmm.csr_spmm(*args),), what="out")

    # bench_sddmm's rows: the same graph, a and b drawn from seed 1
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                        device=DEVICE)
    b = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                        device=DEVICE)
    sd_args = (op.ptr, op.col, a, b, e_pad)
    sd_run, sd_group = cuda_sddmm.RUN, group_for(d)
    log(f"  csr_sddmm_f32: {sd_run} slots a run, {sd_group} lanes an edge")
    prime_nan((e_pad,))
    if cuda_sddmm.csr_sddmm(*sd_args)[e:].any():
        raise AssertionError("csr_sddmm_f32 wrote a pad slot")
    sddmm_entry = kernel_use(
        "csr_sddmm_f32[bench d128]", "sddmm.cu",
        "msha_gnn_tpu/ops/pallas/spmm.py:1428 _sddmm_kernel and :1294 "
        "_sddmm_hub_kernel",
        lambda: cuda_sddmm.csr_sddmm(*sd_args),
        lambda: cuda_sddmm.csr_sddmm_plain(*sd_args),
        sddmm_bound(*sd_args), SUM_RTOL, SUM_ATOL_REL,
        sddmm_library(*sd_args))
    nan_filled(
        "csr_sddmm_f32[bench d128]", ((e_pad,),),
        lambda out: cuda_sddmm._kernel_lib().csr_sddmm_f32(
            op.ptr.data_ptr(), op.col.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, e_pad, sd_run, sd_group, d,
            torch.cuda.current_stream().cuda_stream),
        (cuda_sddmm.csr_sddmm(*sd_args),), what="out (pads included)")
    return [spmm_entry, sddmm_entry]


def phase_bench_attention(data_dir):
    """Phase 17b: the attention benchmark's two paths on the 2015 inter
    graph of ``data_dir`` at d 64.  The sparse path (the kernels) against
    the dense one: outputs and both gradients at the sums' tolerance (the
    columns' sums run over thousands of edges), with exact launches; each
    kernel of the path against its plain version on the path's inputs;
    then ``bench_flagship_attention_paths`` itself, its launches counted
    (the sparse path's operators caught as the benchmark builds them)."""
    import functools

    from msha_gnn_torch import bench
    from msha_gnn_torch.data import load_flow_graph
    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm
    from msha_gnn_torch.ops.cuda import softmax as sm

    fg = load_flow_graph("2015", data_dir)
    host = fg.inter
    g = host.to(DEVICE)
    n, m, e, e_pad, d = (g.n_src, g.n_dst, g.num_edges, g.num_padded_edges,
                         ATTENTION_D)
    if not bool((host.row_ptr.diff() > 0).all()):
        raise AssertionError("a source without edges: the dense path's row "
                             "would be uniform, the sparse path's zero")
    x = bench.attention_inputs(g, d)
    ops = bench.attention_operators(g, host=host)
    op, _, sop = ops
    log(f"  graph: {n} x {m}, {e} edges ({e_pad} padded), no empty row, "
        f"d {d}; columns {int(op.t_ptr.diff().min())} to "
        f"{int(op.t_ptr.diff().max())} edges")
    kw = dict(a_src=x["a_src"], a_dst=x["a_dst"])
    dense = functools.partial(bench.attention_dense_path, mask=x["mask"],
                              **kw)
    sparse = functools.partial(bench.attention_sparse_path, ops=ops, **kw)
    h1, h2, ct_n, ct_m = x["h1"], x["h2"], x["ct_n"], x["ct_m"]

    zero_counts(op)
    got = sparse(h1, h2)
    torch.cuda.synchronize()
    fwd_counts = read_counts(op)
    zero_counts(op)
    got += tuple(bench.attention_grads(sparse, h1, h2, ct_n, ct_m))
    torch.cuda.synchronize()
    grad_counts = read_counts(op)
    # forward: the logits, the softmax, the two att-weighted SpMMs; with
    # the backward also each SpMM's dw, the softmax VJP, each SpMM's dx and
    # the logits' two d = 2 adjoints
    fwd_want = expected(csr_sddmm_f32=1, seg_softmax_fwd_f32=1,
                        csr_spmm_f32=2, csr_spmm_f32_transposed=1)
    grad_want = expected(csr_sddmm_f32=3, seg_softmax_fwd_f32=1,
                         seg_softmax_bwd_f32=1, csr_spmm_f32=6,
                         csr_spmm_f32_transposed=3)
    for label, have, want in (("forward", fwd_counts, fwd_want),
                              ("forward and gradients", grad_counts,
                               grad_want)):
        if have != want:
            raise AssertionError(f"sparse attention {label} launched "
                                 f"{have}, not {want}")
        log(f"  sparse path, {label}: launches "
            f"{ {k: v for k, v in have.items() if v} } exactly")
    want = (*dense(h1, h2),
            *bench.attention_grads(dense, h1, h2, ct_n, ct_m))
    for label, t, w in zip(("u = att h1", "v = att^T h2", "dh1", "dh2"),
                           got, want):
        close(f"sparse vs dense attention {label}", t, w, SUM_RTOL,
              SUM_ATOL_REL * float(w.abs().max()))

    # each kernel on the path's own inputs
    s_src, s_dst = h2 @ x["a_src"], h1 @ x["a_dst"]
    lhs = torch.stack([s_src, torch.ones_like(s_src)], dim=1)
    rhs = torch.stack([torch.ones_like(s_dst), s_dst], dim=1)
    sddmm_repl = ("msha_gnn_tpu/ops/pallas/spmm.py:1428 _sddmm_kernel and "
                  ":1294 _sddmm_hub_kernel")
    results = []
    for label, sd_args in (("attention logits d2", (op.ptr, op.col, lhs, rhs,
                                                    e_pad)),
                           ("attention dw d64", (op.ptr, op.col, ct_n, h1,
                                                 e_pad))):
        results.append(kernel_use(
            f"csr_sddmm_f32[{label}]", "sddmm.cu", sddmm_repl,
            lambda sd_args=sd_args: cuda_sddmm.csr_sddmm(*sd_args),
            lambda sd_args=sd_args: cuda_sddmm.csr_sddmm_plain(*sd_args),
            sddmm_bound(*sd_args), SUM_RTOL, SUM_ATOL_REL,
            sddmm_library(*sd_args)))
    logits = torch.nn.functional.leaky_relu(
        cuda_sddmm.csr_sddmm(op.ptr, op.col, lhs, rhs, e_pad), 0.2)
    fwd_args = (sop.ptr, logits, None, e)
    coo = torch.sparse_coo_tensor(
        torch.stack([g.senders[:e].long(), g.receivers[:e].long()]),
        logits[:e], size=(n, m)).coalesce()
    fwd_b, bwd_b = softmax_bounds(n, e, e_pad, masked=False)
    results.append(kernel_use(
        "seg_softmax_fwd_f32[attention]", "softmax.cu",
        "msha_gnn_tpu/ops/pallas/softmax.py:56 _stats_kernel and :86 "
        "_expand_kernel",
        lambda: sm.seg_softmax_fwd(*fwd_args, sop.run, sop.ws),
        lambda: sm.seg_softmax_fwd_plain(*fwd_args), fwd_b, KERNEL_RTOL,
        KERNEL_ATOL, (lambda: torch.sparse.softmax(coo, 1),
                      lambda out: torch.cat([out.values(),
                                             logits.new_zeros(e_pad - e)]),
                      "torch.sparse.softmax")))
    att = sm.seg_softmax_fwd_plain(*fwd_args)[0]
    gatt = torch.randn(e_pad, device=DEVICE,
                       generator=torch.Generator(device=DEVICE).manual_seed(3))
    bwd_args = (sop.ptr, att, gatt, e)
    att_coo = torch.sparse.softmax(coo, 1)
    g_coo = torch.sparse_coo_tensor(att_coo.indices(), gatt[:e],
                                    size=(n, m)).coalesce()
    results.append(kernel_use(
        "seg_softmax_bwd_f32[attention]", "softmax.cu",
        "msha_gnn_tpu/ops/pallas/softmax.py:102 _rowsum_kernel and :86 "
        "_expand_kernel",
        lambda: sm.seg_softmax_bwd(*bwd_args, sop.run, sop.ws),
        lambda: sm.seg_softmax_bwd_plain(*bwd_args), bwd_b, SUM_RTOL,
        SUM_ATOL_REL,
        (lambda: torch._sparse_softmax_backward_data(g_coo, att_coo, 1, coo),
         lambda out: torch.cat([out.coalesce().values(),
                                gatt.new_zeros(e_pad - e)]),
         "torch.sparse.softmax backward")))
    for label, transpose, inp in (("attention att A h1 d64", False, h1),
                                  ("attention att A^T h2 d64", True, h2)):
        ptr, col = (op.t_ptr, op.t_col) if transpose else (op.ptr, op.col)
        ww = op.weights(att, transpose)
        shape = (m, n) if transpose else (n, m)
        a_csr = torch.sparse_csr_tensor(ptr, col, ww, size=shape)
        results.append(spmm_use(
            label, (ptr, col, ww, inp, shape[0]),
            lambda a_csr=a_csr, inp=inp: torch.sparse.mm(a_csr, inp),
            "torch.sparse.mm"))
        if not transpose:
            results[-1]["replaces"] = ("msha_gnn_tpu/ops/pallas/spmm.py:747 "
                                       "_hub_kernel")

    caught = []

    def catch(graph, host=None):
        caught.append(build_ops(graph, host=host))
        return caught[-1]

    build_ops = bench.attention_operators
    bench.attention_operators = catch
    try:
        zero_counts()
        t0 = time.perf_counter()
        out = bench.bench_flagship_attention_paths(d=d, data_dir=data_dir)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(caught[0][0])
    finally:
        bench.attention_operators = build_ops
    log(f"  bench_flagship_attention_paths ({seconds:.1f} s): "
        f"{json.dumps(out)}")
    for k in ("dense_fwd", "sparse_fwd", "dense_fwd_grad", "sparse_fwd_grad",
              "dense_over_sparse_fwd", "dense_over_sparse_fwd_grad"):
        if not (np.isfinite(out[k]) and out[k] > 0):
            raise AssertionError(f"bench_flagship_attention_paths: {k} "
                                 f"{out[k]}")
    if set(out) != ATTENTION_KEYS or (out["n"], out["m"], out["edges"]) != (
            n, m, e):
        raise AssertionError(f"bench_flagship_attention_paths returned {out}")
    # a forward runs one logits SDDMM beside its one softmax (the exact
    # counts above); the other SDDMMs are the SpMMs' dw
    transposed = counts["csr_spmm_f32 transposed"]
    launches = {
        "csr_sddmm_f32[attention logits d2]": counts["seg_softmax_fwd_f32"],
        "csr_sddmm_f32[attention dw d64]":
            counts["csr_sddmm_f32"] - counts["seg_softmax_fwd_f32"],
        "seg_softmax_fwd_f32[attention]": counts["seg_softmax_fwd_f32"],
        "seg_softmax_bwd_f32[attention]": counts["seg_softmax_bwd_f32"],
        "csr_spmm_f32[attention att A h1 d64]":
            counts["csr_spmm_f32"] - transposed,
        "csr_spmm_f32[attention att A^T h2 d64]": transposed}
    log(f"  its launches: {launches} (the SpMMs' counts take their dx and "
        "the logits' d = 2 adjoints)")
    for k in results:
        k["launches"] = launches[k["name"]]
    return results


def is_time(v):
    return isinstance(v, float) and np.isfinite(v) and v > 0


def phase_cli_bench(data_dir):
    """Phase 17c: ``python -m msha_gnn_torch.cli bench --which all
    --data_dir <16a>`` in this process, its one JSON line read back: every
    key of the JAX package's output (``xla`` -> ``torch``, ``pallas`` ->
    ``cuda``, no ``prng``), every time finite and positive,
    ``records_per_s == batch_size / step_seconds``, ``mfu`` a number,
    exactly 23 launches (3 warm-up, 20 timed) of each of ``csr_spmm_f32``
    and ``csr_sddmm_f32`` and none of the other kernels (the flagship's
    MSHA and the torch rows launch none), the peak memory (the dense
    baseline's concat tensors); then ``bench_serving`` at batch 1,024 and
    ``bench_flagship_size_sweep`` at ``SWEEP_SIZES``.  Returns the kernel
    launches of the CLI run."""
    import contextlib
    import io

    from msha_gnn_torch import bench, cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--which", "all", "--data_dir", data_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    lines = buf.getvalue().splitlines()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"cli bench: rc {rc}, {len(lines)} lines")
    out = json.loads(lines[0])
    log(f"  cli bench --which all: {seconds:.1f} s, peak memory "
        f"{peak / 2**30:.2f} GiB")
    for k, v in out.items():
        log(f"    {k}: {json.dumps(v)}")
    if set(out) != set(BENCH_KEYS) | {"device"} or \
            out["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"cli bench keys {sorted(out)}")
    for k, keys in BENCH_KEYS.items():
        if set(out[k]) != keys:
            raise AssertionError(f"cli bench {k}: keys {sorted(out[k])}")
    flag = out["flagship"]
    for k in ("step_seconds", "single_dispatch_step_seconds",
              "dense_baseline_step_seconds", "records_per_s",
              "flops_per_step", "mfu", "speedup_vs_dense_reference"):
        if not is_time(flag[k]):
            raise AssertionError(f"flagship {k} {flag[k]!r}")
    if flag["records_per_s"] != flag["batch_size"] / flag["step_seconds"]:
        raise AssertionError("records_per_s is not batch_size / step_seconds")
    if not flag["mfu"] < 1.0:
        raise AssertionError(f"flagship mfu {flag['mfu']}")
    for k in ("spmm", "spmm_torch", "sddmm", "sddmm_cuda"):
        if not all(is_time(v) for kk, v in out[k].items()
                   if kk not in ("impl", "edges", "d")):
            raise AssertionError(f"{k}: {out[k]}")
    want = expected(csr_spmm_f32=23, csr_sddmm_f32=23)
    del want["csr_spmm_f32 transposed"], want["csr_spmm_f32 reduce_edges"]
    if counts != want:
        raise AssertionError(f"cli bench launched {counts}, not {want}")
    log("  cli bench launched exactly 23 csr_spmm_f32 and 23 csr_sddmm_f32, "
        "nothing else of the port's kernels")

    zero_counts()
    t0 = time.perf_counter()
    serving = bench.bench_serving(batch_size=PREDICT_BATCH, data_dir=data_dir)
    log(f"  bench_serving (batch {PREDICT_BATCH}, "
        f"{time.perf_counter() - t0:.1f} s): {json.dumps(serving)}")
    t0 = time.perf_counter()
    sweep = bench.bench_flagship_size_sweep(sizes=SWEEP_SIZES)
    log(f"  bench_flagship_size_sweep {SWEEP_SIZES} "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(sweep)}")
    if any(read_counts().values()):
        raise AssertionError("serving or the sweep launched a kernel of the "
                             "port")
    if list(serving) != ["full_scores_cache", "per_batch"] or \
            list(sweep) != [str(s) for s in SWEEP_SIZES]:
        raise AssertionError("bench_serving / size sweep rows")
    for row in (*serving.values(), *sweep.values()):
        if set(row) not in (SERVING_KEYS, SWEEP_KEYS) or \
                not all(is_time(v) for v in row.values()):
            raise AssertionError(f"bench row {row}")
    return {"csr_spmm_f32": counts["csr_spmm_f32"],
            "csr_sddmm_f32": counts["csr_sddmm_f32"]}


def grads_of(fn, *inputs, ct=None):
    """``fn(*inputs)`` and the gradients of ``sum(out * ct)`` (``ct`` ones
    by default) with respect to the inputs: ``[out, d_1, ...]``."""
    inputs = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*inputs)
    out.backward(torch.ones_like(out) if ct is None else ct)
    return [out.detach()] + [t.grad for t in inputs]


def parallel_kernels(g, sh_r1, sh_csr, c, a, x, gout, w):
    """Each kernel the sharded operators launch, on the shard's own arrays
    (world size 1: the whole graph) against its plain version, as phases
    3 and 3b hold them; returns their entries of the kernels line."""
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm

    n, e, d = g.n_src, g.num_edges, x.shape[1]
    loc = sh_r1.local
    seed = loc.ptr.new_zeros(1)
    fwd_args = (loc.ptr, loc.col, c, a, x, seed, 0.0, sh_r1.slope,
                sh_r1.row_blk)
    out, lse = r1.rank1_gat_plain(*fwd_args)
    bwd_args = (loc.ptr, loc.col, c, a, x, gout, out, lse, seed, 0.0,
                sh_r1.slope, sh_r1.row_blk)
    (fwd_b, fwd_by), (bwd_b, bwd_by) = r1l_bounds(n, e, d)
    src = "msha_gnn_tpu/ops/pallas/rank1_gat.py"
    kernels = [
        kernel_use("r1l_fwd_f32[shard, K=1]", "rank1_gat.cu",
                   f"{src}:234 _r1l_fwd_kernel",
                   lambda: r1.r1l_fwd(*fwd_args),
                   lambda: r1.rank1_gat_plain(*fwd_args), (fwd_b, fwd_by),
                   KERNEL_RTOL, KERNEL_ATOL),
        kernel_use("r1l_bwd_f32[shard, K=1]", "rank1_gat.cu",
                   f"{src}:305 _r1l_bwd_kernel",
                   lambda: r1.r1l_bwd(*bwd_args),
                   lambda: r1.rank1_gat_bwd_plain(*bwd_args),
                   (bwd_b, bwd_by), KERNEL_RTOL, KERNEL_ATOL)]
    q, dpre, _, _ = r1.rank1_gat_bwd_plain(*bwd_args)
    w_q = loc.weights(q, True)
    dcol = dpre[:, None].contiguous()
    rcv = loc.col.long()
    kernels += [
        spmm_use("shard r1l dx q A^T g", (loc.t_ptr, loc.t_col, w_q, gout, n),
                 lambda: torch.sparse.mm(torch.sparse_csr_tensor(
                     loc.t_ptr, loc.t_col, w_q, size=(n, n)), gout),
                 "torch.sparse.mm"),
        spmm_use("shard r1l dpre column sum",
                 (loc.t_ptr, loc.t_edge, None, dcol, n),
                 lambda: dcol.new_zeros((n, 1)).index_add_(0, rcv, dcol),
                 "index_add_")]
    sp = sh_csr.local
    w_e, w_t = sp.weights(w, False), sp.weights(w, True)
    kernels += [
        spmm_use("shard A x", (sp.ptr, sp.col, w_e, x, n),
                 lambda: torch.sparse.mm(torch.sparse_csr_tensor(
                     sp.ptr, sp.col, w_e, size=(n, n)), x),
                 "torch.sparse.mm"),
        spmm_use("shard dx A^T g", (sp.t_ptr, sp.t_col, w_t, gout, n),
                 lambda: torch.sparse.mm(torch.sparse_csr_tensor(
                     sp.t_ptr, sp.t_col, w_t, size=(n, n)), gout),
                 "torch.sparse.mm")]
    sd_args = (sp.ptr, sp.col, gout, x, e)
    kernels.append(kernel_use(
        "csr_sddmm_f32[shard dw]", "sddmm.cu",
        "msha_gnn_tpu/ops/pallas/spmm.py:1428 _sddmm_kernel",
        lambda: cuda_sddmm.csr_sddmm(*sd_args),
        lambda: cuda_sddmm.csr_sddmm_plain(*sd_args),
        sddmm_bound(*sd_args), SUM_RTOL, SUM_ATOL_REL,
        sddmm_library(*sd_args)))
    return kernels


def phase_parallel_ops(split, mesh):
    """Phase 18a: the sharded operators at world size 1 on the linkpred
    graph at d 64 against the single-card ones on the same inputs:
    ShardedRank1Gat against Rank1GatOperator(dst_linear=True) and
    ShardedCsrSpmm against SpmmOperator bit for bit (outputs and
    gradients), with exact launches; DistributedSpmm and RingSpmm
    (forward, transpose, runtime weights, gradients) at DIST_TOL,
    launching no kernel.  Returns the kernels' entries (their launches
    those of the sharded operators here) and the per-entry launches."""
    from msha_gnn_torch import parallel as par
    from msha_gnn_torch.ops.cuda.rank1_gat import Rank1GatOperator
    from msha_gnn_torch.ops.cuda.spmm import SpmmOperator
    from msha_gnn_torch.parallel.comm import gather_rows, scatter_rows

    g = split["graph"].to(DEVICE)
    n, e, d = g.n_src, g.num_edges, LP_D
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    c = torch.randn(n, generator=gen, device=DEVICE)
    a = torch.randn(d, generator=gen, device=DEVICE) * 0.3
    x = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    w = torch.rand(g.num_padded_edges, generator=gen, device=DEVICE)
    log(f"  linkpred graph: {n} rows, {e} edges; d {d}; world {mesh.world}, "
        f"backend {torch.distributed.get_backend()}")

    def whole(fn, n_out):
        return lambda *t: gather_rows(fn(*t), n_out, mesh)

    sh_r1 = par.ShardedRank1Gat(g, mesh)
    sh_csr = par.ShardedCsrSpmm(g, mesh)
    cases = [
        ("ShardedRank1Gat", ("out", "dc", "da", "dx"),
         lambda: grads_of(Rank1GatOperator(g, dst_linear=True), c, a, x,
                          ct=gout),
         lambda: grads_of(whole(lambda c, a, x: sh_r1(
             scatter_rows(c, mesh), a, scatter_rows(x, mesh)), n), c, a, x,
             ct=gout),
         dict(r1l_fwd_f32=1, r1l_bwd_f32=1, csr_spmm_f32=2)),
        ("ShardedCsrSpmm static", ("out", "dx"),
         lambda: grads_of(SpmmOperator(g, DEVICE), x, ct=gout),
         lambda: grads_of(whole(lambda x: sh_csr(scatter_rows(x, mesh)), n),
                          x, ct=gout),
         dict(csr_spmm_f32=2)),
        ("ShardedCsrSpmm runtime weights", ("out", "dx", "dw"),
         lambda: grads_of(lambda x, w: SpmmOperator(g, DEVICE)(
             x, edge_weight=w), x, w, ct=gout),
         lambda: grads_of(whole(lambda x, w: sh_csr(
             scatter_rows(x, mesh), edge_weight=w), n), x, w, ct=gout),
         dict(csr_spmm_f32=2, csr_sddmm_f32=1)),
    ]
    launches = {}
    for name, keys, single, sharded, want_n in cases:
        want = single()
        torch.cuda.synchronize()
        zero_counts()
        got = sharded()
        torch.cuda.synchronize()
        counts = read_counts()
        want_c = {k: v for k, v in expected(**want_n).items() if k in counts}
        if counts != want_c:
            raise AssertionError(f"{name}: launched {counts}, not {want_c}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        for key, u, v in zip(keys, want, got):
            if key == "dw":
                u, v = u[:e], v[:e]
            if not torch.equal(u, v):
                raise AssertionError(f"{name} {key}: not bit for bit equal "
                                     f"to the single-card operator (max "
                                     f"diff {float((u - v).abs().max()):.3e})")
        log(f"  {name}: {', '.join(keys)} bit for bit equal to the "
            f"single-card operator's; launches {want_n}")
    loc = sh_r1.local
    r1_reduce = loc.launches_reduce
    r1_q = loc.launches_transposed - loc.launches_reduce
    csr_fwd = sh_csr.local.launches - sh_csr.local.launches_transposed
    csr_dx = sh_csr.local.launches_transposed

    ref = SpmmOperator(g, DEVICE)
    xt = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    for name, op in (("DistributedSpmm", par.DistributedSpmm(g, mesh)),
                     ("RingSpmm", par.RingSpmm(g, mesh,
                                               runtime_weights=True))):
        for kind, weighted, transpose in (("forward", False, False),
                                          ("runtime weights", True, False),
                                          ("transpose", True, True)):
            inp = (xt, w) if weighted else (xt,)
            want = grads_of(lambda x, *w: ref(
                x, edge_weight=w[0] if w else None, transpose=transpose),
                *inp, ct=gout)
            torch.cuda.synchronize()
            zero_counts()
            got = grads_of(whole(lambda x, *w: op(
                scatter_rows(x, mesh), edge_weight=w[0] if w else None,
                transpose=transpose), n), *inp, ct=gout)
            torch.cuda.synchronize()
            if any(read_counts().values()):
                raise AssertionError(f"{name} launched a kernel of the port")
            for key, u, v in zip(("out", "dx", "dw"), want, got):
                if key == "dw":
                    u, v = u[:e], v[:e]
                close(f"{name} {kind} {key}", v, u, DIST_TOL,
                      DIST_TOL * max(1.0, float(u.abs().max())))
    kernels = parallel_kernels(g, sh_r1, sh_csr, c, a, x, gout, w)
    per_entry = {"r1l_fwd_f32[shard, K=1]": launches["r1l_fwd_f32"],
                 "r1l_bwd_f32[shard, K=1]": launches["r1l_bwd_f32"],
                 "csr_spmm_f32[shard r1l dx q A^T g]": r1_q,
                 "csr_spmm_f32[shard r1l dpre column sum]": r1_reduce,
                 "csr_spmm_f32[shard A x]": csr_fwd,
                 "csr_spmm_f32[shard dx A^T g]": csr_dx,
                 "csr_sddmm_f32[shard dw]": launches["csr_sddmm_f32"]}
    return kernels, per_entry


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def shard_train_kernels(op, d):
    """18b's kernels on the fused run's own shard (world size 1: phase
    14's whole 50 M-edge graph in one launch each, the hub receiver's
    19 M edges in one row of the transposed SpMMs) at ``ScaleConfig``'s
    ``d``, on seeded inputs, against their plain versions: the rank-1
    kernels as 18a holds them (float32 plain, rows of about 25 edges),
    the two dx SpMMs against the float64 plain version at the sums'
    tolerance, as phase 14 holds its slices.  Times over 5 x 5 calls.
    Returns their entries of the kernels line."""
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    loc = op.local
    n, e = op.row_blk, loc.num_edges
    gen = torch.Generator(device=DEVICE).manual_seed(181)
    c = torch.randn(n, generator=gen, device=DEVICE)
    a = torch.randn(d, generator=gen, device=DEVICE) * 0.3
    x = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    seed = loc.ptr.new_zeros(1)
    log(f"  the shard: {n} rows, {e} edges, d {d}; longest transposed row "
        f"{int((loc.t_ptr[1:] - loc.t_ptr[:-1]).max())} edges")
    fwd_args = (loc.ptr, loc.col, c, a, x, seed, 0.0, op.slope, n)
    out, lse = r1.r1l_fwd(*fwd_args)
    bwd_args = (loc.ptr, loc.col, c, a, x, gout, out, lse, seed, 0.0,
                op.slope, n)
    (fwd_b, fwd_by), (bwd_b, bwd_by) = r1l_bounds(n, e, d)
    src = "msha_gnn_tpu/ops/pallas/rank1_gat.py"
    timing = dict(reps=5, iters=5)
    kernels = [
        kernel_use("r1l_fwd_f32[shard train, K=1]", "rank1_gat.cu",
                   f"{src}:234 _r1l_fwd_kernel",
                   lambda: r1.r1l_fwd(*fwd_args),
                   lambda: r1.rank1_gat_plain(*fwd_args), (fwd_b, fwd_by),
                   KERNEL_RTOL, KERNEL_ATOL, **timing),
        kernel_use("r1l_bwd_f32[shard train, K=1]", "rank1_gat.cu",
                   f"{src}:305 _r1l_bwd_kernel",
                   lambda: r1.r1l_bwd(*bwd_args),
                   lambda: r1.rank1_gat_bwd_plain(*bwd_args),
                   (bwd_b, bwd_by), KERNEL_RTOL, KERNEL_ATOL, **timing)]
    q, dpre, _, _ = r1.r1l_bwd(*bwd_args)
    del out, lse
    w_q = loc.weights(q, True)
    dcol = dpre[:, None].contiguous()
    dsorted = dpre.index_select(0, loc.t_edge)
    t_off = loc.t_ptr.long()
    g64 = gout.double()
    spmm = "msha_gnn_tpu/ops/pallas/spmm.py:244 _visit_kernel"
    for label, args, ref_args, weighted, library in (
            ("shard train dx q A^T g", (loc.t_ptr, loc.t_col, w_q, gout, n),
             (loc.t_ptr, loc.t_col, w_q.double(), g64, n), True,
             (lambda: torch.sparse.mm(torch.sparse_csr_tensor(
                 loc.t_ptr, loc.t_col, w_q, size=(n, n)), gout),
              lambda v: v, "torch.sparse.mm")),
            ("shard train dpre column sum",
             (loc.t_ptr, loc.t_edge, None, dcol, n),
             (loc.t_ptr, loc.t_edge, None, dcol.double(), n), False,
             (lambda: torch.segment_reduce(dsorted, "sum", offsets=t_off),
              lambda v: v[:, None],
              "torch.segment_reduce (on dpre gathered to CSC order)"))):
        kernels.append(kernel_use(
            f"csr_spmm_f32[{label}]", "spmm.cu", spmm,
            lambda args=args: cuda_spmm.csr_spmm(*args),
            lambda args=args: cuda_spmm.csr_spmm_plain(*args),
            spmm_bound(args[0], args[1], args[3], n, weighted=weighted),
            SUM_RTOL, SUM_ATOL_REL, library,
            reference=lambda ref_args=ref_args: cuda_spmm.csr_spmm_plain(
                *ref_args), **timing))
    return kernels


def phase_parallel_train(mesh, scale_runs):
    """Phase 18b: ``train_distributed`` at world size 1 on phase 14's
    graph, ``ScaleConfig()``, 5 steps fused and 5 materialised, each held
    to ``train_chunked``'s losses of phase 14 (the same edges in the same
    (sender, receiver) order, seed and batches) at DIST_TRAIN_TOL, with
    exact launches; the step wall p50, edges/s and peak memory; then the
    fused run's kernels on its own shard (:func:`shard_train_kernels`).
    Returns those kernels' entries and their launches in the fused run,
    the dx SpMM's two uses read from the shard operator's own counts."""
    from msha_gnn_torch.training import scale

    src, dst = scale_runs["edges"]
    cfg = scale.ScaleConfig(steps=SCALE_STEPS)
    built = []
    real_build = scale.build_distributed

    def build(*args, **kwargs):
        out = real_build(*args, **kwargs)
        built.append(out[3])
        return out

    kernels, launches = [], {}
    scale.build_distributed = build
    try:
        for label, fused, chunked in (("fused", True, "fused f32"),
                                      ("materialised", False,
                                       "materialised f32")):
            gc_cuda()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            steps = []
            t0 = time.perf_counter()
            res = scale.train_distributed(src, dst, SCALE_NODES, mesh, cfg,
                                          fused=fused, log=steps.append)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated()
            want = {k: v for k, v in (expected(
                r1l_fwd_f32=cfg.steps, r1l_bwd_f32=cfg.steps,
                csr_spmm_f32=2 * cfg.steps) if fused else expected()).items()
                if k in counts}
            if counts != want:
                raise AssertionError(f"train_distributed {label}: launched "
                                     f"{counts}, not {want}")
            got = np.array(res["loss_history"])
            ref = np.array(scale_runs["losses"][chunked])
            diff = np.abs(got - ref)
            log(f"  train_distributed {label} ({res['topology']}, "
                f"{res['attention']}): {wall:.1f} s; losses "
                f"{[round(float(v), 6) for v in got]}; train_chunked "
                f"{chunked}: {[round(float(v), 6) for v in ref]}; max "
                f"|diff| {diff.max():.2e} (rtol and atol {DIST_TRAIN_TOL})")
            if not np.all(diff <= DIST_TRAIN_TOL
                          + DIST_TRAIN_TOL * np.abs(ref)):
                raise AssertionError(f"train_distributed {label} leaves "
                                     "train_chunked's losses")
            p50 = statistics.median(v["seconds"] for v in steps[2:])
            log(f"  train_distributed {label} on {card()}: steady step wall "
                f"p50 {p50 * 1e3:.1f} ms (steps 2-{cfg.steps - 1}), "
                f"{SCALE_EDGES / p50:.4g} edges/s; peak "
                f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; "
                f"launches {counts}")
            op = built.pop()
            if fused:
                loc = op.local
                q_dx = loc.launches_transposed - loc.launches_reduce
                if (loc.launches != loc.launches_transposed
                        or q_dx + loc.launches_reduce
                        != counts["csr_spmm_f32"]):
                    raise AssertionError(
                        f"the shard operator counted {loc.launches} "
                        f"launches, {loc.launches_transposed} transposed, "
                        f"{loc.launches_reduce} column sums; the run "
                        f"{counts['csr_spmm_f32']}")
                launches = {
                    "r1l_fwd_f32[shard train, K=1]": counts["r1l_fwd_f32"],
                    "r1l_bwd_f32[shard train, K=1]": counts["r1l_bwd_f32"],
                    "csr_spmm_f32[shard train dx q A^T g]": q_dx,
                    "csr_spmm_f32[shard train dpre column sum]":
                        loc.launches_reduce}
                del res
                gc_cuda()
                kernels = shard_train_kernels(op, cfg.d)
            del op
    finally:
        scale.build_distributed = real_build
    gc_cuda()
    return kernels, launches


def phase_parallel_bench(mesh):
    """Phase 18c: ``python -m msha_gnn_torch.cli bench --which scaling`` in
    this process, on the group of 18a: one JSON line with the JAX keys,
    finite times, ``records_per_s == batch_size / step_seconds``, no
    kernel of the port launched (the MSHA step is PyTorch); then the
    sharded MSHA step at world size 1 against the single-card step from
    the same weights, batch and dropout generator (first loss at
    SHARDED_MSHA_RTOL)."""
    import contextlib
    import io

    from msha_gnn_torch import cli
    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.parallel.sharded import make_sharded_msha_step
    from msha_gnn_torch.training import (TrainState, make_train_step,
                                         msha_task)

    zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--which", "scaling"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"cli bench --which scaling: rc {rc}, "
                             f"{len(lines)} lines")
    log(f"  cli bench --which scaling on {card()} ({seconds:.1f} s): "
        f"{lines[0]}")
    out = json.loads(lines[0])
    if set(out) != {"device", "scaling"} or list(out["scaling"]) != ["1"]:
        raise AssertionError(f"cli bench --which scaling: {out}")
    row = out["scaling"]["1"]
    if set(row) != SCALING_KEYS or not is_time(row["step_seconds"]) \
            or row["scaling_efficiency"] is not None \
            or row["records_per_s"] != 1024 / row["step_seconds"]:
        raise AssertionError(f"cli bench --which scaling row {row}")
    if any(read_counts().values()):
        raise AssertionError("the sharded MSHA step launched a kernel")

    fg = synthetic_flow(8192, 32, 64, 25, 65536)
    ids = np.random.default_rng(0).integers(0, fg.edge_src.numel(), 1024)
    batch = [torch.as_tensor(t.numpy()[ids], device=DEVICE)
             for t in (fg.edge_src, fg.edge_dst)]
    ones = torch.ones(1024, device=DEVICE)
    step, state, _ = make_sharded_msha_step(fg, mesh)
    sharded = float(step(state, *batch, ones,
                         torch.Generator(device=DEVICE).manual_seed(0)))
    task, model = msha_task(fg, device=DEVICE)
    single = float(make_train_step(task)(
        TrainState.create(model, task.optimizer), *batch, ones,
        torch.Generator(device=DEVICE).manual_seed(0)))
    rel = abs(sharded - single) / abs(single)
    log(f"  sharded MSHA step (world size 1) vs the single-card step, first "
        f"loss: {sharded:.7f} / {single:.7f}, rel diff {rel:.2e} (bound "
        f"{SHARDED_MSHA_RTOL})")
    if rel > SHARDED_MSHA_RTOL:
        raise AssertionError("the sharded MSHA step leaves the single-card "
                             "step")


def phase_parallel_runtime():
    """Phase 18d: ``device_health_check()`` reports ok for the card; one
    ``run_with_restarts`` around ``fault_tolerant_fit`` (MSHA, 3 epochs)
    with a failure injected in epoch 1 of the first life, and the resume
    from the epoch-1 checkpoint."""
    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.parallel import (device_health_check,
                                         fault_tolerant_fit,
                                         run_with_restarts)
    from msha_gnn_torch.training import Trainer, TrainState, msha_task

    health = device_health_check(timeout_s=60.0, device=DEVICE)
    log(f"  device_health_check: {health}")
    if not health or set(health.values()) != {"ok"}:
        raise AssertionError(f"device_health_check: {health}")
    fg = synthetic_flow(2000, 32, 40, 25, 12000)
    task, model = msha_task(fg, in_features=16, out_features=8,
                            device=DEVICE)
    src, dst = fg.edge_src.numpy(), fg.edge_dst.numpy()
    trainer = Trainer(task=task, src=src, labels=dst, batch_size=512, seed=0)
    ids = np.arange(len(src))
    lives = []

    class CrashOnce:
        def __getattr__(self, name):
            return getattr(trainer, name)

        def train_epoch(self, state, train_ids, generator, epoch):
            if not lives and epoch == 1:
                lives.append(epoch)
                raise RuntimeError("injected worker failure")
            return trainer.train_epoch(state, train_ids, generator, epoch)

    with tempfile.TemporaryDirectory() as ckpt:
        state, history, report = run_with_restarts(
            lambda: fault_tolerant_fit(
                CrashOnce(), TrainState.create(model, task.optimizer),
                ids[:8192], ids[8192:], epochs=3, checkpoint_dir=ckpt))
    epochs = [h["epoch"] for h in history]
    log(f"  run_with_restarts: {report['restarts']} restart "
        f"({report['failures'][0]['error'] if report['failures'] else ''}); "
        f"the resumed life ran epochs {epochs}, losses "
        f"{[round(h['train_loss'], 5) for h in history]}")
    if report["restarts"] != 1 or epochs != [1, 2] or \
            not all(np.isfinite(h["train_loss"]) for h in history):
        raise AssertionError(f"run_with_restarts: {report}, {epochs}")


def phase_parallel(split, scale_runs):
    """Phase 18: the parallel layer on this one card, world size 1 over
    NCCL through ``parallel.initialize()`` (no second process): 18a the
    operators, 18b ``train_distributed``, 18c ``cli bench --which
    scaling``, 18d the runtime.  Returns the kernels' entries, their
    launches those of 18a's sharded operators and 18b's fused run."""
    import torch.distributed as dist

    from msha_gnn_torch import parallel as par
    from msha_gnn_torch.parallel.mesh import backend_for

    rank, world = par.initialize(device=DEVICE)
    try:
        want = backend_for(torch.device(DEVICE))  # nccl on the card
        if (rank, world) != (0, 1) or dist.get_backend() != want:
            raise AssertionError(f"expected rank 0 of 1 over {want}, got "
                                 f"{rank} of {world} over "
                                 f"{dist.get_backend()}")
        mesh = par.make_mesh()
        log("phase 18a: the sharded operators at world size 1 (NCCL) vs the "
            "single-card operators, linkpred graph")
        kernels, per_entry = phase_parallel_ops(split, mesh)
        log(f"phase 18b: train_distributed on phase 14's graph "
            f"({SCALE_NODES} nodes, {SCALE_EDGES} edges), ScaleConfig(), "
            f"{SCALE_STEPS} steps fused and materialised")
        train_kernels, train_launches = phase_parallel_train(mesh,
                                                             scale_runs)
        kernels += train_kernels
        per_entry.update(train_launches)
        log("phase 18c: cli bench --which scaling")
        phase_parallel_bench(mesh)
        log("phase 18d: device_health_check, run_with_restarts")
        phase_parallel_runtime()
    finally:
        par.shutdown()
    for k in kernels:
        k["launches"] = per_entry[k["name"]]
    return kernels


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from msha_gnn_torch import normalize_by_dst_degree
    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.ops.cuda import _build
    from msha_gnn_torch.ops.cuda.spmm import SpmmOperator

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("phase 1: card")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; "
        "TF32 off for matmul and cudnn (full float32)")

    log("phase 2: build")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name in built:
        for line in _build.build_log(name).splitlines():
            if "ptxas info" in line:
                log(f"  {name}: {line.strip()}")

    log(f"phase 3: kernels vs plain, synthetic flow {N} x {M}, "
        f"{RECORDS} records")
    fg = synthetic_flow(N, M, N_CITY, N_PROV, RECORDS, seed=0)
    op = SpmmOperator(normalize_by_dst_degree(fg.inter).to(DEVICE), DEVICE)
    log(f"  {fg.inter.num_edges} unique edges")
    kernels = phase_kernels(op, fg)

    log("phase 3b: rank-1 GAT kernels vs plain, linkpred graph "
        "(synthetic ogbl-ddi, seed 42)")
    split = linkpred_split()
    r1_kernels = phase_rank1_kernels(split)

    log("phase 3c: materialised attention kernels vs plain, linkpred graph")
    mat_kernels = phase_materialised_kernels(split)

    log("phase 3d: flash-GAT kernels vs plain, linkpred graph")
    flash_kernels = phase_flash_kernels(split)

    log("phase 3e: generic rank-1 GAT, sorted segment sum and fused SpMM "
        "backward kernels vs plain, linkpred graph")
    generic_kernels = phase_generic_kernels(split)

    log("phase 3f: rank-1 GAT logits through csr_sddmm_f32, linkpred "
        "graph")
    logits_kernel = phase_rank1_logits(split)

    log("phase 4: GCN serving path")
    fill = phase_slice(fg)

    log("phase 5: linkpred training path (LinkPredConfig defaults)")
    step, evaluation, fused_losses = phase_linkpred(split, "fused")
    # rate 0.5 runs in training steps, rate 0 in the evaluation's encoding
    # the d = 1 column sums of dpre are the step's reduce_edges launches,
    # the q-weighted dx SpMMs its other transposed ones
    per_name = {"r1l_fwd_f32[rate 0.0]": evaluation["r1l_fwd_f32"],
                "r1l_fwd_f32[rate 0.5]": step["r1l_fwd_f32"],
                "r1l_bwd_f32[rate 0.5]": step["r1l_bwd_f32"],
                "csr_spmm_f32[r1l dx q A^T g]":
                    (step["csr_spmm_f32 transposed"]
                     - step["csr_spmm_f32 reduce_edges"]),
                "csr_spmm_f32[r1l dpre column sum]":
                    step["csr_spmm_f32 reduce_edges"]}
    for k in r1_kernels:
        k["launches"] = per_name[k["name"]]
    kernels += r1_kernels

    log("phase 6: linkpred training path, impl materialised")
    step, evaluation, losses = phase_linkpred(split, "materialised")
    follow_fused_epoch("materialised", losses, fused_losses)
    # rate 0.5 (the keep mask folded in) runs in training steps, rate 0 in
    # the evaluation's encoding
    per_name = {
        "csr_sddmm_f32[dw]": step["csr_sddmm_f32"],
        "seg_softmax_fwd_f32[rate 0.0]": evaluation["seg_softmax_fwd_f32"],
        "seg_softmax_fwd_f32[rate 0.5]":
            step["seg_softmax_fwd_f32 dropout"],
        "seg_softmax_bwd_f32[rate 0.5]":
            step["seg_softmax_bwd_f32 dropout"],
        "csr_spmm_f32[att A h]": (step["csr_spmm_f32"]
                                  - step["csr_spmm_f32 transposed"]),
        "csr_spmm_f32[att dx A^T g]": step["csr_spmm_f32 transposed"]}
    for k in mat_kernels:
        k["launches"] = per_name[k["name"]]
    kernels += mat_kernels

    log("phase 7: linkpred training path, impl flash")
    step, evaluation, losses = phase_linkpred(split, "flash")
    follow_fused_epoch("flash", losses, fused_losses)
    # rate 0.5 runs in training steps, rate 0 in the evaluation's encoding
    per_name = {"flash_fwd_f32[rate 0.0]": evaluation["flash_fwd_f32"],
                "flash_fwd_f32[rate 0.5]": step["flash_fwd_f32"],
                "flash_bwd_f32[rate 0.5]": step["flash_bwd_f32"],
                "csr_spmm_f32[flash dx]": step["csr_spmm_f32 transposed"]}
    for k in flash_kernels:
        k["launches"] = per_name[k["name"]]
    kernels += flash_kernels

    log("phase 8: generic rank-1 GAT, fused SpMM backward and sorted "
        "segment sum through their operators")
    per_name = phase_operators(split)
    for k in generic_kernels:
        k["launches"] = per_name[k["name"]]
    kernels += generic_kernels
    kernels.append(logits_kernel)

    log("phase 9: MSHA serving path (TrainConfig defaults)")
    phase_msha(fg)

    log("phase 10: flow-model training (cli train / eval, TrainConfig "
        "defaults)")
    trained = phase_train(fg)
    # the GCN forwards: a serving fill and the training runs' forwards; the
    # x gradients: the training steps
    per_name = {
        "csr_spmm_f32[gc1 A^T x]": fill["transposed"]
        + trained["fwd_transposed"],
        "csr_spmm_f32[gc2 A x]": fill["plain"] + trained["fwd_plain"],
        "csr_spmm_f32[gc2 dx A^T g]": trained["bwd_transposed"],
        "csr_spmm_f32[gc1 dx A g]": trained["bwd_plain"]}
    for k in kernels[:4]:
        del k["transpose"]
        k["launches"] = per_name[k["name"]]

    log("phase 11: the other flow presets (gat, sage, hgane; TrainConfig "
        "defaults)")
    phase_flow_presets(fg)

    log("phase 12: the bfloat16 payload's kernels vs plain, linkpred graph")
    bf16_kernels, dw_bf16 = phase_bf16_kernels(split)

    log("phase 13: a SparseGAT(precision='bf16') linkpred training step "
        "(LinkPredConfig defaults)")
    steps16 = phase_bf16_step(split)
    per_name = {"csr_spmm_bf16": (steps16["fused"]["csr_spmm_bf16"]
                                  + steps16["materialised"]["csr_spmm_bf16"]),
                "csr_spmm_dw_bf16": dw_bf16,
                "r1l_fwd_bf16": steps16["fused"]["r1l_fwd_bf16"],
                "r1l_bwd_bf16": steps16["fused"]["r1l_bwd_bf16"]}

    log("phase 14: out-of-core training (train_chunked, ScaleConfig "
        "defaults, 50 M edges)")
    launches14, scale_runs = phase_out_of_core()
    per_name.update(launches14)
    for k in bf16_kernels:
        k["launches"] = per_name[k["name"]]
    kernels += bf16_kernels

    t15 = time.perf_counter()
    log(f"phase 15a: sampled linkpred (neighbor_fanout {SAMPLED_FANOUT}, "
        "LinkPredConfig defaults, fused on per-epoch subgraphs)")
    kernels += phase_sampled_linkpred(split)
    log("phase 15b: a KD linkpred step (use_kd, sampled subgraph)")
    phase_sampled_kd(split)
    log("phase 15c: LLP (run_llp, LLPConfig defaults) on the phase-3 graph")
    phase_llp(fg)
    log("phase 15d: SGAE (run_sgae, temporal pretrain) on the phase-3 graph")
    phase_sgae(fg)
    log(f"  phase 15: {time.perf_counter() - t15:.1f} s")

    t16 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        log("phase 16a: a dataset from raw records (anonymize, "
            "write_anonymous_dataset, load_flow_graph)")
        data_dir, train_dir = phase_raw_dataset(td)
        log(f"phase 16b: cli train --years {','.join(TEMPORAL_YEARS)} "
            f"(TrainConfig defaults, 1 epoch, the first {TEMPORAL_RECORDS} "
            "records a year)")
        phase_temporal(train_dir)
        log("phase 16c: cli explain --npz_path on 2015")
        phase_explain(data_dir, td)
        log("phase 16d: cli export (gcn table through csr_spmm_f32, msha "
            "batches)")
        exported = phase_export(data_dir, td)
        log("phase 16e: the NaN guard")
        phase_nan_guard(data_dir)
        log(f"  phase 16: {time.perf_counter() - t16:.1f} s")

        t17 = time.perf_counter()
        log(f"phase 17a: csr_spmm_f32 and csr_sddmm_f32 at d {BENCH_D} on "
            f"the benchmark's power-law graph ({BENCH_EDGES} edges)")
        bench_kernels = phase_bench_kernels()
        log(f"phase 17b: the attention paths, sparse (the kernels) vs "
            f"dense, on the 2015 inter graph at d {ATTENTION_D}")
        kernels += phase_bench_attention(data_dir)
        log("phase 17c: cli bench --which all, bench_serving, "
            "bench_flagship_size_sweep")
        bench_launches = phase_cli_bench(data_dir)
        for k in bench_kernels:
            k["launches"] = bench_launches[k["name"].split("[")[0]]
        kernels += bench_kernels
        log(f"  phase 17: {time.perf_counter() - t17:.1f} s")

        t18 = time.perf_counter()
        kernels += phase_parallel(split, scale_runs)
        scale_runs = None
        log(f"  phase 18: {time.perf_counter() - t18:.1f} s")
    # the exported GCN table's call: gc1 transposed, gc2 plain
    for k in kernels:
        if k["name"] == "csr_spmm_f32[gc1 A^T x]":
            k["launches"] += exported["gc1"]
        elif k["name"] == "csr_spmm_f32[gc2 A x]":
            k["launches"] += exported["gc2"]
    log(f"  script: {time.perf_counter() - t_start:.1f} s")
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{kernels}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
