"""Rank programs of the distributed tests, and their launcher.

:func:`spawn` starts ``world`` processes of ``python -m
tests.torch_parallel_workers <task> <dir> <rank> <world>`` on the CPU,
each joining one gloo group through a file store in ``dir`` (no port),
with a hard deadline: a rank that hangs fails the test instead of
hanging it.  Each rank reads the inputs the test wrote (``inputs.pt``),
runs the task on its mesh and writes its results (``out_<rank>.pt``).
The ranks import torch and the port only; the JAX side of a comparison
runs in the pytest process.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 120.0


def spawn(task: str, inputs: dict, world: int, workdir) -> list:
    """Run ``task`` on ``world`` gloo ranks -> every rank's results, in
    rank order.  Raises if a rank fails or the deadline passes."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_workers", task,
         str(workdir), str(rank), str(world)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    deadline = time.monotonic() + DEADLINE_S
    logs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 0.1)
            out, _ = p.communicate(timeout=left)
            logs.append(out)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{task} at world size {world} passed its "
                             f"{DEADLINE_S} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{task} rank {rank}/{world} exited "
                                 f"{p.returncode}:\n{log}")
    return [torch.load(workdir / f"out_{rank}.pt", weights_only=False)
            for rank in range(world)]


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _graph(a):
    from msha_gnn_torch.graph import BipartiteGraph

    return BipartiteGraph.from_coo(a["s"], a["r"], a["w"], n_src=a["n_src"],
                                   n_dst=a["n_dst"])


def _spmm_case(op, mesh, x, ct, n_out, w=None, **kw):
    """An operator's gathered output and the whole gradients of
    ``sum(out * ct)`` with respect to ``x`` and the runtime weights."""
    from msha_gnn_torch.parallel.comm import gather_rows, scatter_rows

    x = torch.tensor(x, requires_grad=True)
    w = None if w is None else torch.tensor(w, requires_grad=True)
    out = gather_rows(op(scatter_rows(x, mesh), edge_weight=w, **kw),
                      n_out, mesh)
    (out * torch.tensor(ct)).sum().backward()
    return {"out": _np(out), "dx": _np(x.grad),
            "dw": None if w is None else _np(w.grad)}


def task_ops(inp, mesh):
    from msha_gnn_torch.parallel import (DistributedSpmm, RingSpmm,
                                         ShardedCsrSpmm, ShardedRank1Gat)
    from msha_gnn_torch.parallel.comm import gather_rows, scatter_rows

    a = inp["graph"]
    g = _graph(a)
    n_src, n_dst = a["n_src"], a["n_dst"]
    res = {}
    ops = {"dist": DistributedSpmm(g, mesh),
           "ring": RingSpmm(g, mesh, runtime_weights=True),
           "ring_static": RingSpmm(g, mesh),
           "csr": ShardedCsrSpmm(g, mesh)}
    for name, op in ops.items():
        res[f"{name}/static"] = _spmm_case(op, mesh, inp["x"], inp["ct"],
                                           n_src)
        if name == "ring_static":
            continue
        res[f"{name}/weighted"] = _spmm_case(op, mesh, inp["x"], inp["ct"],
                                             n_src, w=inp["w"])
        if name == "csr":
            continue
        res[f"{name}/transpose"] = _spmm_case(
            op, mesh, inp["xt"], inp["ctt"], n_dst, w=inp["w"],
            transpose=True)
    r1 = inp["rank1"]
    gs = _graph(r1["graph"])
    op = ShardedRank1Gat(gs, mesh, negative_slope=0.2)
    n = r1["graph"]["n_src"]
    c, av, x = (torch.tensor(r1[k], requires_grad=True)
                for k in ("c", "a", "x"))
    out = gather_rows(op(scatter_rows(c, mesh), av, scatter_rows(x, mesh)),
                      n, mesh)
    (out * torch.tensor(r1["ct"])).sum().backward()
    res["rank1"] = {"out": _np(out), "dc": _np(c.grad), "da": _np(av.grad),
                    "dx": _np(x.grad)}
    return res


def port_flow(a):
    """The port's flow graph of ``tests/test_torch_gcn.py::flow_arrays``."""
    import msha_gnn_torch.graph as tg

    inter = tg.BipartiteGraph.from_coo(
        a["src"], a["dst"], np.ones(len(a["src"]), np.float32),
        n_src=a["n"], n_dst=a["m"], pad_to_multiple=a["pad"])
    return tg.FlowGraph(
        inter=inter, city=tg.Grouping.from_ids(a["city"]),
        province=tg.Grouping.from_ids(a["prov"]),
        gdp=torch.from_numpy(a["gdp"]), edge_src=torch.from_numpy(a["src"]),
        edge_dst=torch.from_numpy(a["dst"]))


def load_whole(model, placements, state_dict):
    """Copy a whole model's ``state_dict`` into a sharded one: a
    row-sharded tensor's rows of this rank, every other tensor whole."""
    with torch.no_grad():
        for name, full in state_dict.items():
            t = model.get_parameter(name) if name in dict(
                model.named_parameters()) else model.get_buffer(name)
            t.copy_(placements[name].local(full))


def _gathered_state(model, placements, n, mesh):
    from msha_gnn_torch.parallel.comm import gather_rows

    out = {}
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        out[name] = _np(gather_rows(t.detach(), n, mesh)
                        if placements[name].rows else t)
    return out


def task_train(inp, mesh):
    from msha_gnn_torch.data import split_edges, synthetic_ddi
    from msha_gnn_torch.parallel import (make_sharded_linkpred_step,
                                         make_sharded_msha_step)
    from msha_gnn_torch.training import scale

    res = {}
    # MSHA presets at dropout 0.5 (masks from one generator); full MSHA
    # also at dropout 0 from the JAX weights
    fg = port_flow(inp["flow"])
    batches = [inp["msha_batches"][k] for k in ("batch", "labels", "weights")]
    for preset, kw in inp["msha_presets"].items():
        step, state, place = make_sharded_msha_step(fg, mesh, **kw)
        gen = torch.Generator().manual_seed(0)
        res[f"msha/{preset}/losses"] = [float(step(state, *b, gen))
                                        for b in zip(*batches)]
        res[f"msha/{preset}/state"] = _gathered_state(state.model, place,
                                                      fg.n_src, mesh)
    step, state, place = make_sharded_msha_step(
        port_flow(inp["flow_jax"]), mesh, **inp["msha_presets"]["msha"],
        dropout=0.0)
    load_whole(state.model, place, inp["msha_jax_state"])
    res["msha_jax_loss"] = float(step(state, *(b[0] for b in batches)))
    # parameters other than Sfeatures with n_src rows
    c = inp["msha_collide"]
    step, state, place = make_sharded_msha_step(
        port_flow(c["flow"]), mesh, **inp["msha_presets"]["msha"],
        dropout=0.0)
    res["msha_collide/rows"] = sorted(n for n, p in place.items() if p.rows)
    load_whole(state.model, place, c["jax_state"])
    res["msha_collide_jax_loss"] = float(step(state, *c["batch"]))

    # link prediction: the JAX weights at dropout 0, then dropout 0.5
    # (32 positives and 32 negatives, then 96 negatives)
    lp = inp["linkpred"]
    split = split_edges(synthetic_ddi(**lp["ddi"]), **lp["split"])
    for key, tag in (("batch", "linkpred"), ("unequal", "linkpred_unequal")):
        batch = [torch.from_numpy(v) for v in lp[key]]
        step, (model, opt, graph), place = make_sharded_linkpred_step(
            split, mesh, **lp["kwargs"])
        load_whole(model, place, lp["jax_state"])
        res[f"{tag}_jax_loss"] = float(step(model, opt, graph, *batch))
        step, (model, opt, graph), place = make_sharded_linkpred_step(
            split, mesh, **lp["kwargs"], dropout=0.5)
        gen = torch.Generator().manual_seed(0)
        res[f"{tag}_losses"] = [float(step(model, opt, graph, *batch, gen))
                                for _ in range(2)]

    # out-of-core model over the partition: train_distributed, and the
    # JAX initial parameters through the same loss, on the edges in
    # (sender, receiver) order and shuffled
    sc = inp["scale"]
    cfg = scale.ScaleConfig(**sc["cfg"])
    for fused in (True, False):
        key = "fused" if fused else "materialised"
        for edges in ("", "_shuffled"):
            s, r = sc[f"s{edges}"], sc[f"r{edges}"]
            res[f"scale{edges}/{key}"] = scale.train_distributed(
                s, r, sc["n"], mesh, cfg, fused=fused)
            loss_fn, s, r, _ = scale.build_distributed(s, r, sc["n"], mesh,
                                                       cfg, fused=fused)
            res[f"scale{edges}_edges/{key}"] = np.stack([s, r])
            params = {k: torch.from_numpy(v)
                      for k, v in sc["jax_params"].items()}
            res[f"scale_jax{edges}/{key}"] = scale._train(
                loss_fn, params, s, r, sc["n"], cfg)["loss_history"]
    return res


TASKS = {"ops": task_ops, "train": task_train}


def main(argv) -> int:
    task, workdir, rank, world = argv
    from msha_gnn_torch.parallel import initialize, make_mesh, shutdown

    workdir = pathlib.Path(workdir)
    initialize(f"file://{workdir / 'store'}", int(world), int(rank),
               device="cpu", timeout_s=DEADLINE_S)
    try:
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        out = TASKS[task](inputs, make_mesh(device="cpu"))
        torch.save(out, workdir / f"out_{rank}.pt")
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
