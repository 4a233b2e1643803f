"""Command-line entry points: ``python -m msha_gnn_torch.cli <cmd>``.

Commands of ``msha_gnn_tpu/cli.py`` with the same flags, plus
``--device``: ``train`` (flow classification: train, evaluate every epoch,
optionally checkpoint; ``--years`` trains MSHA jointly over several
years), ``eval`` (evaluate a checkpoint), ``predict`` (batch inference
from a checkpoint), ``export`` (a checkpoint's scorer as a
``torch.export`` artifact), ``serve`` (HTTP server from a checkpoint),
``explain`` (attention top-K extraction), ``linkpred`` (ogbl-ddi-style
link prediction, trained and evaluated), ``llp`` (KD link prediction on
the flow graph) and ``sgae`` (autoencoder pretrain and GraphSAGE
fine-tune).  The port has every model preset of the JAX package
(:data:`PORTED_MODELS`); a ``linkpred --impl`` the port lacks exits with
code 2.  ``cli bench`` is not ported yet.  With the environment variable
``MSHA_NAN_GUARD`` set, every command runs under
:func:`~msha_gnn_torch.utils.debug.nan_guard`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

MSHA_PRESETS = ("msha", "ours", "ablation1", "ablation2", "ablation3")
PORTED_MODELS = (*MSHA_PRESETS, "gat", "gcn", "hgane", "sage")


def _add_dataclass_args(parser, cls):
    for f in dataclasses.fields(cls):
        if f.type in ("int", int):
            parser.add_argument(f"--{f.name}", type=int, default=f.default)
        elif f.type in ("float", float):
            parser.add_argument(f"--{f.name}", type=float, default=f.default)
        elif f.type in ("str", str, "Optional[str]"):
            parser.add_argument(f"--{f.name}", type=str, default=f.default)
        elif f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}",
                                action=argparse.BooleanOptionalAction,
                                default=f.default)


def _config_from_args(cls, args):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})


def _build_task(cfg, fg, device="cuda"):
    """Model-preset dispatch: ``(task, model)``, or None for a model the
    port does not have."""
    from .training import gat_task, gcn_task, hgane_task, msha_task, sage_task

    if cfg.model in MSHA_PRESETS:
        flags = cfg.model_flags()
        n_heads = flags.pop("n_heads", cfg.n_heads)
        return msha_task(fg, in_features=cfg.in_features,
                         out_features=cfg.out_features, n_heads=n_heads,
                         dropout=cfg.dropout, lr=cfg.lr,
                         weight_decay=cfg.weight_decay, seed=cfg.seed,
                         device=device, **flags)
    common = dict(dropout=cfg.dropout, lr=cfg.lr,
                  weight_decay=cfg.weight_decay, seed=cfg.seed, device=device)
    if cfg.model == "gat":
        return gat_task(fg, n_heads=cfg.n_heads, **common)
    if cfg.model == "gcn":
        return gcn_task(fg, nfeat=cfg.in_features, **common)
    if cfg.model == "hgane":
        return hgane_task(fg, in_features=cfg.in_features,
                          out_features=cfg.out_features, **common)
    if cfg.model == "sage":
        return sage_task(fg, in_features=cfg.in_features, **common)
    return None


def _ported_config(args, cmd: str, needs_checkpoint: bool = True):
    """The config of ``args``, or None after a message on stderr."""
    from .utils import TrainConfig

    cfg = _config_from_args(TrainConfig, args)
    if cfg.model not in PORTED_MODELS:
        verb = "trains" if cmd in ("train", "eval") else "serves"
        print(f"model {cfg.model!r} is not ported; msha_gnn_torch {verb}: "
              f"{', '.join(PORTED_MODELS)}", file=sys.stderr)
        return None
    if needs_checkpoint and not cfg.checkpoint_dir:
        print(f"{cmd} requires --checkpoint_dir", file=sys.stderr)
        return None
    return cfg


def cmd_train(args) -> int:
    """Train a flow model, evaluating after every epoch; prints the last
    epoch's record as JSON and, with ``--checkpoint_dir``, saves the
    model, its optimiser and the step.  ``--years 2015,2016,...`` trains
    an MSHA preset jointly over those years instead
    (``training/temporal.py``) and prints the last epoch's per-year
    reports."""
    from .data import load_flow_graph, train_test_split_records
    from .training import Trainer, TrainState, save_checkpoint
    from .utils import JsonlLogger

    cfg = _ported_config(args, "train", needs_checkpoint=False)
    if cfg is None:
        return 2
    log = JsonlLogger(cfg.log_path)
    years = [y for y in (cfg.years or "").split(",") if y]
    if years:
        # joint multi-year MSHA training (BASELINE config #3)
        if cfg.model not in MSHA_PRESETS:
            print("--years joint training supports the MSHA family only",
                  file=sys.stderr)
            return 2
        from .training import run_temporal_train

        flags = cfg.model_flags()
        n_heads = flags.pop("n_heads", cfg.n_heads)
        _, history = run_temporal_train(
            years=tuple(years), data_dir=cfg.data_dir, log=log,
            device=args.device, in_features=cfg.in_features,
            out_features=cfg.out_features, n_heads=n_heads,
            dropout=cfg.dropout, epochs=cfg.epochs,
            batch_size=cfg.batch_size, lr=cfg.lr,
            weight_decay=cfg.weight_decay,
            train_fraction=cfg.train_fraction, seed=cfg.seed, **flags)
        print(json.dumps(history[-1]))
        return 0
    fg = load_flow_graph(cfg.year, cfg.data_dir)
    log({"event": "data", "n": fg.n_src, "m": fg.n_dst,
         "records": fg.num_records, "edges": fg.inter.num_edges})
    if fg.num_records == 0:
        print(
            f"year {cfg.year} has no Flow records in {cfg.data_dir} "
            "(Flow2016-2018.csv are absent upstream — see "
            ".MISSING_LARGE_BLOBS); only 2015 is trainable as shipped",
            file=sys.stderr,
        )
        return 2
    task, model = _build_task(cfg, fg, args.device)
    train_ids, test_ids = train_test_split_records(
        fg.num_records, cfg.train_fraction, cfg.seed)
    state = TrainState.create(model, task.optimizer)
    trainer = Trainer(task=task, src=fg.edge_src.numpy(),
                      labels=fg.edge_dst.numpy(), batch_size=cfg.batch_size,
                      seed=cfg.seed, log=log)
    state, history = trainer.fit(state, train_ids, test_ids, cfg.epochs,
                                 profile_dir=cfg.profile_dir)
    if cfg.checkpoint_dir:
        save_checkpoint(cfg.checkpoint_dir, state, step=state.step)
    print(json.dumps(history[-1]))
    return 0


def cmd_eval(args) -> int:
    """Evaluate a checkpoint on the held-out records (no training); prints
    the metric block and ``checkpoint_step`` as JSON."""
    from .data import load_flow_graph, train_test_split_records
    from .training import Trainer, TrainState, latest_step, restore_checkpoint

    cfg = _ported_config(args, "eval")
    if cfg is None:
        return 2
    if latest_step(cfg.checkpoint_dir) is None:
        print(f"no checkpoint under {cfg.checkpoint_dir}", file=sys.stderr)
        return 2
    fg = load_flow_graph(cfg.year, cfg.data_dir)
    task, model = _build_task(cfg, fg, args.device)
    state, _, step = restore_checkpoint(
        cfg.checkpoint_dir, TrainState.create(model, task.optimizer))
    _, test_ids = train_test_split_records(
        fg.num_records, cfg.train_fraction, cfg.seed)
    trainer = Trainer(task=task, src=fg.edge_src.numpy(),
                      labels=fg.edge_dst.numpy(), batch_size=cfg.batch_size,
                      seed=cfg.seed)
    metrics = trainer.evaluate(state, test_ids)
    metrics["checkpoint_step"] = int(step)
    print(json.dumps(metrics))
    return 0


def cmd_predict(args) -> int:
    """Batch inference from a checkpoint."""
    from .serving import run_predict

    cfg = _ported_config(args, "predict")
    if cfg is None:
        return 2
    summary = run_predict(cfg, nodes=args.nodes, top_k=args.top_k,
                          output=args.output or None,
                          batch_size=args.predict_batch, device=args.device)
    print(json.dumps(summary))
    return 0


def cmd_export(args) -> int:
    """Write a checkpoint's scorer as a ``torch.export`` artifact
    (``export.py``); prints a summary as JSON."""
    from .export import run_export

    cfg = _ported_config(args, "export")
    if cfg is None:
        return 2
    summary = run_export(cfg, output=args.output, kind=args.kind,
                         batch_size=args.predict_batch,
                         portable=bool(args.portable), device=args.device)
    print(json.dumps(summary))
    return 0


def cmd_serve(args) -> int:
    """HTTP model server from a checkpoint (see ``server.py``)."""
    from .server import run_serve

    cfg = _ported_config(args, "serve")
    if cfg is None:
        return 2
    run_serve(cfg, host=args.host, port=args.port,
              batch_size=args.predict_batch, device=args.device)
    return 0


def cmd_explain(args) -> int:
    """Train MSHA briefly, record its attention and write the top-K
    explanation JSON (``explain.py``)."""
    from .explain import run_explain

    out = run_explain(year=args.year, data_dir=args.data_dir,
                      model=args.model, epochs=args.epochs,
                      top_k=args.top_k, output=args.output,
                      npz_path=args.npz_path, device=args.device)
    print(json.dumps({"written": out}))
    return 0


def cmd_linkpred(args) -> int:
    """Train and evaluate link prediction; prints the result as JSON."""
    from .data.ogb import load_ddi, split_edges
    from .models.gat import IMPLS
    from .training.link_prediction import LinkPredConfig, run_link_prediction
    from .utils import JsonlLogger

    if args.impl not in ("auto", *IMPLS):
        print(f"not ported: --impl {args.impl} (the port has auto, "
              f"{', '.join(IMPLS)})", file=sys.stderr)
        return 2
    data = load_ddi(root=args.ogb_root, seed=args.seed)
    split = split_edges(data, seed=args.seed)
    cfg = LinkPredConfig(
        hidden=args.hidden, n_heads=args.n_heads, dropout=args.dropout,
        lr=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        neighbor_fanout=args.neighbor_fanout, use_kd=bool(args.use_kd),
        seed=args.seed, impl=args.impl,
    )
    result = run_link_prediction(split, cfg, log=JsonlLogger(args.log_path),
                                 device=args.device)
    print(json.dumps(result))
    return 0


def cmd_llp(args) -> int:
    """Train and evaluate KD link prediction; prints the result as JSON."""
    from .training.kd import run_llp
    from .utils import JsonlLogger, LLPConfig

    cfg = _config_from_args(LLPConfig, args)
    result = run_llp(cfg, log=JsonlLogger(cfg.log_path), device=args.device)
    print(json.dumps(result))
    return 0


def cmd_sgae(args) -> int:
    """Autoencoder pretrain, then the GraphSAGE fine-tune; prints the
    pretrain losses and the last epoch's record as JSON."""
    from .training.sgae import run_sgae
    from .utils import JsonlLogger, SGAEConfig

    cfg = _config_from_args(SGAEConfig, args)
    result = run_sgae(cfg, log=JsonlLogger(cfg.log_path), device=args.device)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    from .data.flow import DEFAULT_DATA_DIR
    from .utils import LLPConfig, SGAEConfig, TrainConfig
    from .utils.debug import nan_guard_from_env

    nan_guard_from_env()
    parser = argparse.ArgumentParser(prog="msha_gnn_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train a flow model")
    _add_dataclass_args(p_train, TrainConfig)
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("eval", help="evaluate a checkpoint")
    _add_dataclass_args(p_eval, TrainConfig)
    p_eval.set_defaults(fn=cmd_eval)

    p_pred = sub.add_parser(
        "predict", help="batch inference from a checkpoint"
    )
    _add_dataclass_args(p_pred, TrainConfig)
    p_pred.add_argument("--nodes", default="all",
                        help="'all', comma list, or @file of indices")
    p_pred.add_argument("--output", default=None,
                        help="JSONL path (default stdout)")
    p_pred.add_argument("--predict_batch", type=int, default=1024)
    p_pred.set_defaults(fn=cmd_predict)

    p_xp = sub.add_parser(
        "export", help="a torch.export scorer artifact from a checkpoint"
    )
    _add_dataclass_args(p_xp, TrainConfig)
    p_xp.add_argument("--output", default="scorer.mshax")
    p_xp.add_argument("--kind", default="auto",
                      choices=["auto", "table", "batch"])
    p_xp.add_argument("--predict_batch", type=int, default=1024)
    p_xp.add_argument("--portable", type=int, default=0,
                      help="1: loadable on both cpu and cuda")
    p_xp.set_defaults(fn=cmd_export)

    p_srv = sub.add_parser(
        "serve", help="HTTP model server from a checkpoint"
    )
    _add_dataclass_args(p_srv, TrainConfig)
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8000)
    p_srv.add_argument("--predict_batch", type=int, default=1024)
    p_srv.set_defaults(fn=cmd_serve)

    p_exp = sub.add_parser("explain", help="attention top-K extraction")
    p_exp.add_argument("--year", default="2015")
    p_exp.add_argument("--data_dir", default=DEFAULT_DATA_DIR)
    p_exp.add_argument("--model", default="msha")
    p_exp.add_argument("--epochs", type=int, default=1)
    p_exp.add_argument("--top_k", type=int, default=100)
    p_exp.add_argument("--output", default="explain.json")
    p_exp.add_argument("--npz_path", default=None)
    p_exp.set_defaults(fn=cmd_explain)

    p_llp = sub.add_parser("llp", help="KD link prediction")
    _add_dataclass_args(p_llp, LLPConfig)
    p_llp.set_defaults(fn=cmd_llp)

    p_sgae = sub.add_parser("sgae", help="autoencoder pretrain + fine-tune")
    _add_dataclass_args(p_sgae, SGAEConfig)
    p_sgae.set_defaults(fn=cmd_sgae)

    p_lp = sub.add_parser("linkpred",
                          help="OGBL-DDI-style link prediction at scale")
    p_lp.add_argument("--ogb_root", default=None)
    p_lp.add_argument("--hidden", type=int, default=64)
    p_lp.add_argument("--n_heads", type=int, default=2)
    p_lp.add_argument("--dropout", type=float, default=0.5)
    p_lp.add_argument("--lr", type=float, default=5e-3)
    p_lp.add_argument("--epochs", type=int, default=10)
    p_lp.add_argument("--batch_size", type=int, default=4096)
    p_lp.add_argument("--neighbor_fanout", type=int, default=0)
    p_lp.add_argument("--use_kd", type=int, default=0)
    p_lp.add_argument("--seed", type=int, default=42)
    p_lp.add_argument("--impl", default="auto",
                      help="auto (fused on cuda, torch on cpu) | torch | "
                           "fused | materialised | flash")
    p_lp.add_argument("--log_path", default=None)
    p_lp.set_defaults(fn=cmd_linkpred)

    for p in (p_train, p_eval, p_pred, p_xp, p_srv, p_exp, p_llp, p_sgae,
              p_lp):
        p.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
