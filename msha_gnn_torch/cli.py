"""Command-line entry points: ``python -m msha_gnn_torch.cli <cmd>``.

Commands of ``msha_gnn_tpu/cli.py`` with the same flags, plus
``--device``: ``predict`` (batch inference from a checkpoint), ``serve``
(HTTP server from a checkpoint) and ``linkpred`` (ogbl-ddi-style link
prediction, trained and evaluated).  The port serves the models in
:data:`PORTED_MODELS`; any other model, and any ``linkpred`` option that is
not ported, exits with code 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

MSHA_PRESETS = ("msha", "ours", "ablation1", "ablation2", "ablation3")
PORTED_MODELS = (*MSHA_PRESETS, "gcn")


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
    from .training import gcn_task, msha_task

    if cfg.model in MSHA_PRESETS:
        flags = cfg.model_flags()
        n_heads = flags.pop("n_heads", cfg.n_heads)
        return msha_task(fg, in_features=cfg.in_features,
                         out_features=cfg.out_features, n_heads=n_heads,
                         dropout=cfg.dropout, seed=cfg.seed, device=device,
                         **flags)
    if cfg.model == "gcn":
        return gcn_task(fg, nfeat=cfg.in_features, dropout=cfg.dropout,
                        seed=cfg.seed, device=device)
    return None


def _serving_config(args, cmd: str):
    """The config of ``args``, or None after a message on stderr."""
    from .utils import TrainConfig

    cfg = _config_from_args(TrainConfig, args)
    if cfg.model not in PORTED_MODELS:
        print(f"model {cfg.model!r} is not ported; msha_gnn_torch serves: "
              f"{', '.join(PORTED_MODELS)}", file=sys.stderr)
        return None
    if not cfg.checkpoint_dir:
        print(f"{cmd} requires --checkpoint_dir", file=sys.stderr)
        return None
    return cfg


def cmd_predict(args) -> int:
    """Batch inference from a checkpoint."""
    from .serving import run_predict

    cfg = _serving_config(args, "predict")
    if cfg is None:
        return 2
    summary = run_predict(cfg, nodes=args.nodes, top_k=args.top_k,
                          output=args.output or None,
                          batch_size=args.predict_batch, device=args.device)
    print(json.dumps(summary))
    return 0


def cmd_serve(args) -> int:
    """HTTP model server from a checkpoint (see ``server.py``)."""
    from .server import run_serve

    cfg = _serving_config(args, "serve")
    if cfg is None:
        return 2
    run_serve(cfg, host=args.host, port=args.port,
              batch_size=args.predict_batch, device=args.device)
    return 0


def cmd_linkpred(args) -> int:
    """Train and evaluate link prediction; prints the result as JSON."""
    from .data.ogb import load_ddi, split_edges
    from .models.gat import IMPLS
    from .training.link_prediction import LinkPredConfig, run_link_prediction
    from .utils import JsonlLogger

    unported = []
    if args.neighbor_fanout > 0:
        unported.append("--neighbor_fanout > 0 (data/sampler.py)")
    if args.use_kd:
        unported.append("--use_kd (training/kd.py)")
    if args.impl not in ("auto", *IMPLS):
        unported.append(f"--impl {args.impl} (the port has auto, "
                        f"{', '.join(IMPLS)})")
    if unported:
        print(f"not ported: {'; '.join(unported)}", file=sys.stderr)
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


def main(argv=None) -> int:
    from .utils import TrainConfig

    parser = argparse.ArgumentParser(prog="msha_gnn_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

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

    p_srv = sub.add_parser(
        "serve", help="HTTP model server from a checkpoint"
    )
    _add_dataclass_args(p_srv, TrainConfig)
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8000)
    p_srv.add_argument("--predict_batch", type=int, default=1024)
    p_srv.set_defaults(fn=cmd_serve)

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

    for p in (p_pred, p_srv, p_lp):
        p.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
