"""Device milliseconds a backward in the out-of-core attention layer's
``dx`` passes (a slice each: the ``q`` gather, the two transposed
``csr_spmm`` calls with their fix-up grids, the ``index_add_``): the mean
of the CUDA events of the port's spans ``msha.r1gat.bwd.dx`` times the
passes a call of ``msha.r1gat.bwd`` makes (``msha_gnn_torch.utils.prof``),
in every unprofiled step after the first."""

LAYER = "operator: ops/chunked_rank1.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "step_ms"
BETTER = "lower"


def read(ctx):
    from msha_gnn_torch.utils import prof

    if not hasattr(prof, "device_ms"):  # a port without its spans
        return None
    spent = prof.device_ms("msha.r1gat.bwd.dx")
    passes = prof.device_calls("msha.r1gat.bwd.dx")
    backwards = prof.device_calls("msha.r1gat.bwd")
    if spent is None or not passes or not backwards:
        return None
    # each name's first call is set aside: the first backward's later
    # passes are counted, so the passes a backward are rounded
    return spent / passes * round(passes / backwards)
