"""Device milliseconds a call of the out-of-core attention layer's
backward (``ChunkedRank1Gat.backward_state``: every slice's ``r1l_bwd``
and ``dx``): the CUDA events of the port's span ``msha.r1gat.bwd`` over
its calls (``msha_gnn_torch.utils.prof``), in every unprofiled step after
the first."""

LAYER = "operator: ops/chunked_rank1.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "step_ms"
BETTER = "lower"


def read(ctx):
    from msha_gnn_torch.utils import prof

    if not hasattr(prof, "device_ms"):  # a port without its spans
        return None
    spent = prof.device_ms("msha.r1gat.bwd")
    calls = prof.device_calls("msha.r1gat.bwd")
    if spent is None or not calls:
        return None
    return spent / calls
