"""Device milliseconds a call of the out-of-core attention layer's forward
(``ChunkedRank1Gat.forward_state``: every slice's ``r1l_fwd`` and the
merges): the CUDA events of the port's span ``msha.r1gat.fwd`` over its
calls (``msha_gnn_torch.utils.prof``), in every unprofiled step after the
first.  The stream's wall between them: the kernels, and the card's idle
while the host enqueues them."""

LAYER = "operator: ops/chunked_rank1.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "step_ms"
BETTER = "lower"


def read(ctx):
    from msha_gnn_torch.utils import prof

    if not hasattr(prof, "device_ms"):  # a port without its spans
        return None
    spent = prof.device_ms("msha.r1gat.fwd")
    calls = prof.device_calls("msha.r1gat.fwd")
    if spent is None or not calls:
        return None
    return spent / calls
