"""Host milliseconds a step in ``scale.draw_batch`` outside its copies to
the device: the port's span ``msha.scale.batch`` less
``msha.scale.batch.copy`` (which holds the pageable copies' wait for the
previous step), over the calls of ``msha.scale.batch``
(``msha_gnn_torch.utils.prof``), in every unprofiled step after the
first.  The draws, the indexing and the host tensors, timed inside the
port and not stretched by a profiler."""

LAYER = "loop: training/scale.py, training/link_prediction.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "step_ms"
BETTER = "lower"


def read(ctx):
    from msha_gnn_torch.utils import prof

    if not hasattr(prof, "host_seconds"):  # a port without its spans
        return None
    whole = prof.host_seconds("msha.scale.batch")
    copy = prof.host_seconds("msha.scale.batch.copy")
    steps = prof.calls("msha.scale.batch")
    if whole is None or copy is None or not steps:
        return None
    return (whole - copy) * 1e3 / steps
