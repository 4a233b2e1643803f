"""Device milliseconds a step in ``scale.draw_batch``'s four copies to the
card: the CUDA events of the port's span ``msha.scale.batch.copy`` over
its calls (``msha_gnn_torch.utils.prof``), from the stream reaching the
first copy to the end of the last, in every unprofiled step after the
first.  The host's wait for the previous step, which a copy from pageable
memory makes, lies before the first event and is not in it; the host's
turn between the four synchronous copies is.  The copies' bytes and the
memory they come from move it; the device's compute and the host's other
work do not."""

LAYER = "loop: training/scale.py, training/link_prediction.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "step_ms"
BETTER = "lower"


def read(ctx):
    from msha_gnn_torch.utils import prof

    if not hasattr(prof, "device_ms"):  # a port without its spans
        return None
    spent = prof.device_ms("msha.scale.batch.copy")
    calls = prof.device_calls("msha.scale.batch.copy")
    if spent is None or not calls:
        return None
    return spent / calls
