"""The share of the measured window's step time in which no operation ran
on the device: 100 (1 - busy a step / ``step_ms``), the busy time a step
the union of the device operations' intervals in the device-only trace
over its steps.  Kernel durations do not stretch when tracing slows the
host, the gaps between them do, so the busy time is taken from the trace
and the step time from the untraced window."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "step_ms"
BETTER = "lower"


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0 or not ctx["step_ms"]:
        return None
    busy_ms = tr["busy_s"] * 1e3 / tr["steps"]
    return 100.0 * (1.0 - busy_ms / ctx["step_ms"])
