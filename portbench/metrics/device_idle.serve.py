"""Share (%) of the traced serving ticks' window in which the card ran no
kernel, copy or memset, the tracer's own stalls left out of the window."""
from portbench.trace import program_window_s


def read(context):
    trace = context.get("trace")
    if not trace or trace["device_events"] == 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / program_window_s(trace))
