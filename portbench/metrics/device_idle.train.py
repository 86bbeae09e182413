"""Share (%) of the traced launch's window in which the card ran no kernel,
copy or memset: one minus the union of their intervals over the window,
the tracer's own stalls left out of it."""
from portbench.trace import program_window_s


def read(context):
    trace = context.get("trace")
    if not trace or trace["device_events"] == 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / program_window_s(trace))
