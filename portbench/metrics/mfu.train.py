"""Share (%) of the card's float32 peak that the traced launch's updates
reach: the frozen FLOPs of an update (``yardstick.update_flops``, from the
configuration's shapes alone) times the updates, over the traced window's
seconds (the tracer's own stalls left out), over 67 TFLOP/s, the H100
SXM5's float32 rate at its 700 W power limit (the cells compute in float32
with TF32 off)."""
from portbench.trace import program_window_s
from portbench.yardstick import H100_FP32_FLOPS


def read(context):
    trace = context.get("trace")
    if not trace or "flops_per_update" not in context:
        return None
    return (100.0 * context["flops_per_update"] * context["updates_traced"]
            / program_window_s(trace) / H100_FP32_FLOPS)
