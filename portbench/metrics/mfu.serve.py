"""Share (%) of the card's float32 peak that the traced serving ticks
reach: the frozen FLOPs of a policy step of all streams on the K/V cache
(``yardstick.step_flops``) times the ticks, over the traced window's
seconds (the tracer's own stalls left out), over 67 TFLOP/s (H100 SXM5,
float32, 700 W)."""
from portbench.trace import program_window_s
from portbench.yardstick import H100_FP32_FLOPS


def read(context):
    trace = context.get("trace")
    if not trace or "flops_per_tick" not in context:
        return None
    return (100.0 * context["flops_per_tick"] * context["ticks_traced"]
            / program_window_s(trace) / H100_FP32_FLOPS)
