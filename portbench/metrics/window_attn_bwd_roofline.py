"""Share (%) of its roofline that the backward window-attention kernels
reach in the traced launch: the frozen least time of every backward call
(``yardstick.window_bound_s``) over the device time of the kernels named
here (the grouped pair's passes and sort among them)."""
from portbench.trace import kernel_seconds

KERNELS = ("window_attention_bwd_kernel", "grouped_bwd_scores_kernel",
           "grouped_bwd_reduce_kernel", "grouped_bwd_pe_sum_kernel")


def read(context):
    bound = context.get("attn_bound_s")
    spent = kernel_seconds(context["trace"], KERNELS) if bound else 0.0
    return 100.0 * bound["bwd"] / spent if spent > 0 else None
