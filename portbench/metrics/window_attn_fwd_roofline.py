"""Share (%) of its roofline that the forward window-attention kernel
reaches in the traced launch: the frozen least time of every forward call
(``yardstick.window_bound_s``, from each minibatch's own windows) over the
device time of the kernels named here."""
from portbench.trace import kernel_seconds

KERNELS = ("window_attention_fwd_kernel",
           "window_attention_fwd_grouped_kernel")


def read(context):
    bound = context.get("attn_bound_s")
    spent = kernel_seconds(context["trace"], KERNELS) if bound else 0.0
    return 100.0 * bound["fwd"] / spent if spent > 0 else None
