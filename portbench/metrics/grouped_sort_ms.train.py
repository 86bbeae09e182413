"""Device milliseconds an update of the grouped window-attention kernels'
sort of the minibatch by (worker, start) (``grouped_sort_kernel``, which
the grouped forward and backward each launch before their passes): its
device time in the traced launch over the launch's updates. Neither
roofline share counts this time."""
from portbench.trace import kernel_seconds

KERNELS = ("grouped_sort_kernel",)


def read(context):
    trace = context.get("trace")
    spent = kernel_seconds(trace, KERNELS) if trace else 0.0
    if spent <= 0 or not context.get("updates_traced"):
        return None
    return 1e3 * spent / context["updates_traced"]
