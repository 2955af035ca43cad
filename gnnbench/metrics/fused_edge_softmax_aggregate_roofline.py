"""``fused_edge_softmax_aggregate``'s forward (K3, GAT's attention-weighted
sum) against its roofline: the least time of its launches of a step
(``counts.k3_least_seconds``, from the live edges of the checked steps)
times the window's steps, over the kernel's device time in the trace
(the backward kernels are named ``..._bwd_...`` and not counted)."""

KERNEL = "fused_edge_softmax_aggregate"
SYMBOL = "fused_edge_softmax_aggregate_kernel"


def read(w):
    if w.trace is None or not w.kernel_least_s or KERNEL not in \
            w.kernel_least_s:
        return None
    spent = sum(s for n, s in w.trace.by_name.items() if SYMBOL in n)
    if spent <= 0:
        return None
    return 100.0 * w.kernel_least_s[KERNEL] * w.steps / spent
