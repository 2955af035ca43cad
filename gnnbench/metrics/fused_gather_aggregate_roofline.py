"""``fused_gather_aggregate`` (K1, GraphSAGE's neighbour sum) against its
roofline: the least time of its launches of a step (bytes over the
bandwidth or operations over the float32 peak, a layer at a time, from
the live edges of the checked steps: ``counts.k1_least_seconds``) times
the window's steps, over the kernel's device time in the trace."""

KERNEL = "fused_gather_aggregate"
SYMBOL = "fused_gather_aggregate_kernel"


def read(w):
    if w.trace is None or not w.kernel_least_s or KERNEL not in \
            w.kernel_least_s:
        return None
    spent = sum(s for n, s in w.trace.by_name.items() if SYMBOL in n)
    if spent <= 0:
        return None
    return 100.0 * w.kernel_least_s[KERNEL] * w.steps / spent
