"""The whole step's share of the card's float32 peak: the model's forward
and backward FLOPs a step at the cell's padded shapes
(``counts.model_flops_per_step``), times the window's steps, over the
window's wall time and the peak (``counts/peaks.json``)."""


def read(w):
    if w.peak is None or not w.steps:
        return None
    return 100.0 * w.flops_per_step * w.steps / w.seconds / w.peak[
        "fp32_flop_s"]
