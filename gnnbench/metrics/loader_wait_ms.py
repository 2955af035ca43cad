"""The trainer loop's ``wait_loaders`` span, mean a step in the window:
the host waiting for the four loaders' next batches."""


def read(w):
    return 1e3 * w.spans["wait_loaders"] / w.steps if w.steps else None
