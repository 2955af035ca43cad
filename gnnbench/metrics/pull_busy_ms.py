"""The loaders' feature pull (the ``cpu_prefetch`` stage), wall time
busy, mean a step in the window: the tracer's ``pull``, summed over the
trainers' pipelines."""


def read(w):
    if not w.steps or "pull" not in w.spans:
        return None
    return 1e3 * w.spans["pull"] / w.steps
