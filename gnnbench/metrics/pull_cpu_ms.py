"""The loaders' feature pull (the ``cpu_prefetch`` stage), CPU time,
mean a step in the window: the tracer's ``pull_cpu``, each call's
``time.thread_time`` summed over the trainers' pipelines."""


def read(w):
    if not w.steps or "pull_cpu" not in w.spans:
        return None
    return 1e3 * w.spans["pull_cpu"] / w.steps
