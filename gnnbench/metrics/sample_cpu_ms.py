"""The loaders' sampling stage's CPU time, mean a step in the window: the
tracer's ``sample_cpu``, each call's ``time.thread_time`` summed over the
trainers' pipelines (``sample_busy_ms`` is the same calls' wall time)."""


def read(w):
    if not w.steps or "sample_cpu" not in w.spans:
        return None
    return 1e3 * w.spans["sample_cpu"] / w.steps
