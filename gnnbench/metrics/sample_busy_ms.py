"""The loaders' sampling stage busy, mean a step in the window: the
``sample`` stage's ``busy_s`` of ``AsyncPipeline.stats_report()`` summed
over the trainers' pipelines (the pipelines run ahead of the steps, so it
is the sampling done while the window ran, a step)."""


def read(w):
    return 1e3 * w.sample_busy_s / w.steps if w.steps else None
