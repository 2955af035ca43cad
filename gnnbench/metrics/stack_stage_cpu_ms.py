"""The trainer thread's CPU time inside ``stack_stage``
(``time.thread_time``), mean a step in the window: ``stack_stage_ms``
less this is time the thread could not run."""


def read(w):
    if not w.steps or "stack_stage_cpu" not in w.spans:
        return None
    return 1e3 * w.spans["stack_stage_cpu"] / w.steps
