"""The trainer's ``stack_host`` span (host clock), mean a step in the
window: inside ``stack_stage``, the ``np.stack`` of the trainers' host
batches on a leading axis (packed staging)."""


def read(w):
    if not w.steps or "stack_host" not in w.spans:
        return None
    return 1e3 * w.spans["stack_host"] / w.steps
