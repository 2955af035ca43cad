"""The trainer's ``stack_stage`` span (host clock), mean a step in the
window: stacking the trainers' host batches, packing them into the pinned
arena and the copy to the card."""


def read(w):
    return 1e3 * w.spans["stack_stage"] / w.steps if w.steps else None
