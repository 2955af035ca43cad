"""The trainer's ``stage_pack`` span (host clock), mean a step in the
window: inside ``stack_stage``, ``host_stage`` on the stacked batch
(flatten, spec, the pinned arena's allocation and its fill)."""


def read(w):
    if not w.steps or "stage_pack" not in w.spans:
        return None
    return 1e3 * w.spans["stage_pack"] / w.steps
