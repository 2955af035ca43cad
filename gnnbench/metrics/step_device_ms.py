"""The model step on the card, mean a step in the window: the trainer's
CUDA-event spans ``device_forward``, ``device_backward`` and
``device_optimizer`` added."""

SPANS = ("device_forward", "device_backward", "device_optimizer")


def read(w):
    if not w.steps or any(s not in w.spans for s in SPANS):
        return None
    return 1e3 * sum(w.spans[s] for s in SPANS) / w.steps
