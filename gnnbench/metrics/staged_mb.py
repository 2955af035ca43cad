"""The bytes staged to the card, mean a step in the window, in MB
(1e6 B): the trainer's ``staged_bytes`` counter, the packed arena's
``PackSpec.total_bytes()`` of every step."""


def read(w):
    if not w.steps or "staged_bytes" not in w.spans:
        return None
    return w.spans["staged_bytes"] / 1e6 / w.steps
