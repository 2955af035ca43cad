"""The trainer loop's ``read_loss`` span, mean a step in the window: the
host waiting on the card for the step's loss at its end."""


def read(w):
    return 1e3 * w.spans["read_loss"] / w.steps if w.steps else None
