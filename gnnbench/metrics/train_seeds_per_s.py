"""Seeds trained a second: every labelled seed of every trainer's batch of
every step in the window, over all of the window's wall time (the host
clock, from the first step's start to the end of the epoch in which the
time ran out; every epoch ends in a synchronise of the card)."""


def read(w):
    return w.seeds / w.seconds
