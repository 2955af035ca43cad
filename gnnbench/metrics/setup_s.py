"""Seconds from the process's start to the first timed step: imports,
input generation, partitioning, the world and its loaders, the kernels'
build or load, the weights, and the warm-up epochs."""


def read(w):
    return w.setup_s
