"""Host seconds of the run's builds: the port's ``entry.build`` span (the recipe to
the built trainer: model, optimizer and EMA state, loaders) plus every
``kernels.build`` span (a CUDA source's cache check and its compile or load)."""

from benchmark.spans import build_s

LAYER = "entry"
UNIT = "s"
MOVES = "setup_s"


def read(record):
    return build_s(record)
