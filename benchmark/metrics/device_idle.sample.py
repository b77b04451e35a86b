"""The share of a sample cell's timed window in which no operation ran on the
device: one less the busy time per call, from the trace, over the untraced
window's time per call."""

from benchmark.readings import idle

LAYER = "device"
UNIT = "%"
MOVES = "sample_img_per_s"


def read(record):
    return idle(record, "sample")
