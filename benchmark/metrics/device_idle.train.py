"""The share of a train cell's timed window in which no operation ran on the
device: one less the busy time per step, from the trace, over the untraced
window's time per step."""

from benchmark.readings import idle

LAYER = "device"
UNIT = "%"
MOVES = "train_img_per_s"


def read(record):
    return idle(record, "train")
