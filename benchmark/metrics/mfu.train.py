"""The whole training step's share of the card's dense bf16 peak: the model FLOPs of
forward and backward per image (recomputation not counted; work/flops.py) times the
window's images per second."""

from benchmark.readings import mfu

LAYER = "step"
UNIT = "%"
MOVES = "train_img_per_s"


def read(record):
    return mfu(record, "train")
