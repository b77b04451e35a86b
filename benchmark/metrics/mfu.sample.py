"""The sampler's share of the card's dense bf16 peak: the DiT's forward FLOPs per
image (both rows of the guided batch, every forward of the sampler; work/flops.py)
times the window's images per second."""

from benchmark.readings import mfu

LAYER = "sampler"
UNIT = "%"
MOVES = "sample_img_per_s"


def read(record):
    return mfu(record, "sample")
