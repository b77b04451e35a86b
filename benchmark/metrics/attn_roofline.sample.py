"""Attention's share of its roofline in the sample cells: the least time of the
attention function (forward and backward in training) at the window's shapes over
the device time of the attention kernels (csrc/flash_attention_lane{,_bwd}.cu)."""

from benchmark.readings import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "sample_img_per_s"


def read(record):
    return roofline(record, "attention", "sample")
