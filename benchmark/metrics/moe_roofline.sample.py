"""The expert FFN's share of its roofline in the sample cells: the least time of the
expert FFN function (forward and backward in training) at the window's shapes over
the device time of the MoE kernels (csrc/moe_ffn{,_bwd}.cu, moe_gemm.cuh)."""

from benchmark.readings import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "sample_img_per_s"


def read(record):
    return roofline(record, "moe", "sample")
