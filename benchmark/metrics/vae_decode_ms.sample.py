"""Device ms per window call of the VAE decode: the port's ``sample.decode`` spans
from start event to end event."""

from benchmark.spans import sample_part_ms

LAYER = "sampler"
UNIT = "ms/call"
MOVES = "sample_img_per_s"


def read(record):
    return sample_part_ms(record, "sample.decode")
