"""Device ms of one guided DiT forward (64 rows) of the window's calls: the mean of
the port's ``sample.forward`` spans from start event to end event."""

from benchmark.spans import sample_part_ms

LAYER = "dit"
UNIT = "ms"
MOVES = "sample_img_per_s"


def read(record):
    return sample_part_ms(record, "sample.forward", per="span")
