"""Device ms per window call of the prompt encoding, the host tokenizer and then the
CLIP text tower: the port's ``sample.encode`` spans from start event to end event."""

from benchmark.spans import sample_part_ms

LAYER = "sampler"
UNIT = "ms/call"
MOVES = "sample_img_per_s"


def read(record):
    return sample_part_ms(record, "sample.encode")
