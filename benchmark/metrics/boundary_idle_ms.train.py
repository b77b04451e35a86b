"""Device ms per step that the card waited on the trainer between steps: from one
window step's ``train.step`` end event to the next one's start event (the port's
spans; the loader, staging, the metric fetch, callbacks, the host EMA and the step's
wait for the copy stream fall here)."""

from benchmark.spans import boundary_ms

LAYER = "trainer"
UNIT = "ms/step"
MOVES = "train_img_per_s"


def read(record):
    return boundary_ms(record)
