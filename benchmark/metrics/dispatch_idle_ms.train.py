"""Device ms per step that the card waited on the host's dispatch inside the step: a
window step's ``train.step`` span from its start event to its end event (the port's
spans), less the traced steps' busy time per step."""

from benchmark.spans import step_ms

LAYER = "step"
UNIT = "ms/step"
MOVES = "train_img_per_s"


def read(record):
    span = step_ms(record)
    if span is None:
        return None
    return span - 1e3 * record["trace"]["busy_s"] / record["traced_units"]
