"""Host time per step that the trainer waited on the latents loader in the window
(the trainer's own counter, ``Trainer.data_wait_s``)."""

LAYER = "data"
UNIT = "ms/step"
MOVES = "train_img_per_s"


def read(record):
    if record.get("kind") != "train":
        return None
    w = record["window"]
    return 1e3 * w["data_wait_s"] / w["steps"]
