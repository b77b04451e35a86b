"""The numbers that decide ``correct``, each compared with its limit.

Training (one reading each, from the program's run and from the reference's
follow of the same steps):

  * ``loss``: the widest relative gap of a followed step's loss;
  * ``grad``: over the leaves, the widest gap between the program's and the
    reference's norm of the first gradient as the optimizer takes it, measured
    against the larger of the reference's norm of that leaf and of the median leaf
    (the program's is read from Adam's first moment after one step, mu / (1 - b1));
  * ``update`` and ``ema``: the same measure of each leaf's change over the followed
    steps, of the parameters and of the EMA, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (a leaf with no gradient
    moves under Adam by round-off alone);
  * ``data_rows``: rows of the batches the loader delivered that differ from the
    samples the protocol draws (exact);
  * ``path``: kernel launch counts off the cell's path, such as K2 in a cell that
    runs K3 (exact).

Sampling (traffic/sample.py ``reference_check``; the reference follows the sampler's
recorded states): ``start`` and ``heun`` (the widest gap of a recorded state from the
float64 start, or the float64 Heun update of the states before it, over the state's
largest magnitude), ``denoise`` and ``decode`` (the widest relative L2 distance, over the
checked images, of the guided denoiser's outputs and of the decoded image from the
reference's at the same inputs).
"""

import statistics

import numpy as np

SMALL_GRAD = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _gap(prog: dict, ref: dict, keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def training_numbers(prog: dict, ref: dict) -> dict:
    """{'loss', 'grad', 'update'[, 'ema']} of two readings (follow.py's form; 'ema'
    where the stage keeps one)."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the program's and the reference's leaves differ")
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("inf")
    med = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= SMALL_GRAD * med]
    out = {"loss": loss, "grad": _gap(prog["grad"], ref["grad"], ref["grad"]),
           "update": _gap(prog["update"], ref["update"], moving)}
    if ref.get("ema"):
        out["ema"] = _gap(prog["ema"], ref["ema"], moving)
    return out


def data_rows(delivered: list, expected: list) -> int:
    """Rows of the delivered batches ({key: array}) that are not the expected rows."""
    bad = 0
    for got, want in zip(delivered, expected):
        for key, arr in want.items():
            g = np.asarray(got.get(key))
            if g.shape != arr.shape:
                bad += len(arr)
                continue
            bad += int((g.reshape(len(arr), -1) != arr.reshape(len(arr), -1)).any(1).sum())
    return bad + abs(len(delivered) - len(expected)) * len(expected[0]["image_latents"])


def path_violations(launches: dict, expect: dict) -> int:
    """Counters of the window that break the cell's path: a name in ``present`` that
    did not launch, or one in ``absent`` that did."""
    return (sum(launches.get(n, 0) == 0 for n in expect.get("present", []))
            + sum(launches.get(n, 0) > 0 for n in expect.get("absent", [])))


def image_gap(prog, ref) -> float:
    """Widest relative L2 distance of image i of ``prog`` from image i of ``ref``."""
    return max(float(np.linalg.norm(p - r) / np.linalg.norm(r)) for p, r in zip(prog, ref))


def with_limits(numbers: dict, limits: dict) -> tuple:
    """(the numbers compared, each with its limit; the others, read but not
    compared: a number with no limit of the cell's had no control or fault reading
    far enough above the program's to set one)."""
    compared = {k: {"value": float(v), "limit": float(limits[k])}
                for k, v in numbers.items() if k in limits}
    return compared, {k: float(v) for k, v in numbers.items() if k not in limits}
