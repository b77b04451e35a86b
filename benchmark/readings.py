"""The arithmetic the per-layer readers share, over a traced run's record."""

from benchmark import trace
from benchmark.work import flops


def roofline(record: dict, function: str, kind: str):
    """Percent: the least time the window's calls of ``function`` need (work/flops.py)
    over the device time of the kernels that computed it (work/kernels/); None where
    the record is of another kind or no such kernel ran."""
    if record.get("kind") != kind:
        return None
    device_s = trace.seconds_matching(record["trace"]["ops"],
                                      record["kernels"].get(function, []))
    if device_s <= 0:
        return None
    return 100.0 * record["least_s"][function] / device_s


def idle(record: dict, kind: str):
    """Percent of the timed window in which no device op ran: one less the device's
    busy time per step (or call), from the traced steps, over the untraced window's
    time per step. The traced window itself runs slower, by the profiler's host time
    per operator, so its own idle share overstates a host-bound run's."""
    if record.get("kind") != kind:
        return None
    w = record["window"]
    busy = record["trace"]["busy_s"] / record["traced_units"]
    return 100.0 * (1.0 - busy / (w["seconds"] / w["units"]))


def mfu(record: dict, kind: str):
    """Percent of the cards' dense bf16 peak: the model FLOPs per image times the
    window's images per second."""
    if record.get("kind") != kind:
        return None
    return (100.0 * record["model_flops_per_image"] * record["images_per_s"]
            / (flops.PEAK_BF16_FLOPS * record["chips"]))
