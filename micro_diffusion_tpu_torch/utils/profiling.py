"""Profiling and timing helpers, the port of micro_diffusion_tpu/utils/profiling.py
(``profile_trace`` :18, ``StepTimer`` :34).

``profile_trace`` is a ``torch.profiler`` context over the CPU and, where there is a
card, CUDA activities; on exit it writes a Chrome trace (open it in Perfetto or
chrome://tracing) into ``logdir``. ``module_scopes`` names every module call of a
model in that trace, for ``scripts/attribute_trace.py``. ``StepTimer`` reads the wall
clock only after the device has finished the timed work: ``stop`` synchronises the
device of the scalar it is given, or the current CUDA device.
"""

import contextlib
import functools
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the prefix of the scopes module_scopes opens (scripts/attribute_trace.py reads it)
SCOPE_PREFIX = "nn.Module: "


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[profile]:
    """Profile a code block and write its Chrome trace into ``logdir``:

        with profile_trace('runs/trace') as prof:
            state, metrics = step(state, batch, generator)
            metrics['loss'].item()

    Yields the ``torch.profiler.profile`` (``prof.key_averages()`` for tables). The
    trace is ``<logdir>/<pid>.<time ns>.pt.trace.json``, and ``prof.trace_path`` names
    it.
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(logdir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def module_scopes(model: torch.nn.Module) -> Iterator[None]:
    """Inside the block, every call of ``model`` or of one of its submodules runs in
    a ``record_function`` scope named ``SCOPE_PREFIX`` + its path, one
    ``<name>:<class>`` a level from ``model`` (named 'model') down, e.g. ``nn.Module:
    model:LatentDiffusion/dit:DiT/blocks:ModuleList/1:DiTBlock/mlp:FeedForwardECMoe``.

    Each module's ``forward`` is wrapped on the instance for the block and restored
    after it, so a call through ``forward`` is named too (the train step calls
    ``model.forward``), a remat recompute replays the scopes, and outside the block
    the model runs no extra code. A scope costs host time: open it only around the
    step that a trace is taken of."""
    paths = {"": f"model:{type(model).__name__}"}
    wrapped = []
    try:
        for name, mod in model.named_modules():
            if name:
                parent, _, rel = name.rpartition(".")
                paths[name] = f"{paths[parent]}/{rel}:{type(mod).__name__}"
            if "forward" in vars(mod):
                raise RuntimeError(f"module {name or 'model'!r} already has an instance "
                                   "forward")
            mod.forward = _scoped(mod.forward, SCOPE_PREFIX + paths[name])
            wrapped.append(mod)
        yield
    finally:
        for mod in wrapped:
            del mod.forward


def _scoped(forward, scope: str):
    @functools.wraps(forward)
    def call(*args, **kwargs):
        with record_function(scope):
            return forward(*args, **kwargs)
    return call


class StepTimer:
    """Wall-clock step timing behind a device barrier."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.times: list = []

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, scalar=None) -> float:
        """Pass any tensor from the timed computation (or nothing, for the current
        CUDA device): its device is synchronised before the clock is read (nothing to
        wait for on the CPU)."""
        if isinstance(scalar, torch.Tensor):
            if scalar.device.type == "cuda":
                torch.cuda.synchronize(scalar.device)
        elif scalar is None and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
