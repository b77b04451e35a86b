"""Profiling and timing helpers, the port of micro_diffusion_tpu/utils/profiling.py
(``profile_trace`` :18, ``StepTimer`` :34), and the port's span recorder.

``profile_trace`` is a ``torch.profiler`` context over the CPU and, where there is a
card, CUDA activities; on exit it writes a Chrome trace (open it in Perfetto or
chrome://tracing) into ``logdir``. ``module_scopes`` names every module call of a
model in that trace, for ``scripts/attribute_trace.py``. ``StepTimer`` reads the wall
clock only after the device has finished the timed work: ``stop`` synchronises the
device of the scalar it is given, or the current CUDA device.

``span`` marks a phase of the running program at a layer boundary (the trainer's
phases, the train step's parts, the sampler's call and its parts); every span is
kept, always, in a bounded ring that ``spans()`` reads. A span costs a few
microseconds of host time and never synchronises: its device ends are CUDA events,
resolved only when ``spans()`` reads them. Under a running ``torch.profiler`` each
span is also a ``record_function`` scope of its name, so the phases show in any
Chrome trace on the trace's own clock (``scripts/trace_summary.py`` puts idle time
down to them). No span is opened inside a module's ``forward``: per-module
attribution is ``module_scopes``'.

The span names are a contract (``SPAN_NAMES``): the benchmark's per-layer readers
(``benchmark/spans.py``) and ``scripts/trace_summary.py`` read them.

  entry.build      train/cli.py main: the recipe's config to the built Trainer
  kernels.build    ops/_build.py: a CUDA source's cache check and its compile or load
                   (tags: the sources, those compiled)
  data.wait        Trainer: the pull of one batch from the train loader
                   (``Trainer.data_wait_s`` is their sum)
  trainer.stage    Trainer: the staging of a loader batch to the device
  train.step       Trainer: one train step (the step's generator and step function);
                   unit = the step; device ends
  step.forward     train/train_step.py: a microbatch's forward (the loss)
  step.backward    train/train_step.py: its backward (a remat recompute runs here)
  step.accumulate  train/train_step.py: the gradients added into the accumulator
  step.update      train/train_step.py: mean, clip, AdamW and the in-state EMA
  step.reduce      train/train_step.py: ZeRO-2's gradient reduce and parameter gather
  trainer.ema      Trainer: the host_cadence / hostcompute EMA update
  trainer.metrics  Trainer: the metric fetch (the trainer's synchronise), the log and
                   the callbacks, once a metric window
  trainer.eval     Trainer: an eval
  trainer.save     Trainer: a checkpoint save
  sample.call      LatentDiffusion.generate; unit = the process's call ordinal
  sample.encode    generate: tokenizer and text encoder; device ends
  sample.forward   the sampler: one guided denoiser call; device ends
  sample.decode    generate: the VAE decode; device ends
"""

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the prefix of the scopes module_scopes opens (scripts/attribute_trace.py reads it)
SCOPE_PREFIX = "nn.Module: "

SPAN_NAMES = ("entry.build", "kernels.build", "data.wait", "trainer.stage", "train.step",
              "step.forward", "step.backward", "step.accumulate", "step.update",
              "step.reduce", "trainer.ema", "trainer.metrics", "trainer.eval",
              "trainer.save", "sample.call", "sample.encode", "sample.forward",
              "sample.decode")
RING_SPANS = 16384  # the finished spans kept, newest last
ORIGIN_S = 10.0     # host seconds between device clock origins (see _Origin)


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


# ------------------------------------------------------------------ spans

_ids = itertools.count()      # span ids; next() on it is atomic
_local = threading.local()    # .stack: the spans open on this thread, innermost last
_ring: collections.deque = collections.deque()  # finished spans, in the order they ended
_lock = threading.Lock()
_pools = collections.defaultdict(list)  # CUDA device index -> spare timing events
_origins: dict = {}           # CUDA device index -> its newest _Origin


def span(name: str, device=False, unit=None) -> "Span":
    """A context manager that keeps one record of the block it wraps:

        with span("train.step", device=self.device, unit=step):
            state, metrics = step_fn(state, batch, generator)

    ``device``: a CUDA device (``True``: the current one, once CUDA is initialised)
    on whose current stream a pair of timing events is recorded at entry and exit;
    nothing is recorded on other devices or while the stream is being captured into
    a CUDA graph. ``unit``: the request the span serves (a step, a call), inherited
    by the spans opened inside it. The block may set ``tags`` ({str: value}) on the
    span it is given."""
    return Span(name, device, unit)


class Span:
    """One span's record (see ``span``): ``name``; ``id``; ``parent``, the id of the
    innermost span open on this thread at entry (None at the top); ``unit``; host
    ``start_ns`` / ``end_ns`` (``time.perf_counter_ns``); ``error``, whether it ended
    by an exception; ``tags``."""

    __slots__ = ("name", "unit", "tags", "id", "parent", "start_ns", "end_ns", "error",
                 "_device", "_scope", "_stream", "_events", "_origin", "_device_ms")

    def __init__(self, name: str, device=False, unit=None):
        self.name, self.unit, self._device = name, unit, device
        self.tags = self._scope = self._events = self._origin = self._device_ms = None
        self.error = False

    @property
    def seconds(self) -> float:
        """Host seconds from entry to exit."""
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Span":
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        if self.unit is None and parent is not None:
            self.unit = parent.unit
        stack.append(self)
        if torch._C._autograd._profiler_enabled():
            self._scope = record_function(self.name)
            self._scope.__enter__()
        if self._device:
            self._start_events()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, traceback) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._stream)
        self._stream = None
        if self._scope is not None:
            self._scope.__exit__(kind, value, traceback)
            self._scope = None
        _stack().pop()
        self.error = kind is not None
        with _lock:
            _ring.append(self)
            if len(_ring) > RING_SPANS:
                _ring.popleft()._release()
        return False

    def _start_events(self) -> None:
        device = self._device
        if device is True:
            if not torch.cuda.is_initialized():
                return
            index = torch.cuda.current_device()
        else:
            if not isinstance(device, torch.device):
                device = torch.device(device)
            if device.type != "cuda":
                return
            index = device.index if device.index is not None else torch.cuda.current_device()
        if torch.cuda.is_current_stream_capturing():
            return
        stream = torch.cuda.current_stream(index)
        origin = _origins.get(index)
        if origin is None or time.perf_counter_ns() - origin.host_ns > ORIGIN_S * 1e9:
            origin = _origins[index] = _Origin(index, stream, origin)
        self._events = (_event(index), _event(index))
        self._stream, self._origin = stream, origin
        self._events[0].record(stream)

    def _resolve(self) -> None:
        """The device ends in ms on the event clock, once both events have completed
        (a query, no wait); the events go back to the pool."""
        if self._events is None:
            return
        base = self._origin.resolve()
        start, end = self._events
        if base is None or not (start.query() and end.query()):
            return
        ev = self._origin.event
        self._device_ms = (base + ev.elapsed_time(start), base + ev.elapsed_time(end))
        self._release()

    def _release(self) -> None:
        if self._events is not None:
            _pools[self._origin.index].extend(self._events)
        self._events = self._origin = None

    def as_dict(self) -> dict:
        dev = self._device_ms or (None, None)
        return {"id": self.id, "name": self.name, "parent": self.parent, "unit": self.unit,
                "start_ms": self.start_ns * 1e-6, "end_ms": self.end_ns * 1e-6,
                "error": self.error, "tags": self.tags,
                "device_start_ms": dev[0], "device_end_ms": dev[1]}


class _Origin:
    """The event a device's span events are read against. ``elapsed_time`` is float32
    milliseconds, so a new origin is recorded every ``ORIGIN_S`` host seconds and the
    readings stay within about a microsecond; an origin's own time is its
    predecessor's plus the interval between the two events (0 for the first)."""

    __slots__ = ("index", "event", "host_ns", "prev", "ms")

    def __init__(self, index: int, stream, prev: Optional["_Origin"]):
        self.index = index
        self.event = torch.cuda.Event(enable_timing=True)
        self.event.record(stream)
        self.host_ns = time.perf_counter_ns()
        self.prev, self.ms = prev, (0.0 if prev is None else None)
        if prev is not None:
            prev.resolve()  # settled while it is young: the chain stays short

    def resolve(self) -> Optional[float]:
        """This origin's ms, or None while its event (or a predecessor's) is pending."""
        chain, o = [], self
        while o.ms is None:
            chain.append(o)
            o = o.prev
        for o in reversed(chain):
            if not o.event.query():
                return None
            o.ms = o.prev.ms + o.prev.event.elapsed_time(o.event)
            o.prev = None
        return self.ms


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _event(index: int):
    try:
        return _pools[index].pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def spans() -> list:
    """The finished spans kept (the newest ``RING_SPANS``), oldest first, in the order
    they ended, as dicts: ``id``, ``name``, ``parent`` (an id), ``unit``, ``start_ms``
    / ``end_ms`` (host, ``perf_counter`` ms), ``error``, ``tags``, and for
    a span with device ends ``device_start_ms`` / ``device_end_ms`` (ms on the event
    clock, one per device: the intervals between spans on one stream are times too),
    None where it has none or they have not completed."""
    with _lock:
        kept = list(_ring)
        for s in kept:
            s._resolve()
    return [s.as_dict() for s in kept]
