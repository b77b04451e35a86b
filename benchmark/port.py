"""Every reach of the benchmark into the port's private parts, in one place.

The port has no public hook yet for what a training run has to see inside the
trainer: the batch the loader delivered as the trainer stages it, the step function
(to take each step's outputs, to time the window and to plant the tests' faults under
it) and the optimizer's moments (the first gradient as the optimizer took it). Nor
does it build its kernels ahead of their first call. Each access goes through
``_need``, which names the attribute that the port no longer has, so that a change to
the trainer fails here with a clear message and not deep inside a run. PERF.md's open
questions name the public hooks that would replace this module.
"""

import importlib


def _need(obj, name: str, what: str):
    if not hasattr(obj, name):
        raise RuntimeError(f"the benchmark needs {type(obj).__name__}.{name} ({what}), which "
                           "the port no longer has: benchmark/port.py is the place to adapt")
    return getattr(obj, name)


def wrap_staging(trainer, wrap):
    """Put ``wrap(stage)`` in the place of the trainer's ``_stage_batch(batch) ->
    staged``, which it calls on each loader batch. Returns the call that undoes it."""
    stage = _need(trainer, "_stage_batch", "the staging of each loader batch")
    trainer._stage_batch = wrap(stage)
    return lambda: setattr(trainer, "_stage_batch", stage)


def wrap_step(trainer, wrap):
    """Put ``wrap(step)`` in the place of the trainer's ``_step_fn(state, batch,
    generator) -> (state, metrics)``, the whole train step of one batch."""
    step = _need(trainer, "_step_fn", "the train step")
    trainer._step_fn = wrap(step)


def moments(state) -> tuple:
    """(mu, nu): AdamW's moments of a train state, {leaf: tensor} each."""
    opt = _need(state, "opt_state", "the optimizer state")
    return (_need(opt, "mu", "Adam's first moment"),
            _need(opt, "nu", "Adam's second moment"))


def beta1(trainer) -> float:
    return float(_need(_need(trainer, "tx", "the optimizer"), "b1", "Adam's beta1"))


def build_kernels() -> None:
    """The port's CUDA sources compiled into its own build cache, and the native MDS
    gather built."""
    build = importlib.import_module("micro_diffusion_tpu_torch.ops._build")
    _need(build, "build_all", "the build of every CUDA source")()
    native = importlib.import_module("micro_diffusion_tpu_torch.datasets.native")
    _need(native, "available", "the native gather's build")()
