"""The train step: microbatch gradient accumulation, AdamW update, EMA.

Counterpart of ``micro_diffusion_tpu/train/train_step.py`` (``TrainState``,
``create_train_state``, ``_split_microbatches``, ``make_train_step``,
``make_grad_step`` :206, ``make_apply_step`` :240, ``make_ema_step`` :279,
``zero_grad_accumulator`` :908, ``make_eval_step``), in eager PyTorch:

  * the parameters are the model's own fp32 tensors, held by name in the state
    and updated in place under ``no_grad``;
  * the microbatch loop is a Python loop; each microbatch's gradients are cast
    to ``accum_dtype`` and added into a zeroed accumulator, then divided by the
    count in fp32 (K = 1 takes a fast path with the same numerics, without the
    zeroed buffer). ``make_train_step`` is ``make_grad_step`` once per
    microbatch and then ``make_apply_step``, so the trainer's ``accum_mode:
    dispatch``, which calls the two itself, gives the same step bit for bit;
  * the random draws (sigma normal, noise, token mask) come from one
    ``torch.Generator`` in microbatch order, or are injected per microbatch;
  * ``param_flow_dtype`` (bf16 or fp16): the fp32 master parameters are cast
    once per step (once per call of ``make_grad_step``'s function) into leaf
    copies, swapped into the module for the forward and for the whole backward,
    so that a remat region's recompute reads the same copies; the gradients
    leave the backward in that dtype and are cast to ``accum_dtype``. The
    update math stays fp32.

Under a mesh (``grad_shardings``, a parallel/sharding.py ``Zero2``) each rank
takes its rows of the global batch, accumulates its microbatches as above, and
then reduce-scatters the gradient into its ZeRO-2 shard (JAX: the accumulator
pinned to the opt-state shardings, train_step.py:108-124), updates that shard and
all-gathers the parameters; the loss is the mean over the batch ranks and the
grad norm that of the reduced gradient. The EMA is updated from the full
parameters and stays replicated (JAX's ``ema_params=p_sh``). Any process group
takes this path, one process included.

The EMA of this module lives in the state (the ``in_state`` and
``host_cadence`` placements); the off-state placements are train/host_ema.py.
"""

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.nn.utils.stateless import _reparametrize_module

from ..parallel.sharding import Zero2
from .optim import AdamState, AdamW, ema_update, global_norm

FLOW_DTYPES = (torch.bfloat16, torch.float16)


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict          # {name: fp32 parameter of the model}, updated in place
    opt_state: AdamState
    ema_params: Optional[dict] = None


def _named_params(model_or_params) -> dict:
    if isinstance(model_or_params, torch.nn.Module):
        return dict(model_or_params.named_parameters())
    return dict(model_or_params)


def create_train_state(params, tx: AdamW, use_ema: bool = False,
                       ema_dtype: Optional[torch.dtype] = None,
                       grad_shardings=None) -> TrainState:
    """``params``: a module or {name: tensor}. ``ema_dtype``: storage dtype of the
    EMA copy (default: the params' own). ``grad_shardings``: a ``Zero2``, whose
    shards the optimizer state takes the shape of."""
    params = _named_params(params)
    ema = None
    if use_ema:
        ema = {k: p.detach().clone().to(ema_dtype or p.dtype) for k, p in params.items()}
    shards = grad_shardings.param_shards() if grad_shardings is not None else params
    return TrainState(step=0, params=params, opt_state=tx.init(shards), ema_params=ema)


def _split_microbatches(batch: dict, microbatch_size: Optional[int]):
    """Split every batch entry (B, ...) into n chunks of microbatch_size rows."""
    b = next(iter(batch.values())).shape[0]
    if microbatch_size is None or microbatch_size >= b:
        microbatch_size = b
    if b % microbatch_size:
        raise ValueError(f"batch {b} is not a multiple of microbatch {microbatch_size}")
    n = b // microbatch_size
    chunks = {k: v.split(microbatch_size) for k, v in batch.items()}
    return [{k: chunks[k][i] for k in batch} for i in range(n)], n


def _check_flow_dtype(param_flow_dtype) -> None:
    if param_flow_dtype is not None and param_flow_dtype not in FLOW_DTYPES:
        raise ValueError(f"param_flow_dtype {param_flow_dtype}: torch.bfloat16, "
                         "torch.float16 or None")


def flow_params(params: dict, param_flow_dtype) -> dict:
    """Leaf copies of the parameters in ``param_flow_dtype`` that take gradients
    (JAX: ``p.astype(param_flow_dtype)`` outside the loss). Copies already in that
    dtype are aliased, not copied again."""
    return {k: p.detach().to(param_flow_dtype).requires_grad_(p.requires_grad)
            for k, p in params.items()}


def _loss_and_grads(model, params: dict, param_flow_dtype, microbatch: dict,
                    generator, draws):
    """One microbatch's loss and its gradients by name (the parameters that take
    gradients). With ``param_flow_dtype`` the DiT runs on leaf copies in that dtype
    (``params`` then names the DiT's parameters, as the trainer's state does),
    swapped in through the backward too: a remat region's recompute runs in the
    backward and must read the same copies."""
    if param_flow_dtype is None:
        names = [n for n, p in params.items() if p.requires_grad]
        loss, _, _ = model.forward(microbatch, generator=generator, train=True,
                                   **(draws or {}))
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        return loss.detach(), dict(zip(names, grads))
    flow = flow_params(params, param_flow_dtype)
    names = [n for n, p in flow.items() if p.requires_grad]
    with _reparametrize_module(model.dit, flow):
        loss, _, _ = model.forward(microbatch, generator=generator, train=True,
                                   **(draws or {}))
        grads = torch.autograd.grad(loss, [flow[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


def zero_grad_accumulator(params: dict, dtype: torch.dtype = torch.float32):
    """A fresh (loss_sum, grad_sum) accumulator for ``make_grad_step``: an fp32
    0-d loss sum and zeros of ``dtype`` shaped like each parameter that takes
    gradients (bf16 halves the params-sized buffer; the mean, clip and AdamW math
    stay fp32 either way)."""
    params = _named_params(params)
    device = next(iter(params.values())).device
    return (torch.zeros((), device=device),
            {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
             for k, p in params.items() if p.requires_grad})


def make_grad_step(model, param_flow_dtype: Optional[torch.dtype] = None) -> Callable:
    """Split-dispatch accumulation, part 1: ``grad_step(params, acc, microbatch,
    generator=None, draws=None) -> acc`` adds one microbatch's loss and gradients
    into ``acc`` (from ``zero_grad_accumulator``; the gradient sum in place, in
    its own dtype). ``generator`` draws the microbatch's draws in order; ``draws``
    injects them. ``param_flow_dtype``: the cast runs once per call, outside the
    remat regions (see ``make_train_step``)."""
    _check_flow_dtype(param_flow_dtype)

    def grad_step(params: dict, acc, microbatch: dict,
                  generator: Optional[torch.Generator] = None, draws: Optional[dict] = None):
        loss, grads = _loss_and_grads(model, params, param_flow_dtype, microbatch,
                                      generator, draws)
        loss_sum, grad_sum = acc
        for k, g in grads.items():
            grad_sum[k].add_(g.to(grad_sum[k].dtype))
        return loss_sum + loss, grad_sum

    return grad_step


def make_apply_step(tx: AdamW, lr_schedule: Callable, ema_smoothing: Optional[float] = None,
                    ema_start: int = 0, ema_update_interval: int = 1,
                    grad_shardings=None) -> Callable:
    """Split-dispatch accumulation, part 2: ``apply_step(state, acc, n) -> (state,
    metrics)`` takes the mean of the accumulated sums over ``n`` microbatches in
    fp32, clips, updates the parameters (in place) and the in-state EMA. It
    consumes ``acc``: its gradient dict is emptied.
    ``grad_shardings``: a ``Zero2``, as in ``make_train_step``."""
    if grad_shardings is not None and not isinstance(grad_shardings, Zero2):
        raise TypeError(f"grad_shardings: a parallel.sharding.Zero2, not "
                        f"{type(grad_shardings).__name__}")
    zero = grad_shardings

    def apply_step(state: TrainState, acc, n: int):
        loss_sum, grad_sum = acc
        loss = loss_sum / n
        # consumes the accumulator (JAX donates it): an fp32 sum is divided in place
        grads = {}
        for k in list(grad_sum):
            grads[k] = grad_sum.pop(k).float().div_(n)
        del acc, grad_sum
        lr = lr_schedule(state.step)
        if zero is None:
            grad_norm = global_norm(grads.values())
            opt_state = tx.step(state.params, grads, state.opt_state, grad_norm=grad_norm)
        else:
            mesh = zero.mesh
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=mesh.group("batch"))
            loss = loss / mesh.axis_size("batch")
            grads = zero.reduce_gradients(grads)
            grad_norm = global_norm([grads[k] for k in zero.norm_names],
                                    group=mesh.group("world"), device=loss.device)
            opt_state = tx.step(zero.param_shards(), grads, state.opt_state,
                                grad_norm=grad_norm)
            zero.gather_params()
        del grads
        ema = state.ema_params
        if ema is not None and ema_smoothing is not None:
            ema = ema_update(ema, state.params, state.step, ema_smoothing, ema_start,
                             ema_update_interval)
        new_state = TrainState(step=state.step + 1, params=state.params,
                               opt_state=opt_state, ema_params=ema)
        return new_state, {"loss": loss, "grad_norm": grad_norm, "lr": lr}

    return apply_step


def make_ema_step(smoothing: float) -> Callable:
    """A standalone EMA update, ``ema_step(state) -> state``: ema <- s * ema + (1 -
    s) * params in fp32 whatever the storage dtype, with no start gating and no
    interval (``ema_update(..., ema_start=0, update_interval=1)``, as JAX's). The
    trainer's ``host_cadence`` placement calls it every ``update_interval``
    steps."""

    def ema_step(state: TrainState) -> TrainState:
        ema = ema_update(state.ema_params, state.params, state.step, smoothing,
                         ema_start=0, update_interval=1)
        return dataclasses.replace(state, ema_params=ema)

    return ema_step


def skip_rank_draws(model, generator, microbatch: dict, n: int, zero) -> None:
    """Under a mesh, advance the step's generator past the draws of the
    microbatches of the batch ranks before this one (``n`` microbatches each)."""
    if zero is not None and generator is not None:
        model.skip_train_draws(generator, microbatch, n * zero.mesh.index("batch"))


def make_train_step(model, tx: AdamW, lr_schedule: Callable,
                    microbatch_size: Optional[int] = None,
                    ema_smoothing: Optional[float] = None, ema_start: int = 0,
                    ema_update_interval: int = 1, accum_dtype: torch.dtype = torch.float32,
                    param_flow_dtype: Optional[torch.dtype] = None,
                    grad_shardings=None) -> Callable:
    """Build ``train_step(state, batch, generator=None, draws=None) -> (state,
    metrics)``.

    ``model`` is a LatentDiffusion (models/diffusion.py); its ``forward`` computes
    the EDM loss with the configured train_mask_ratio. ``draws``, when given, is a
    sequence with one dict per microbatch of injected draws (rnd_normal, noise,
    token_mask). Metrics: 'loss', 'grad_norm' (before clipping) and 'lr' (at the
    step the update used), as 0-d tensors.

    ``param_flow_dtype`` (torch.bfloat16 or torch.float16): the fp32 master
    parameters are cast once per step, outside the remat regions, so a remat
    backward casts no parameter again and the parameter gradients leave the
    backward in that dtype (JAX train_step.py:93-106); the update math stays
    fp32. Deviation from the reference: parameter values and their gradients are
    rounded once a step.

    ``grad_shardings``: a parallel/sharding.py ``Zero2`` (ZeRO-2 over its mesh);
    ``batch`` is then this rank's rows, and ``generator`` first skips the draws
    of the microbatches of the batch ranks before this one, so that every row
    draws what it draws in one process with the same microbatch size.
    """
    _check_flow_dtype(param_flow_dtype)
    grad_step = make_grad_step(model, param_flow_dtype)
    apply_step = make_apply_step(tx, lr_schedule, ema_smoothing, ema_start,
                                 ema_update_interval, grad_shardings)

    def train_step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[dict]] = None):
        micro, n = _split_microbatches(batch, microbatch_size)
        if draws is not None and len(draws) != n:
            raise ValueError(f"{len(draws)} draw sets for {n} microbatches")
        if draws is None:
            skip_rank_draws(model, generator, micro[0], n, grad_shardings)
        pick = (lambda i: draws[i]) if draws is not None else (lambda i: None)
        # the flow copies once per step; grad_step's own cast then aliases them
        params = (flow_params(state.params, param_flow_dtype) if param_flow_dtype
                  else state.params)
        if n == 1:  # no zeroed accumulator: the one gradient is the sum
            loss, grads = _loss_and_grads(model, params, param_flow_dtype, micro[0],
                                          generator, pick(0))
            acc = (loss, {k: g.to(accum_dtype) for k, g in grads.items()})
            del grads
        else:
            acc = zero_grad_accumulator(params, accum_dtype)
            for i, mb in enumerate(micro):
                acc = grad_step(params, acc, mb, generator, pick(i))
        del params
        return apply_step(state, acc, n)

    return train_step


def make_eval_step(model) -> Callable:
    """Eval loss on a batch with mask_ratio = eval_mask_ratio (0), no gradients
    (reference model.py:217-222)."""

    @torch.no_grad()
    def eval_step(batch: dict, generator: Optional[torch.Generator] = None, **draws):
        loss, _, _ = model.forward(batch, generator=generator, train=False, **draws)
        return loss

    return eval_step
