"""The train step: microbatch gradient accumulation, AdamW update, EMA.

Counterpart of ``micro_diffusion_tpu/train/train_step.py`` (``TrainState``,
``create_train_state``, ``_split_microbatches``, ``make_train_step``,
``make_eval_step``), in eager PyTorch:

  * the parameters are the model's own fp32 tensors, held by name in the state
    and updated in place under ``no_grad``;
  * the microbatch loop is a Python loop; each microbatch's gradients are cast
    to ``accum_dtype`` and summed, then divided by the count in fp32 (K = 1 takes
    a fast path with the same numerics);
  * the random draws (sigma normal, noise, token mask) come from one
    ``torch.Generator`` in microbatch order, or are injected per microbatch.

Under a mesh (``grad_shardings``, a parallel/sharding.py ``Zero2``) each rank
takes its rows of the global batch, accumulates its microbatches as above, and
then reduce-scatters the gradient into its ZeRO-2 shard (JAX: the accumulator
pinned to the opt-state shardings, train_step.py:108-124), updates that shard and
all-gathers the parameters; the loss is the mean over the batch ranks and the
grad norm that of the reduced gradient. The EMA is updated from the full
parameters and stays replicated (JAX's ``ema_params=p_sh``). Any process group
takes this path, one process included.

Not ported: ``param_flow_dtype`` and the host-EMA placements (README.md, 'Not
ported'): the EMA is a plain tensor copy in the state, the ``in_state``
placement.
"""

import dataclasses
from typing import Callable, Optional, Sequence

import torch

import torch.distributed as dist

from ..parallel.sharding import Zero2
from .optim import AdamState, AdamW, ema_update, global_norm


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


def make_train_step(model, tx: AdamW, lr_schedule: Callable,
                    microbatch_size: Optional[int] = None,
                    ema_smoothing: Optional[float] = None, ema_start: int = 0,
                    ema_update_interval: int = 1, accum_dtype: torch.dtype = torch.float32,
                    param_flow_dtype=None, grad_shardings=None) -> Callable:
    """Build ``train_step(state, batch, generator=None, draws=None) -> (state,
    metrics)``.

    ``model`` is a LatentDiffusion (models/diffusion.py); its ``forward`` computes
    the EDM loss with the configured train_mask_ratio. ``draws``, when given, is a
    sequence with one dict per microbatch of injected draws (rnd_normal, noise,
    token_mask). Metrics: 'loss', 'grad_norm' (before clipping) and 'lr' (at the
    step the update used), as 0-d tensors.

    ``grad_shardings``: a parallel/sharding.py ``Zero2`` (ZeRO-2 over its mesh);
    ``batch`` is then this rank's rows, and ``generator`` first skips the draws
    of the microbatches of the batch ranks before this one, so that every row
    draws what it draws in one process with the same microbatch size.
    """
    if param_flow_dtype is not None:
        raise NotImplementedError(
            "param_flow_dtype is a TPU-memory workaround that is not ported "
            "(README.md, 'Not ported'; ROADMAP queue A)")
    if grad_shardings is not None and not isinstance(grad_shardings, Zero2):
        raise TypeError(f"grad_shardings: a parallel.sharding.Zero2, not "
                        f"{type(grad_shardings).__name__}")
    zero = grad_shardings

    def grads_of(params, mb, generator, draws_i):
        names = [n for n, p in params.items() if p.requires_grad]
        loss, _, _ = model.forward(mb, generator=generator, train=True, **(draws_i or {}))
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    def train_step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[dict]] = None):
        micro, n = _split_microbatches(batch, microbatch_size)
        if draws is not None and len(draws) != n:
            raise ValueError(f"{len(draws)} draw sets for {n} microbatches")
        if zero is not None and generator is not None and draws is None:
            model.skip_train_draws(generator, micro[0], n * zero.mesh.index("batch"))
        pick = (lambda i: draws[i]) if draws is not None else (lambda i: None)
        if n == 1:
            loss, grads = grads_of(state.params, micro[0], generator, pick(0))
            grads = {k: g.to(accum_dtype).float() for k, g in grads.items()}
        else:
            loss_sum, acc = torch.zeros((), device=next(iter(state.params.values())).device), None
            for i, mb in enumerate(micro):
                loss_i, grads = grads_of(state.params, mb, generator, pick(i))
                loss_sum = loss_sum + loss_i
                if acc is None:
                    acc = {k: g.to(accum_dtype) for k, g in grads.items()}
                else:
                    for k, g in grads.items():
                        acc[k].add_(g.to(accum_dtype))
                del grads
            loss = loss_sum / n
            grads = {k: a.float() / n for k, a in acc.items()}
            del acc

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
            grad_norm = global_norm([grads[k] for k in zero.norm_names], group=mesh.group("world"),
                                    device=loss.device)
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

    return train_step


def make_eval_step(model) -> Callable:
    """Eval loss on a batch with mask_ratio = eval_mask_ratio (0), no gradients
    (reference model.py:217-222)."""

    @torch.no_grad()
    def eval_step(batch: dict, generator: Optional[torch.Generator] = None, **draws):
        loss, _, _ = model.forward(batch, generator=generator, train=False, **draws)
        return loss

    return eval_step
