"""The reference's side of a training cell: the first steps of the run, followed in
float32 from the same inputs and the same draws.

``follow`` rebuilds the plain MicroDiT with the seed's weights, works out each step's
batch, caption drops and draws (protocol.py), and runs the steps: the loss of every
image in blocks of rows (the gradient of the mean accumulated block by block), AdamW
with the stage's clip, schedule and decay, the EMA. It returns the same readings the
program's run gives: each step's loss, each leaf's norm of the first gradient as the
optimizer takes it (clipped), and each leaf's change over the steps, of the
parameters and of the EMA.
"""

import torch

from ..inputs import fill_weights
from . import edm, protocol
from .dit import MicroDiT
from .precision import no_tf32


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in tensors.items()}


def follow(m: dict, train: dict, caps, lats, seed: int, weight_seed: int, steps: int,
           rows: int, device, precision: str = "fp32", half_batch: bool = False):
    """Readings of ``steps`` steps: {'loss': [...], 'grad': {leaf: norm}, 'update':
    {leaf: norm}, 'ema': {leaf: norm}, 'w0': {leaf: tensor}}. ``caps`` / ``lats``: the
    dataset's fp16 arrays; ``half_batch`` plants the fault of a step that takes the
    mean over half its batch."""
    with no_tf32():
        with torch.device(device):
            model = MicroDiT(m, precision)
        params = dict(model.named_parameters())
        fill_weights(params, weight_seed)
        w0 = {k: p.detach().clone() for k, p in params.items()}
        opt = edm.AdamW(params, train["schedule"], train["weight_decay"], train["betas"],
                        train["eps"], train.get("clip_norm"))
        ema = ({k: p.detach().clone() for k, p in params.items()}
               if train["ema"] is not None else {})
        n, batch = len(caps), train["batch"]
        out = {"loss": [], "grad": None}
        for step in range(steps):
            epoch, idx = protocol.batch_indices(n, batch, seed, step, train["shuffle_algo"])
            keep = torch.tensor([protocol.caption_kept(seed, epoch, i, train["cap_drop_prob"])
                                 for i in idx], device=device)
            x = torch.from_numpy(lats[idx]).to(device).float()
            y = torch.from_numpy(caps[idx]).to(device).float()
            y = (y * keep.reshape(-1, 1, 1, 1)).flatten(1, 2)
            draws = protocol.step_draws(seed, step, x.shape, train["microbatch"],
                                        train["mask_ratio"], m["patch_size"], device)
            rnd = torch.cat([d[0] for d in draws])
            noise = torch.cat([d[1] for d in draws])
            masks = None
            if draws[0][2] is not None:
                masks = [torch.cat([d[2][j] for d in draws]) for j in (0, 1)]
            used = batch // 2 if half_batch else batch
            total = 0.0
            for lo in range(0, used, rows):
                hi = min(used, lo + rows)
                mask = None if masks is None else (masks[0][lo:hi], masks[1][lo:hi])
                losses = edm.row_losses(model, x[lo:hi], y[lo:hi], rnd[lo:hi], noise[lo:hi],
                                        mask, train["p_mean"], train["p_std"],
                                        m["patch_size"])
                (losses.sum() / used).backward()
                total += float(losses.detach().sum())
            out["loss"].append(total / used)
            grads = {k: p.grad for k, p in params.items()}
            clipped = opt.step(grads)
            if out["grad"] is None:
                out["grad"] = leaf_norms(clipped)
            for p in params.values():
                p.grad = None
            e = train["ema"]
            if e is not None:
                edm.ema_update(ema, {k: p.detach() for k, p in params.items()}, step,
                               e["smoothing"], e["start"], e.get("interval", 1))
        with torch.no_grad():
            out["update"] = {k: float(torch.linalg.vector_norm(p - w0[k]))
                             for k, p in params.items()}
            out["ema"] = {k: float(torch.linalg.vector_norm(e - w0[k])) for k, e in ema.items()}
        del model, params, opt, ema
        out["w0"] = w0
    return out
