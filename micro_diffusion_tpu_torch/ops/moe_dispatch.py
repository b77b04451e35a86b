"""EC-MoE dispatch and combine with explicit adjoints.

Counterpart of ``micro_diffusion_tpu/ops/moe_dispatch.py`` (the ``hybrid`` dispatch)
and of the flat expert-major row movement of the ``gather`` family
(``models/layers.py:311-390``). Expert-choice routing picks tokens within each
sample, so dispatch and combine are block-diagonal per sample: a row gather or a
one-hot matmul. Each direction takes the cheap form and defines the adjoint of the
other exactly:

  dispatch_rows: fwd = row gather          bwd = one-hot matmul
  combine_rows:  fwd = one-hot matmul      bwd = row gather

  gather_expert_rows:  fwd = row gather (x_flat -> (e, m, d))
                       bwd = e collision-free scatter-adds, one per expert
  combine_expert_rows: fwd = e collision-free scatter-adds, one per expert
                       bwd = row gather

One expert's top-k picks within a sample are distinct tokens, and the flat
indices of different samples differ, so each expert's scatter writes every row at
most once. Adding the experts one after another, in expert order, gives sums that
do not depend on thread scheduling: on the card the results are bitwise
repeatable, unlike one ``index_add_`` over all e * m rows, whose atomics add
colliding rows in a different order from run to run.
"""

import torch


def _onehot(idx, t: int, dtype):
    """(n, r) int indices -> (n, r, t) one-hot selection matrix."""
    return (idx[..., None] == torch.arange(t, device=idx.device)).to(dtype)


class _DispatchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.t = x.shape[1]
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    @staticmethod
    def backward(ctx, dxg):
        (idx,) = ctx.saved_tensors
        # the scatter-add written as a matmul: dx[n] = D[n]^T @ dxg[n]
        return torch.bmm(_onehot(idx, ctx.t, dxg.dtype).transpose(1, 2), dxg), None


class _CombineRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hg, idx, t):
        ctx.save_for_backward(idx)
        return torch.bmm(_onehot(idx, t, hg.dtype).transpose(1, 2), hg)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        dhg = torch.gather(dout, 1, idx[..., None].expand(-1, -1, dout.shape[-1]))
        return dhg, None, None


def dispatch_rows(x, idx):
    """Gather rows ``idx`` (n, r) out of ``x`` (n, t, d) -> (n, r, d); its adjoint is
    the one-hot matmul."""
    return _DispatchRows.apply(x, idx)


def combine_rows(hg, idx, t: int):
    """Scatter-add rows ``hg`` (n, r, d) to positions ``idx`` (n, r) of a (n, t, d)
    zero canvas, as a one-hot matmul (duplicates accumulate); its adjoint is the
    row gather."""
    return _CombineRows.apply(hg, idx, t)


def _scatter_experts(rows, gidx, num_rows: int):
    """sum over experts i of the rows[i] scattered to gidx[i] of a zero canvas
    (num_rows, d), expert by expert (each expert's indices are distinct)."""
    out = rows.new_zeros((num_rows, rows.shape[-1]))
    for i in range(rows.shape[0]):
        out.index_add_(0, gidx[i], rows[i])
    return out


class _GatherExpertRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_flat, gidx):
        ctx.save_for_backward(gidx)
        ctx.num_rows = x_flat.shape[0]
        e, m = gidx.shape
        return x_flat.index_select(0, gidx.reshape(-1)).view(e, m, x_flat.shape[-1])

    @staticmethod
    def backward(ctx, dxin):
        (gidx,) = ctx.saved_tensors
        return _scatter_experts(dxin, gidx, ctx.num_rows), None


class _CombineExpertRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, gidx, num_rows):
        ctx.save_for_backward(gidx)
        return _scatter_experts(rows, gidx, num_rows)

    @staticmethod
    def backward(ctx, dout):
        (gidx,) = ctx.saved_tensors
        e, m = gidx.shape
        return dout.index_select(0, gidx.reshape(-1)).view(e, m, dout.shape[-1]), None, None


def gather_expert_rows(x_flat, gidx):
    """Rows ``gidx`` (e, m) of ``x_flat`` (rows, d) -> expert-major (e, m, d); the
    backward adds the cotangent back expert by expert (deterministic)."""
    return _GatherExpertRows.apply(x_flat, gidx)


def combine_expert_rows(rows, gidx, num_rows: int):
    """Expert-major ``rows`` (e, m, d) added to positions ``gidx`` (e, m) of a zero
    (num_rows, d) canvas, expert by expert (deterministic); the backward is the
    row gather."""
    return _CombineExpertRows.apply(rows, gidx, num_rows)
