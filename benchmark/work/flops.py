"""The yardstick's work counts: operations and bytes of the functions the
rooflines read, the model FLOPs that ``mfu`` reads, and the card's peaks.

Frozen copies of ``chip_smoke.py``'s ``*_flops_bytes`` functions and ``bound``
(attention forward and backward, the expert FFN forward and backward), written for
any head width, plus the model-FLOP count of a MicroDiT configuration: every matrix
product of one forward, counted as 2 * M * N * K, from the configuration's sizes
alone. A later change to the program cannot change what these count.

Rooflines count the function, not the kernel: each input byte is read once and each
output byte written once, in bf16, against the dense bf16 peak and the HBM bandwidth.
"""

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM, HBM3


def bound_s(flops, nbytes):
    """The least time a call needs: the larger of its operations over the bf16 peak
    and its bytes over the bandwidth, in seconds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def attn_flops_bytes(b, tq, tk, h, d=64):
    """Attention forward: 2 products of 2*B*H*Tq*Tk*D; q read and out written (Tq
    rows), k and v read (Tk rows), bf16."""
    return 4 * b * h * tq * tk * d, 2 * 2 * d * h * b * (tq + tk)


def attn_bwd_flops_bytes(b, tq, tk, h, d=64):
    """Attention backward: 5 products of 2*B*H*Tq*Tk*D (the scores again, dv, dp, dq,
    dk); q and do read and dq written (Tq rows), k and v read and dk, dv written (Tk
    rows), bf16."""
    return 5 * 2 * b * h * tq * tk * d, 2 * d * h * b * (3 * tq + 4 * tk)


def moe_flops_bytes(n, e, k, d, f):
    """Expert FFN forward on n * k rows of each of e experts: x w1, then gelu(.) w2;
    x read, out written, w1 and w2 read, bf16."""
    return 4 * n * e * k * d * f, 2 * (2 * n * e * k * d + 2 * e * d * f)


def moe_bwd_flops_bytes(n, e, k, d, f):
    """Expert FFN backward: the hidden again and the 4 gradient products; x and do
    read and dx written, w1 and w2 read and dw1, dw2 written, bf16."""
    return 5 * 2 * n * e * k * d * f, 2 * (3 * n * e * k * d + 4 * e * d * f)


# ---------------------------------------------------------------- the model's shapes


def _rounded(x, multiple):
    return multiple * ((x + multiple - 1) // multiple)


def qkv_hidden(dim, ratio, head_dim):
    """Per-block qkv width: dim * ratio rounded up to a multiple of 2 * head_dim
    (reference dit.py:192-195)."""
    if ratio == 1:
        return dim
    unit = 2 * head_dim
    return unit * ((int(dim * ratio) + unit - 1) // unit)


def _linspace(lo, hi, n):
    """numpy's, as the model zoo spreads the ratios (a last-ulp difference would
    move a width across a rounding step)."""
    return [float(r) for r in np.linspace(lo, hi, num=n)]


def moe_flags(depth, every, skip_last):
    """Which blocks are EC-MoE: every ``every``-th of range(0, depth - 1) in the
    backbone, of range(1, depth) in the mixer (reference dit.py:346-349, 410-414)."""
    cands = range(0, depth - 1) if skip_last else range(1, depth)
    return [i in cands and (i + 1) % every == 0 for i in range(depth)]


def blocks(m):
    """Each DiT block of the model ``m`` (a configuration's ``model`` dict) as a dict:
    where it is ('mixer' or 'backbone'), its width, qkv width, feed-forward width
    and whether it is an EC-MoE block."""
    out = []
    every = m["experts_every_n"]
    for i, moe in enumerate(moe_flags(m["mixer_depth"], every, skip_last=False)):
        out.append(dict(where="mixer", dim=m["mixer_dim"], qkv=m["mixer_dim"],
                        mlp=int(m["mixer_dim"] * m["mixer_mlp_ratio"]), moe=moe))
    qkv_r = _linspace(*m["qkv_ratio"], m["depth"])
    mlp_r = _linspace(*m["mlp_ratio"], m["depth"])
    for i, moe in enumerate(moe_flags(m["depth"], every, skip_last=True)):
        out.append(dict(where="backbone", dim=m["dim"],
                        qkv=qkv_hidden(m["dim"], qkv_r[i], m["head_dim"]),
                        mlp=int(m["dim"] * mlp_r[i]), moe=moe))
    return out


def tokens(m, mask_ratio):
    """(tokens of the mixer, tokens of the backbone) per image."""
    t = (m["latent_res"] // m["patch_size"]) ** 2
    return t, int(t * (1 - mask_ratio))


def attention_calls(m, rows, mask_ratio):
    """Every attention call of one forward on ``rows`` images: (B, Tq, Tk, H, D)."""
    t_mix, t_keep = tokens(m, mask_ratio)
    hd, cap = m["head_dim"], m["caption_len"]
    calls = [(rows, cap, cap, m["dim"] // hd, hd)]  # the caption block
    for blk in blocks(m):
        t = t_mix if blk["where"] == "mixer" else t_keep
        calls.append((rows, t, t, blk["qkv"] // hd, hd))
        calls.append((rows, t, cap, blk["dim"] // hd, hd))
    return calls


def expert_calls(m, rows, mask_ratio):
    """Every expert FFN call of one forward on ``rows`` images: (n, e, k, d, f), each
    expert taking its top k = capacity * T / E tokens of each image."""
    t_mix, t_keep = tokens(m, mask_ratio)
    out = []
    for blk in blocks(m):
        if not blk["moe"]:
            continue
        t = t_mix if blk["where"] == "mixer" else t_keep
        e = m["num_experts"]
        k = int(m["expert_capacity"] * t / e)
        out.append((rows, e, k, blk["dim"], _rounded(blk["mlp"], m["multiple_of"])))
    return out


def _ffn_hidden(dim_hidden, multiple_of):
    """SwiGLU hidden: 2/3 of the width, rounded up (reference dit.py:63-94)."""
    return _rounded(int(2 * dim_hidden / 3), multiple_of)


def forward_flops(m, mask_ratio=0.0):
    """The FLOPs of one image's forward, by part: {'linear', 'attention', 'experts'}.
    ``first_dx``: the products whose input gradient a training backward skips, since
    their input is data (the patch embedding, the timestep MLP's first layer, the
    caption projection's first layer)."""
    t_mix, t_keep = tokens(m, mask_ratio)
    d, cap, c_in = m["dim"], m["caption_len"], m["caption_channels"]
    p, ch = m["patch_size"], m["in_channels"]
    mm = lambda rows, k, n: 2 * rows * k * n
    first = mm(t_mix, ch * p * p, d) + mm(1, m["freq_dim"], d) + mm(cap, c_in, d)
    lin = first
    lin += mm(1, d, d)                       # t_embedder.mlp.2
    lin += mm(cap, d, d)                     # y_embedder fc2
    h = _ffn_hidden(4 * d, m["multiple_of"])
    lin += mm(cap, d, 3 * d) + mm(cap, d, d) + 2 * mm(cap, d, h) + mm(cap, h, d)
    lin += 2 * mm(1, d, d)                   # pooled_y_emb_process
    dm = m["mixer_dim"]
    if dm != d:                              # patch_mixer_map_xin / _y / _xout
        lin += mm(t_mix, d, dm) + mm(cap, d, dm) + mm(t_keep, dm, d)
    experts = 0
    for blk in blocks(m):
        t = t_mix if blk["where"] == "mixer" else t_keep
        w, q = blk["dim"], blk["qkv"]
        lin += mm(1, d, 6 * w)               # adaLN
        lin += mm(t, w, 3 * q) + mm(t, q, w)  # self-attention projections
        lin += mm(t, w, w) + mm(cap, w, 2 * w) + mm(t, w, w)  # cross-attention
        if blk["moe"]:
            lin += mm(t, w, m["num_experts"])  # the gate
        else:
            hf = _ffn_hidden(blk["mlp"], m["multiple_of"])
            lin += 2 * mm(t, w, hf) + mm(t, hf, w)
    for n, e, k, dd, f in expert_calls(m, 1, mask_ratio):
        experts += 2 * mm(n * e * k, dd, f)
    lin += mm(1, d, 2 * d) + mm(t_keep, d, p * p * ch)  # the final layer
    attention = sum(4 * b * tq * tk * h * hd
                    for b, tq, tk, h, hd in attention_calls(m, 1, mask_ratio))
    return {"linear": lin, "attention": attention, "experts": experts, "first_dx": first}


def model_flops(m, mask_ratio=0.0, train=False):
    """One image's model FLOPs: the forward, or for training the forward and the
    backward that autograd runs (each product's two gradients, less the input
    gradients of ``first_dx``). Recomputation is not counted."""
    f = forward_flops(m, mask_ratio)
    fwd = f["linear"] + f["attention"] + f["experts"]
    return 3 * fwd - f["first_dx"] if train else fwd


def function_work(m, rows, mask_ratio, train):
    """{'attention': (flops, bytes, least seconds), 'moe': ...} of one forward on
    ``rows`` images (and its backward when ``train``), the least time summed call by
    call."""
    out = {}
    for name, calls, fwd, bwd in (
            ("attention", attention_calls(m, rows, mask_ratio),
             lambda c: attn_flops_bytes(*c), lambda c: attn_bwd_flops_bytes(*c)),
            ("moe", expert_calls(m, rows, mask_ratio),
             lambda c: moe_flops_bytes(*c), lambda c: moe_bwd_flops_bytes(*c))):
        flops = nbytes = least = 0.0
        for c in calls:
            for fn in (fwd, bwd) if train else (fwd,):
                fl, by = fn(c)
                flops += fl
                nbytes += by
                least += bound_s(fl, by)
        out[name] = (flops, nbytes, least)
    return out
