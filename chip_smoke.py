#!/usr/bin/env python3
"""Drive the PyTorch port (micro_diffusion_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases, each of which fails the run on a failed check:
  1. device  - the card's name and power limit; build the CUDA kernels (one nvcc
               per source, started together) and report the build time.
  2. kernels - each hand-written kernel against its plain PyTorch version on the
               card, in bf16, at the shapes of the MicroDiT-XL sampling path;
               CUDA-event times of kernel, plain version and (attention only)
               F.scaled_dot_product_attention as the library yardstick.
     The backward kernels likewise at every MicroDiT-XL stage-1 training shape
               (microbatch 256) and the 512px ones, with SDPA's backward as the
               attention yardstick.
     The fused adaLN LayerNorm+modulate kernel (K6) likewise at every shape the
               trainer path runs (XL stage 1, the Tiny round trip) and one 512px
               shape (no PyTorch call computes it: no library yardstick).
  3. slice   - MicroDiT-XL at full width (256px, seeded init with the zero-init
               layers perturbed): one CFG forward through the kernels against the
               same forward through the plain versions, then generate() of 4
               prompts, 30 Heun steps, CFG 5.0, with the launch counts checked.
  4. train   - the MicroDiT-XL stage-1 train step at full width and depth (mask
               0.75, microbatch 256, AdamW 2.4e-4 / wd 0.1 / clip 0.25, cosine with
               2500 warmup steps): one microbatch's loss and whole gradient through
               the kernels against the plain versions, then a warm-up step and
               timed steps with the launch counts checked, and a profiled step.
  5. trainer - the XL stage-1 recipe through the port's entry point
               (train.cli.main with the H100 overlay: fused adaLN, remat 'dots')
               on a seeded synthetic MDS latents dataset: 6 steps at batch 256 and
               one eval, the launch counts of all five kernels checked every step;
               then one microbatch's gradient under 'dots' against 'full', 3 bare
               make_train_step calls on the same state for the trainer-vs-bare
               ratio, and 3 with remat 'full' for the peaks and times.
  6. resume  - MicroDiT-Tiny through the entry point: 4 steps straight against 2
               steps, a checkpoint and an autoresume to 4; the parameters agree.

Prints each phase's wall time, a `kernels` JSON line and the card's name and
power limit before the last line, and as the last line {"ok": true, "device": {...}}. Exits non-zero,
printing no result, when there is no card or the package is not beside it.
Imports nothing of JAX.
"""

import collections
import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
STEPS = 30    # Heun steps: 2 * 30 - 1 = 59 CFG-doubled DiT forwards
PROMPTS = 4   # x2 for CFG: batch 8 through the DiT
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
ATTN_TOL = 2e-2  # max |kernel - plain|, bf16 outputs of magnitude <~ 1: a few bf16 ulps
MOE_TOL = 2e-2   # same; one-ulp flips of bf16(a) between summation orders stay far below
SLICE_TOL = 3e-2  # relative L2 of the XL CFG forward, kernel vs plain path, after 34
                  # blocks of bf16 rounding that differs between the two paths
BWD_TOL = 1e-2  # max |kernel - plain| / max |plain| per gradient: dk, dv, dw are fp32
                # sums over many rows stored in bf16 (one ulp = 2^-8 of an entry)
TRAIN_LOSS_TOL = 1e-2  # relative, XL stage-1 loss of one microbatch, kernels vs plain
TRAIN_GRAD_TOL = 5e-2  # relative L2 of the whole flattened gradient, kernels vs plain:
                       # the forward's 34 blocks of differing bf16 rounding (rel L2
                       # ~1.5e-2 at the output) compound again through the backward
ATTN_REPLACES = "micro_diffusion_tpu/ops/flash_attention_lane.py:58"
MOE_REPLACES = "micro_diffusion_tpu/ops/moe_ffn.py:74"
ATTN_BWD_REPLACES = "micro_diffusion_tpu/ops/flash_attention_lane.py:80"
MOE_BWD_REPLACES = "micro_diffusion_tpu/ops/moe_ffn.py:124"
TRAIN_MB = 256  # the stage-1 recipe's per-device microbatch (res_256_pretrain.yaml:19)
TRAIN_STEPS = 3  # timed steps after the warm-up step
REMAT = True  # without block remat the mb-256 forward alone outgrows the 80 GB card
              # (77 GiB allocated when it ran out, H100 80GB HBM3)
ATTN_BWD_SHAPES = [  # (B, Tq, Tk, H): stage 1 at mb 256, then 512px
    (256, 77, 77, 16), (256, 256, 256, 12), (256, 256, 77, 12), (256, 64, 64, 8),
    (256, 64, 64, 10), (256, 64, 64, 12), (256, 64, 64, 14), (256, 64, 64, 16),
    (256, 64, 77, 16), (8, 1024, 1024, 16), (8, 1024, 77, 16),
]
MOE_BWD_SHAPES = [  # (n, e, k, d, f): stage-1 mixer, two backbone widths, 512px
    (256, 8, 64, 768, 3072), (256, 8, 16, 1024, 768), (256, 8, 16, 1024, 3840),
    (8, 8, 256, 1024, 3840),
]
ATTN_SHAPES = [  # (Tq, Tk, H) at B = 8 (4 prompts x CFG)
    (256, 256, 8), (256, 256, 12), (256, 256, 16), (256, 77, 12), (256, 77, 16),
    (77, 77, 16), (1024, 1024, 16), (1024, 77, 16),
]
MOE_SHAPES = [  # (k, d, f) at n = 8, e = 8
    (64, 768, 3072), (64, 1024, 768), (64, 1024, 3840), (256, 1024, 3840),
]
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
ADALN_REPLACES = "micro_diffusion_tpu/ops/adaln.py:22"
ADALN_TOL = 1e-2  # max |kernel - plain| / max |plain|: the one bf16 rounding of the
                  # output (2^-8 of an entry) with fp32 sums taken in another order
ADALN_SHAPES = [  # (B, T, D): XL stage 1 at mb 256 (mixer, backbone and final
                  # layer), the Tiny round trip at mb 16, XL 512px at mb 32
    (256, 256, 768), (256, 64, 1024), (16, 256, 512), (16, 64, 512), (32, 1024, 768),
]
TRAINER_STEPS = 6   # fit steps of the [trainer] phase, then one eval
TRAINER_SAMPLES = 1024  # synthetic train samples (166 KB each), 4 steps per epoch
EVAL_SAMPLES = 256
RESUME_BATCH, RESUME_MB = 32, 16  # Tiny round trip: K = 2 microbatches per step
RESUME_TOL = 1e-6  # relative L2 of all parameters, straight vs resumed
ROOT = os.path.dirname(os.path.abspath(__file__))
OVERLAY = os.path.join(ROOT, "micro_diffusion_tpu_torch", "configs", "h100_1gpu")
PROMPTS_FILE = os.path.join(ROOT, "configs", "eval_prompts.yaml")  # the recipe's, cwd-free


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Device time per call, by CUDA events around `iters` back-to-back calls. The
    stream is first held by a ~10 ms spin kernel so that the host enqueues every
    call before the first one runs: the events then time the device work alone,
    not the wrappers' Python overhead (which is part of the slice's wall time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- kernels


def attn_case(tq, tk, h, gen, b=8):
    """q (B, Tq, H, 64) contiguous; k and v strided views of one packed kv
    tensor, as the cross-attention path hands them to the kernel."""
    import torch

    q = torch.randn(b, tq, h, 64, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(b, tk, 2, h * 64, generator=gen, device="cuda").bfloat16()
    k = kv[:, :, 0].view(b, tk, h, 64)
    v = kv[:, :, 1].view(b, tk, h, 64)
    return q, k, v


def moe_case(k, d, f, gen, n=8, e=8):
    import torch

    xg = torch.randn(n, e, k, d, generator=gen, device="cuda").bfloat16()
    w1 = (0.02 * torch.randn(e, d, f, generator=gen, device="cuda")).bfloat16()
    w2 = (0.02 * torch.randn(e, f, d, generator=gen, device="cuda")).bfloat16()
    return xg, w1, w2


def attn_flops_bytes(b, tq, tk, h):
    return 4 * b * h * tq * tk * 64, 2 * 2 * 64 * h * b * (tq + tk)


def moe_flops_bytes(n, e, k, d, f):
    return 4 * n * e * k * d * f, 2 * (2 * n * e * k * d + 2 * e * d * f)


def attn_bwd_flops_bytes(b, tq, tk, h):
    """5 products of 2*B*H*Tq*Tk*64; q, do read and dq written (Tq rows), k, v read
    and dk, dv written (Tk rows), bf16."""
    return 5 * 2 * b * h * tq * tk * 64, 2 * 64 * h * b * (3 * tq + 4 * tk)


def moe_bwd_flops_bytes(n, e, k, d, f):
    """The 4 gradient products and the recompute of a; x, do read and dx written,
    w1, w2 read and dw1, dw2 written, bf16."""
    return 5 * 2 * n * e * k * d * f, 2 * (3 * n * e * k * d + 4 * e * d * f)


def adaln_flops_bytes(b, t, d):
    """About 10 fp32 operations per element (the two statistics, normalise, weight,
    modulate); x read and out written in bf16, shift and scale read once, the fp32
    weight once."""
    return 10 * b * t * d, 2 * 2 * b * t * d + 2 * 2 * b * d + 4 * d


def rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def check_attention(shape, gen, b=8):
    import torch
    import torch.nn.functional as F
    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")

    tq, tk, h = shape
    q, k, v = attn_case(tq, tk, h, gen, b)
    out = fal.flash_attention_lane(q, k, v)
    torch.cuda.synchronize()
    ref = fal.flash_attention_lane_plain(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    if not (math.isfinite(err) and err <= ATTN_TOL):
        raise AssertionError(f"attention {shape}: max abs err {err} > {ATTN_TOL}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = time_ms(lambda: fal.flash_attention_lane(q, k, v))
    plain_ms = time_ms(lambda: fal.flash_attention_lane_plain(q, k, v), iters=5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bound_ms, by = bound(*attn_flops_bytes(b, tq, tk, h))
    return dict(B=b, Tq=tq, Tk=tk, H=h, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)


def check_moe(shape, gen, n=8, e=8):
    import torch
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

    k, d, f = shape
    xg, w1, w2 = moe_case(k, d, f, gen, n, e)
    out = mf.moe_ffn(xg, w1, w2)
    torch.cuda.synchronize()
    ref = mf.moe_ffn_plain(xg, w1, w2)
    err = (out.float() - ref.float()).abs().max().item()
    if not (math.isfinite(err) and err <= MOE_TOL):
        raise AssertionError(f"moe_ffn {shape}: max abs err {err} > {MOE_TOL}")
    ms = time_ms(lambda: mf.moe_ffn(xg, w1, w2))
    plain_ms = time_ms(lambda: mf.moe_ffn_plain(xg, w1, w2), iters=5)
    bound_ms, by = bound(*moe_flops_bytes(n, e, k, d, f))
    return dict(n=n, e=e, k=k, d=d, f=f, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)


def check_attention_bwd(shape, gen):
    import torch
    import torch.nn.functional as F
    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")

    b, tq, tk, h = shape
    q, k, v = attn_case(tq, tk, h, gen, b)
    do = torch.randn(b, tq, h, 64, generator=gen, device="cuda").bfloat16()
    got = fal.flash_attention_lane_bwd(q, k, v, do)
    torch.cuda.synchronize()
    ref = fal.flash_attention_lane_bwd_plain(q, k, v, do)
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    if not all(math.isfinite(e) and e <= BWD_TOL for e in errs):
        raise AssertionError(f"attention backward {shape}: rel errs (dq, dk, dv) {errs} "
                             f"> {BWD_TOL}")
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    del got, ref
    ms = time_ms(lambda: fal.flash_attention_lane_bwd(q, k, v, do))
    plain_ms = time_ms(lambda: fal.flash_attention_lane_bwd_plain(q, k, v, do), iters=3,
                       warmup=1)
    # the library yardstick: SDPA's backward alone, on a retained forward graph
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
    bound_ms, by = bound(*attn_bwd_flops_bytes(b, tq, tk, h))
    return dict(B=b, Tq=tq, Tk=tk, H=h, max_abs_err=err, max_rel_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)


def check_moe_bwd(shape, gen):
    import torch
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

    n, e, k, d, f = shape
    xg, w1, w2 = moe_case(k, d, f, gen, n, e)
    do = torch.randn(n, e, k, d, generator=gen, device="cuda").bfloat16()
    got = mf.moe_ffn_bwd(xg, w1, w2, do)
    torch.cuda.synchronize()
    ref = mf.moe_ffn_bwd_plain(xg, w1, w2, do)
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    if not all(math.isfinite(e_) and e_ <= BWD_TOL for e_ in errs):
        raise AssertionError(f"moe_ffn backward {shape}: rel errs (dx, dw1, dw2) {errs} "
                             f"> {BWD_TOL}")
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    del got, ref
    ms = time_ms(lambda: mf.moe_ffn_bwd(xg, w1, w2, do), iters=10)
    plain_ms = time_ms(lambda: mf.moe_ffn_bwd_plain(xg, w1, w2, do), iters=3, warmup=1)
    bound_ms, by = bound(*moe_bwd_flops_bytes(n, e, k, d, f))
    return dict(n=n, e=e, k=k, d=d, f=f, max_abs_err=err, max_rel_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=None)


def check_adaln(shape, gen):
    """K6 against its plain version, with shift/scale as the strided chunks of one
    (B, 6D) projection (as the DiT block hands them over), with and without the
    weight."""
    import torch
    ad = importlib.import_module("micro_diffusion_tpu_torch.ops.adaln")

    b, t, d = shape
    x = torch.randn(b, t, d, generator=gen, device="cuda").bfloat16()
    mod = (0.5 * torch.randn(b, 6 * d, generator=gen, device="cuda")).bfloat16()
    shift, scale = mod.chunk(6, dim=1)[:2]
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    errs = []
    for weight in (w, None):
        out = ad.layernorm_modulate(x, weight, shift, scale)
        torch.cuda.synchronize()
        ref = ad.layernorm_modulate_plain(x, weight, shift, scale)
        errs.append((rel_err(out, ref), (out.float() - ref.float()).abs().max().item()))
    if not all(math.isfinite(e) and e <= ADALN_TOL for e, _ in errs):
        raise AssertionError(f"layernorm_modulate {shape}: rel errs (weight, none) "
                             f"{[e for e, _ in errs]} > {ADALN_TOL}")
    ms = time_ms(lambda: ad.layernorm_modulate(x, w, shift, scale))
    plain_ms = time_ms(lambda: ad.layernorm_modulate_plain(x, w, shift, scale), iters=5)
    bound_ms, by = bound(*adaln_flops_bytes(b, t, d), peak_flops=PEAK_FP32_FLOPS)
    return dict(B=b, T=t, D=d, max_abs_err=max(a for _, a in errs),
                max_rel_err=max(e for e, _ in errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)


# ------------------------------------------------------------------ slice


@contextlib.contextmanager
def plain_kernels():
    """Route the model's two kernel call sites to the kernels' plain versions,
    forward and backward (the plain backwards run in the autograd Functions)."""
    from micro_diffusion_tpu_torch.models import layers
    from micro_diffusion_tpu_torch.ops import attention

    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")
    saved = attention.flash_attention_lane, layers.moe_ffn
    attention.flash_attention_lane = fal.flash_attention_lane_reference
    layers.moe_ffn = mf.moe_ffn_reference
    try:
        yield
    finally:
        attention.flash_attention_lane, layers.moe_ffn = saved


@contextlib.contextmanager
def record_shapes(dit):
    """Collect the attention (B, Tq, Tk, H) and MoE (n, e, k, d, f) call shapes of
    the forwards run inside the block, through forward pre-hooks."""
    from micro_diffusion_tpu_torch.models import layers

    attn, moe, adaln = collections.Counter(), collections.Counter(), collections.Counter()

    def on_self(mod, args):
        x = args[0]
        attn[(x.shape[0], x.shape[1], x.shape[1], mod.num_heads)] += 1

    def on_cross(mod, args):
        x, cond = args[0], args[1]
        attn[(x.shape[0], x.shape[1], cond.shape[-2], mod.num_heads)] += 1

    def on_moe(mod, args):
        n, t, d = args[0].shape
        e = mod.num_experts
        moe[(n, e, int(mod.expert_capacity * t / e), d, mod.w1.shape[-1])] += 1

    def on_norm(mod, args):
        if len(args) > 1 and args[1] is not None:  # called with (shift, scale)
            adaln[tuple(args[0].shape)] += 1

    hooks = []
    for mod in dit.modules():
        if isinstance(mod, layers.LayerNorm) and mod.fused_adaln:
            hooks.append(mod.register_forward_pre_hook(on_norm))
        elif isinstance(mod, layers.SelfAttention):
            hooks.append(mod.register_forward_pre_hook(on_self))
        elif isinstance(mod, layers.CrossAttention):
            hooks.append(mod.register_forward_pre_hook(on_cross))
        elif isinstance(mod, layers.FeedForwardECMoe):
            hooks.append(mod.register_forward_pre_hook(on_moe))
    try:
        yield attn, moe, adaln
    finally:
        for hk in hooks:
            hk.remove()


def perturb_zero_init(module, gen, std=0.02):
    """Give the zero-initialised layers (adaLN, final layer, prompt-block output
    projections) random values: with them at zero every block is the identity and
    a kernel-versus-plain comparison proves nothing."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.normal_(0.0, std, generator=gen)


def run_slice(steps, prompts):
    import torch
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion

    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

    t0 = time.perf_counter()
    model = create_latent_diffusion(dit_arch="MicroDiT_XL_2", latent_res=32,
                                    device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    perturb_zero_init(model.dit, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.dit.parameters())
    log(f"[slice] MicroDiT-XL built on cuda: {n_params} params, "
        f"{time.perf_counter() - t0:.1f} s")

    y = torch.randn(prompts, 77, 1024, generator=gen, device="cuda")
    x = torch.randn(prompts, 4, 32, 32, generator=gen, device="cuda")
    sigma = torch.full((1,), 2.5, device="cuda")
    with torch.no_grad(), record_shapes(model.dit) as (attn_shapes, moe_shapes, _):
        out_k = model.model_forward_wrapper(x, sigma, y, cfg=5.0)["sample"]
    with torch.no_grad(), plain_kernels():
        out_p = model.model_forward_wrapper(x, sigma, y, cfg=5.0)["sample"]
    torch.cuda.synchronize()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    finite = bool(torch.isfinite(out_k).all())
    log(f"[slice] XL CFG forward, kernels vs plain: rel L2 {rel:.3e} (tol {SLICE_TOL}), "
        f"finite {finite}")
    if not (finite and rel <= SLICE_TOL):
        raise AssertionError(f"XL CFG forward: kernels vs plain rel L2 {rel}")

    # per XL forward: 1 caption self-attention + (6 mixer + 28 backbone) blocks x
    # (self + cross) = 69 attention calls; MoE in mixer blocks 1,3,5 and backbone
    # blocks 1,3,...,25 = 16 calls
    per_fwd = (sum(attn_shapes.values()), sum(moe_shapes.values()))
    if per_fwd != (69, 16):
        raise AssertionError(f"XL forward ran {per_fwd} attention/MoE calls, not (69, 16)")
    want_attn, want_moe = (2 * steps - 1) * 69, (2 * steps - 1) * 16
    fal.flash_attention_lane.launches = 0
    mf.moe_ffn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents = model.generate(text_embeddings=y, guidance_scale=5.0,
                             num_inference_steps=steps, seed=SEED,
                             return_only_latents=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attention": fal.flash_attention_lane.launches,
                "moe": mf.moe_ffn.launches}
    log(f"[slice] generate: {prompts} prompts, {steps} Heun steps, CFG 5.0: "
        f"{wall * 1e3:.1f} ms, {wall * 1e3 / prompts:.2f} ms/image, "
        f"{prompts / wall:.3f} img/s (256px); launches {launches}, "
        f"expected attention {want_attn} moe {want_moe}")
    if tuple(latents.shape) != (prompts, 4, 32, 32):
        raise AssertionError(f"latents shape {tuple(latents.shape)}")
    if not bool(torch.isfinite(latents).all()):
        raise AssertionError("latents not finite")
    if launches["attention"] != want_attn or launches["moe"] != want_moe:
        raise AssertionError(f"launch counts {launches} != {want_attn}, {want_moe}")
    profile_forward(model, x, sigma, y)
    return dict(attn_shapes=attn_shapes, moe_shapes=moe_shapes, launches=launches,
                rel_l2=rel, sampler_ms=wall * 1e3, img_per_s=prompts / wall,
                latents_std=latents.float().std().item())


def profile_forward(model, x, sigma, y, top=12):
    """One XL CFG forward (one sampler step's DiT call) under torch.profiler: wall
    time, the device's busy time (sum of kernel durations on the one stream) and
    idle share, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def fwd():
        with torch.no_grad():
            model.model_forward_wrapper(x, sigma, y, cfg=5.0)
        torch.cuda.synchronize()

    fwd()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log(f"[profile] XL CFG forward wall {wall:.2f} ms; device time not measured "
            "(the profiler saw no kernels)")
        return
    log(f"[profile] XL CFG forward (B=8): wall {wall:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {1 - busy / wall:.3f}, {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:110]}")


# ------------------------------------------------------------------ train


def kernel_counts():
    fal = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
    mf = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")
    ad = importlib.import_module("micro_diffusion_tpu_torch.ops.adaln")
    return {"attention": fal.flash_attention_lane, "attention_bwd": fal.flash_attention_lane_bwd,
            "moe": mf.moe_ffn, "moe_bwd": mf.moe_ffn_bwd, "adaln": ad.layernorm_modulate}


def reset_counts():
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counts().items()}


def train_batch(gen, b):
    """Seeded stage-1 batch: latents (b, 4, 32, 32), caption latents (b, 1, 77, 1024),
    10% of the captions dropped."""
    import torch

    return {
        "image_latents": torch.randn(b, 4, 32, 32, generator=gen, device="cuda"),
        "caption_latents": torch.randn(b, 1, 77, 1024, generator=gen, device="cuda"),
        "drop_caption_mask": (torch.rand(b, generator=gen, device="cuda") >= 0.1).float(),
    }


def compare_train_grads(model, batch, gen):
    """One microbatch's loss and whole gradient through the kernels and through the
    plain versions, with the same injected draws."""
    import torch
    from micro_diffusion_tpu_torch.ops.masking import make_token_mask

    b = batch["image_latents"].shape[0]
    t = (32 // model.dit.patch_size) ** 2
    draws = dict(rnd_normal=torch.randn(b, 1, 1, 1, generator=gen, device="cuda"),
                 noise=torch.randn(b, 4, 32, 32, generator=gen, device="cuda"),
                 token_mask=make_token_mask(gen, b, t, model.train_mask_ratio))
    params = [p for p in model.parameters() if p.requires_grad]

    def loss_and_grads():
        loss, _, _ = model(batch, **draws)
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_k, grads_k = loss_and_grads()
    with plain_kernels():
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    diff2 = sum((gk.float() - gp.float()).square().sum() for gk, gp in zip(grads_k, grads_p))
    ref2 = sum(gp.float().square().sum() for gp in grads_p)
    rel_grad = (diff2.sqrt() / ref2.sqrt()).item()
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    log(f"[train] mb {b}, kernels vs plain: loss {loss_k.item():.6f} vs {loss_p.item():.6f} "
        f"(rel {rel_loss:.3e}, tol {TRAIN_LOSS_TOL}); whole gradient rel L2 {rel_grad:.3e} "
        f"(tol {TRAIN_GRAD_TOL}), |grad| {ref2.sqrt().item():.4e}, finite {finite}")
    if not (finite and rel_loss <= TRAIN_LOSS_TOL and rel_grad <= TRAIN_GRAD_TOL):
        raise AssertionError(f"train step kernels vs plain: loss rel {rel_loss}, "
                             f"grad rel L2 {rel_grad}")
    return dict(rel_loss=rel_loss, rel_grad=rel_grad)


def run_train():
    import torch
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion
    from micro_diffusion_tpu_torch.train import (build_optimizer, build_schedule,
                                                 create_train_state, make_train_step)

    t0 = time.perf_counter()
    model = create_latent_diffusion(dit_arch="MicroDiT_XL_2", latent_res=32,
                                    train_mask_ratio=0.75, device="cuda", seed=SEED,
                                    remat=REMAT)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    # with adaLN-zero every gate is 0 and no gradient reaches attention or MoE
    perturb_zero_init(model.dit, gen)
    batch = train_batch(gen, TRAIN_MB)
    log(f"[train] MicroDiT-XL stage 1 on cuda, remat {REMAT}: built in "
        f"{time.perf_counter() - t0:.1f} s")
    cmp = compare_train_grads(model, batch, gen)

    sched = build_schedule({"_target_": "composer.optim.CosineAnnealingWithWarmupScheduler",
                            "t_warmup": "2500ba", "alpha_f": 0.33}, 2.4e-4, 250000)
    tx = build_optimizer(dict(model.dit.named_parameters()), sched, weight_decay=0.1,
                         betas=(0.9, 0.999), eps=1e-8, clip_norm=0.25)
    state = create_train_state(model.dit, tx)
    step_fn = make_train_step(model, tx, sched, microbatch_size=TRAIN_MB)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step(state):
        state, m = step_fn(state, batch, gen)
        m = {k: float(v) for k, v in m.items()}
        log(f"[train] step {state.step - 1}: loss {m['loss']:.6f} grad_norm "
            f"{m['grad_norm']:.6f} lr {m['lr']:.6e}")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"non-finite train metrics {m}")
        return state

    # the path's kernel shapes, from one forward of the loss (under remat the
    # backward re-runs each block's forward, which the hooks would count again)
    with torch.no_grad(), record_shapes(model.dit) as (attn_shapes, moe_shapes, _):
        model(batch, generator=gen)
    per_fwd = (sum(attn_shapes.values()), sum(moe_shapes.values()))
    if per_fwd != (69, 16):
        raise AssertionError(f"XL train forward ran {per_fwd} attention/MoE calls, not (69, 16)")
    state = step(state)  # warm-up (lr 0 at step 0)
    sums = [p.detach().double().sum().item() for p in state.params.values()]

    times = []
    for i in range(TRAIN_STEPS):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_counts()
        if i == 0:
            launches = counts
            changed = sum(a != p.detach().double().sum().item()
                          for a, p in zip(sums, state.params.values()))
            log(f"[train] step 1 changed {changed} of {len(sums)} parameter tensors")
            if changed < 0.9 * len(sums):
                raise AssertionError(f"step 1 changed only {changed} of {len(sums)} params")
    fwd_factor = 2 if REMAT else 1  # with remat the 34 blocks re-run their forward
    want = {"attention": 69 + 68 * (fwd_factor - 1), "attention_bwd": 69,
            "moe": 16 * fwd_factor, "moe_bwd": 16, "adaln": 0}  # fused adaLN off here
    log(f"[train] launches per K=1 step {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"train step launch counts {launches} != {want}")
    ms = sorted(times)[len(times) // 2] * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] stage 1, mb {TRAIN_MB}, K=1: step times "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median {ms:.1f} ms/step, "
        f"{TRAIN_MB / ms * 1e3:.2f} img/s; peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); remat {REMAT}")
    profile_step(lambda: step(state))
    return dict(attn_shapes=attn_shapes, moe_shapes=moe_shapes, launches=launches,
                ms_per_step=ms, img_per_s=TRAIN_MB / ms * 1e3, peak_bytes=peak, **cmp)


def profile_step(fn, top=15, label=f"XL stage-1 train step (mb {TRAIN_MB})"):
    """One train step under torch.profiler: wall time, device busy time (sum of
    kernel durations on the one stream), idle share, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log(f"[profile] train step wall {wall:.2f} ms; device time not measured "
            "(the profiler saw no kernels)")
        return
    log(f"[profile] {label}: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:110]}")


# ------------------------------------------------------------------ trainer


def write_latents(dirname, n, seed):
    """A seeded MDS latents dataset with the recipe's columns: fp16 caption latents
    (1, 77, 1024) and 256px image latents (4, 32, 32), 166 KB per sample."""
    import numpy as np
    from micro_diffusion_tpu_torch.datasets import MDSWriter

    rng = np.random.default_rng(seed)
    caps = rng.standard_normal((n, 1, 77, 1024), dtype=np.float32).astype(np.float16)
    lats = (0.8 * rng.standard_normal((n, 4, 32, 32), dtype=np.float32)).astype(np.float16)
    with MDSWriter(out=dirname, columns={"caption_latents": "bytes", "latents_256": "bytes"}) as w:
        for i in range(n):
            w.write({"caption_latents": caps[i].tobytes(), "latents_256": lats[i].tobytes()})


class TrainerProbe:
    """A trainer callback (fit_start / step_end / eval_end / fit_end): the kernel
    launches of every step and of the eval, the parameter tensors that step 1 (the
    first with a non-zero lr) changed, and those changed from then to the end. At
    the recipe's adaLN-zero init step 1 moves only the layers whose gradient is not
    gated by a zero (the adaLN and final projections); later steps move the rest.
    Runs with metric_window 1."""

    def __init__(self):
        self.steps, self.eval_counts, self.changed, self.changed_by_end = [], None, None, None
        self._mark, self._sums = None, None

    def _delta(self):
        now = read_counts()
        delta = {k: now[k] - self._mark[k] for k in now}
        self._mark = now
        return delta

    @staticmethod
    def _param_sums(trainer):
        import torch
        return torch.stack([p.detach().double().sum()
                            for p in trainer.state.params.values()]).cpu()

    def fit_start(self, trainer):
        self._mark = read_counts()

    def step_end(self, trainer, metrics):
        self.steps.append(self._delta())
        if trainer.global_step == 1:
            self._sums = self._param_sums(trainer)
        elif trainer.global_step == 2:
            self.changed = int((self._param_sums(trainer) != self._sums).sum())

    def eval_end(self, trainer, eval_loss):
        self.eval_counts = self._delta()

    def fit_end(self, trainer):
        self.changed_by_end = int((self._param_sums(trainer) != self._sums).sum())


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def bare_steps(trainer, batch, n):
    """``n`` make_train_step calls on the trainer's state, each synced; ms each."""
    import torch

    times = []
    for i in range(n):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state, m = trainer._step_fn(trainer.state, batch, gen)
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"bare step: non-finite loss {m}")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def remat_grads_agree(model, batch, gen):
    """One microbatch's loss and whole gradient under remat 'dots' and 'full' on the
    card, with the same draws: the selective context must rebuild what the kernels'
    autograd Functions saved, so the two agree (the same arithmetic in the same
    order; 1e-6 relative L2 leaves room for a GEMM algorithm that sums otherwise)."""
    import torch
    from micro_diffusion_tpu_torch.ops.masking import make_token_mask

    b = batch["image_latents"].shape[0]
    draws = dict(rnd_normal=torch.randn(b, 1, 1, 1, generator=gen, device="cuda"),
                 noise=torch.randn(b, 4, 32, 32, generator=gen, device="cuda"),
                 token_mask=make_token_mask(gen, b, (32 // model.dit.patch_size) ** 2,
                                            model.train_mask_ratio))
    params = [p for p in model.parameters() if p.requires_grad]
    policy, out = model.dit.remat_policy, {}
    for name in ("dots", "full"):
        model.dit.remat_policy = name
        loss, _, _ = model(batch, **draws)
        out[name] = (loss.detach(), torch.autograd.grad(loss, params))
    model.dit.remat_policy = policy
    (loss_d, grads_d), (loss_f, grads_f) = out["dots"], out["full"]
    equal = sum(bool(torch.equal(a, b)) for a, b in zip(grads_d, grads_f))
    diff2 = sum((a.float() - b.float()).square().sum() for a, b in zip(grads_d, grads_f))
    rel = (diff2.sqrt() / sum(b.float().square().sum() for b in grads_f).sqrt()).item()
    log(f"[trainer] remat 'dots' vs 'full', one microbatch of {b}: loss {loss_d.item():.6f} "
        f"vs {loss_f.item():.6f}; {equal} of {len(params)} gradients bitwise equal, whole "
        f"gradient relative L2 {rel:.3e} (tol 1e-6)")
    if not (torch.equal(loss_d, loss_f) and rel <= 1e-6):
        raise AssertionError(f"remat dots vs full: loss {loss_d.item()} vs {loss_f.item()}, "
                             f"gradient rel L2 {rel}")
    return rel


def run_trainer(tmp):
    """The XL stage-1 recipe through the entry point, then the bare-step and remat
    comparisons on the same model and state."""
    import torch
    from micro_diffusion_tpu_torch.train import cli

    t0 = time.perf_counter()
    train_dir, eval_dir = os.path.join(tmp, "train"), os.path.join(tmp, "eval")
    write_latents(train_dir, TRAINER_SAMPLES, SEED)
    write_latents(eval_dir, EVAL_SAMPLES, SEED + 1)
    metrics_path = os.path.join(tmp, "metrics.jsonl")
    log(f"[trainer] wrote {TRAINER_SAMPLES} + {EVAL_SAMPLES} synthetic MDS samples in "
        f"{time.perf_counter() - t0:.1f} s")
    argv = ["--config-path", OVERLAY, "--config-name", "res_256_pretrain",
            f"dataset.train.datadir={train_dir}", f"dataset.eval.datadir={eval_dir}",
            f"trainer.max_duration={TRAINER_STEPS}ba", "trainer.metric_window=1",
            f"trainer.eval_interval={TRAINER_STEPS}ba", "trainer.save_folder=null",
            "callbacks.speed_monitor.window_size=1",
            f"callbacks.image_monitor.prompts_file={PROMPTS_FILE}",
            "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
            f"logger.progress.path={metrics_path}"]
    probe = TrainerProbe()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.main(argv, callbacks=[probe])
    wall = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated()
    dit = trainer.model.dit
    log(f"[trainer] cli.main: {TRAINER_STEPS} steps + eval in {wall:.1f} s (model build "
        f"included); remat {dit.remat} '{dit.remat_policy}', fused adaLN on; peak "
        f"{fit_peak / 2**30:.2f} GiB")

    rows = read_jsonl(metrics_path)
    losses = [r["loss/train/total"] for r in rows if "loss/train/total" in r]
    norms = [r["l2_norm/grad/global"] for r in rows if "l2_norm/grad/global" in r]
    ips = {r["step"]: r["throughput/images_per_sec"] for r in rows
           if "throughput/images_per_sec" in r}
    waits = [r["trainer/data_wait_ms_per_step"] for r in rows
             if "trainer/data_wait_ms_per_step" in r]
    evals = [r["metrics/eval/loss"] for r in rows if "metrics/eval/loss" in r]
    log(f"[trainer] losses {losses}; grad norms {norms}; eval loss {evals}")
    if not (len(losses) == len(norms) == TRAINER_STEPS
            and all(math.isfinite(v) for v in losses + norms + evals) and len(evals) == 1):
        raise AssertionError(f"trainer metrics: {len(losses)} losses, {len(norms)} grad "
                             f"norms, evals {evals}; all finite expected")
    want = {"attention": 137, "attention_bwd": 69, "moe": 32, "moe_bwd": 16, "adaln": 137}
    want_eval = {"attention": 138, "attention_bwd": 0, "moe": 32, "moe_bwd": 0, "adaln": 138}
    log(f"[trainer] launches per step {probe.steps}; eval (2 batches of 128) "
        f"{probe.eval_counts}")
    if probe.steps != [want] * TRAINER_STEPS or probe.eval_counts != want_eval:
        raise AssertionError(f"trainer launch counts: steps {probe.steps} (want {want}), "
                             f"eval {probe.eval_counts} (want {want_eval})")
    n_params = len(trainer.state.params)
    log(f"[trainer] step 1 changed {probe.changed} of {n_params} parameter tensors; steps "
        f"1-{TRAINER_STEPS - 1} changed {probe.changed_by_end}")
    if not (probe.changed and probe.changed_by_end >= 0.9 * n_params):
        raise AssertionError(f"step 1 changed {probe.changed}, steps 1-{TRAINER_STEPS - 1} "
                             f"{probe.changed_by_end} of {n_params} params")
    windows = [ips[s] for s in sorted(ips) if s > 2]
    trainer_ips = sorted(windows)[len(windows) // 2]
    log(f"[trainer] images/s per step (SpeedMonitor, window 1) {ips}; median after the "
        f"first two steps {trainer_ips:.2f} img/s; data wait ms/step {waits}")

    # the path's K6 shapes from one forward (the remat re-run repeats the blocks')
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = {k: v.half() if v.dtype == torch.float32 and v.dim() > 1 else v
             for k, v in train_batch(gen, TRAIN_MB).items()}
    with torch.no_grad(), record_shapes(dit) as (_, _, adaln_fwd):
        trainer.model(batch, generator=gen)
    adaln_step = {s: 2 * c for s, c in adaln_fwd.items()}
    adaln_step[(TRAIN_MB, 64, dit.dim)] -= 1  # the final layer (64 kept tokens) runs
                                              # outside the remat blocks
    if sum(adaln_step.values()) != want["adaln"]:
        raise AssertionError(f"K6 shapes per step {adaln_step} do not sum to 137")

    remat_rel = remat_grads_agree(trainer.model, batch, gen)

    # bare make_train_step on the same model, state and configuration, resident batch
    torch.cuda.reset_peak_memory_stats()
    times = bare_steps(trainer, batch, 1 + TRAIN_STEPS)[1:]
    dots_peak = torch.cuda.max_memory_allocated()
    bare_ms = sorted(times)[len(times) // 2]
    bare_ips = TRAIN_MB / bare_ms * 1e3
    log(f"[trainer] bare make_train_step, remat '{dit.remat_policy}': step times "
        f"{', '.join(f'{t:.1f}' for t in times)} ms; median {bare_ms:.1f} ms, "
        f"{bare_ips:.2f} img/s; peak {dots_peak / 2**30:.2f} GiB; trainer / bare = "
        f"{trainer_ips / bare_ips:.3f}")
    policy = dit.remat_policy
    dit.remat_policy = "full"
    torch.cuda.reset_peak_memory_stats()
    full_times = bare_steps(trainer, batch, 1 + TRAIN_STEPS)[1:]
    full_peak = torch.cuda.max_memory_allocated()
    full_ms = sorted(full_times)[len(full_times) // 2]
    profile_step(lambda: bare_steps(trainer, batch, 1), label="XL stage-1 trainer step, "
                 "fused adaLN, remat 'full'", top=5)
    dit.remat_policy = policy
    log(f"[trainer] remat at mb {TRAIN_MB}, fused adaLN on (bare steps, warm-up + "
        f"{TRAIN_STEPS} timed each): '{policy}' peak {dots_peak / 2**30:.2f} GiB, median "
        f"{bare_ms:.1f} ms/step; 'full' peak {full_peak / 2**30:.2f} GiB, step times "
        f"{', '.join(f'{t:.1f}' for t in full_times)} ms, median {full_ms:.1f} ms/step")
    profile_step(lambda: bare_steps(trainer, batch, 1), label="XL stage-1 trainer step, "
                 f"fused adaLN, remat '{policy}'")
    return dict(launches=want, adaln_step=adaln_step, trainer_ips=trainer_ips,
                remat_rel=remat_rel, bare_ips=bare_ips, ratio=trainer_ips / bare_ips,
                waits=waits, fit_peak=fit_peak, dots_peak=dots_peak, full_peak=full_peak,
                dots_ms=bare_ms, full_ms=full_ms)


def run_resume(tmp):
    """MicroDiT-Tiny through the entry point: 4 steps straight, against 2 steps, a
    checkpoint and an autoresume to 4."""
    import torch
    from micro_diffusion_tpu_torch.train import cli

    train_dir, eval_dir = os.path.join(tmp, "train"), os.path.join(tmp, "eval")
    if not os.path.exists(os.path.join(train_dir, "index.json")):
        write_latents(train_dir, TRAINER_SAMPLES, SEED)
        write_latents(eval_dir, EVAL_SAMPLES, SEED + 1)

    def fit(name, steps, *extra):
        argv = ["--config-path", OVERLAY, "--config-name", "res_256_pretrain",
                "model.dit_arch=MicroDiT_Tiny_2", f"dataset.train.datadir={train_dir}",
                f"dataset.eval.datadir={eval_dir}",
                f"dataset.train_batch_size={RESUME_BATCH}",
                f"trainer.device_train_microbatch_size={RESUME_MB}",
                f"trainer.max_duration={steps}ba", "trainer.eval_interval=0",
                "trainer.save_interval=0", f"trainer.save_folder={os.path.join(tmp, name)}",
                f"callbacks.image_monitor.prompts_file={PROMPTS_FILE}",
                "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
                f"logger.progress.path={os.path.join(tmp, name + '.jsonl')}", *extra]
        return cli.main(argv)

    t0 = time.perf_counter()
    straight = fit("straight", 4)
    ref = {k: p.detach().clone() for k, p in straight.state.params.items()}
    del straight
    first = fit("resumed", 2)
    first_step = first.state.step
    del first
    resumed = fit("resumed", 4, "trainer.autoresume=true")
    got = resumed.state.params
    equal = sum(bool(torch.equal(got[k], ref[k])) for k in ref)
    diff2 = sum((got[k].double() - ref[k].double()).square().sum() for k in ref)
    ref2 = sum(ref[k].double().square().sum() for k in ref)
    rel = (diff2.sqrt() / ref2.sqrt()).item()
    max_abs = max((got[k] - ref[k]).abs().max().item() for k in ref)
    log(f"[resume] Tiny, batch {RESUME_BATCH} (K = {RESUME_BATCH // RESUME_MB}), fused adaLN, "
        f"remat '{resumed.model.dit.remat_policy}': 2 steps + autoresume to "
        f"{resumed.state.step} vs 4 straight: {equal} of {len(ref)} tensors bitwise equal, "
        f"relative L2 {rel:.3e} (tol {RESUME_TOL}), max abs diff {max_abs:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (first_step == 2 and resumed.state.step == 4 and rel <= RESUME_TOL):
        raise AssertionError(f"resume: steps {first_step} -> {resumed.state.step}, rel L2 {rel}")
    return dict(equal=equal, tensors=len(ref), rel=rel, max_abs=max_abs)


# ------------------------------------------------------------------- main


def summarize(name, source, replaces, per_shape, path_counts, launches, key, flops_bytes,
              per, peak_flops=PEAK_BF16_FLOPS):
    """One kernel entry: times and bounds summed over the calls of one forward or
    step (``per``). ``key(row)`` is a row's shape tuple, the arguments of
    ``flops_bytes``."""
    rows = {key(r): r for r in per_shape}
    tot = collections.defaultdict(float)
    lib_known = True
    for shape, count in path_counts.items():
        r = rows[shape]
        for f in ("ms", "plain_ms", "bound_ms"):
            tot[f] += count * r[f]
        if r["library_ms"] is None:
            lib_known = False
        else:
            tot["library_ms"] += count * r["library_ms"]
    flops = sum(c * flops_bytes(*s)[0] for s, c in path_counts.items())
    nbytes = sum(c * flops_bytes(*s)[1] for s, c in path_counts.items())
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if flops / peak_flops >= nbytes / PEAK_BYTES else "bytes",
        "library_ms": tot["library_ms"] if lib_known else None,
        "per": per,
        "shapes": per_shape,
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from micro_diffusion_tpu_torch.ops import _build
    except ImportError as err:
        print(f"chip_smoke: the port's package is not beside this script: {err}",
              file=sys.stderr)
        return 1

    # ---- 1. device
    smi = smi_line()
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    # ---- 2. kernels
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    attn_rows, moe_rows, attn_bwd_rows, moe_bwd_rows, adaln_rows = [], [], [], [], []
    for shape in ATTN_SHAPES:
        r = check_attention(shape, gen)
        attn_rows.append(r)
        log(f"[kernels] attention {json.dumps(r)}")
    for shape in MOE_SHAPES:
        r = check_moe(shape, gen)
        moe_rows.append(r)
        log(f"[kernels] moe_ffn {json.dumps(r)}")
    for shape in ATTN_BWD_SHAPES:
        r = check_attention_bwd(shape, gen)
        attn_bwd_rows.append(r)
        log(f"[kernels] attention_bwd {json.dumps(r)}")
    for shape in MOE_BWD_SHAPES:
        r = check_moe_bwd(shape, gen)
        moe_bwd_rows.append(r)
        log(f"[kernels] moe_ffn_bwd {json.dumps(r)}")
    for shape in ADALN_SHAPES:
        r = check_adaln(shape, gen)
        adaln_rows.append(r)
        log(f"[kernels] layernorm_modulate {json.dumps(r)}")
    log(f"[phase] kernels {time.perf_counter() - t_phase:.1f} s")

    # ---- 3. slice
    t_phase = time.perf_counter()
    res = run_slice(STEPS, PROMPTS)
    log(f"[phase] slice {time.perf_counter() - t_phase:.1f} s")

    # ---- 4. train
    t_phase = time.perf_counter()
    tr = run_train()
    log(f"[phase] train {time.perf_counter() - t_phase:.1f} s")

    # ---- 5. trainer, 6. resume (one seeded dataset, removed at the end)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t_phase = time.perf_counter()
        tn = run_trainer(tmp)
        log(f"[phase] trainer {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        rs = run_resume(tmp)
        log(f"[phase] resume {time.perf_counter() - t_phase:.1f} s")

    # time the paths' shapes not already in the lists above
    t_phase = time.perf_counter()
    have = {(r["B"], r["Tq"], r["Tk"], r["H"]) for r in attn_rows}
    for (b, tq, tk, h) in sorted(res["attn_shapes"]):
        if (b, tq, tk, h) not in have:
            attn_rows.append(check_attention((tq, tk, h), gen, b))
    have = {(r["n"], r["e"], r["k"], r["d"], r["f"]) for r in moe_rows}
    for (n, e, k, d, f) in sorted(res["moe_shapes"]):
        if (n, e, k, d, f) not in have:
            moe_rows.append(check_moe((k, d, f), gen, n, e))
    have = {(r["B"], r["Tq"], r["Tk"], r["H"]) for r in attn_bwd_rows}
    for shape in sorted(tr["attn_shapes"]):
        if shape not in have:
            attn_bwd_rows.append(check_attention_bwd(shape, gen))
            log(f"[kernels] attention_bwd {json.dumps(attn_bwd_rows[-1])}")
    have = {(r["n"], r["e"], r["k"], r["d"], r["f"]) for r in moe_bwd_rows}
    for shape in sorted(tr["moe_shapes"]):
        if shape not in have:
            moe_bwd_rows.append(check_moe_bwd(shape, gen))
            log(f"[kernels] moe_ffn_bwd {json.dumps(moe_bwd_rows[-1])}")
    have = {(r["B"], r["T"], r["D"]) for r in adaln_rows}
    for shape in sorted(tn["adaln_step"]):
        if shape not in have:
            adaln_rows.append(check_adaln(shape, gen))
            log(f"[kernels] layernorm_modulate {json.dumps(adaln_rows[-1])}")
    log(f"[phase] path shapes {time.perf_counter() - t_phase:.1f} s")

    attn_key = lambda r: (r["B"], r["Tq"], r["Tk"], r["H"])
    moe_key = lambda r: (r["n"], r["e"], r["k"], r["d"], r["f"])
    fwd_per = "one XL 256px CFG forward (B=8), summed over its calls"
    step_per = f"one XL stage-1 train step (mb {TRAIN_MB}, K=1), summed over its calls"
    kernels = [
        summarize("flash_attention_lane",
                  "micro_diffusion_tpu_torch/csrc/flash_attention_lane.cu",
                  ATTN_REPLACES, attn_rows, res["attn_shapes"],
                  res["launches"]["attention"], attn_key, attn_flops_bytes, fwd_per),
        summarize("moe_ffn", "micro_diffusion_tpu_torch/csrc/moe_ffn.cu", MOE_REPLACES,
                  moe_rows, res["moe_shapes"], res["launches"]["moe"], moe_key,
                  moe_flops_bytes, fwd_per),
        summarize("flash_attention_lane_bwd",
                  "micro_diffusion_tpu_torch/csrc/flash_attention_lane_bwd.cu",
                  ATTN_BWD_REPLACES, attn_bwd_rows, tr["attn_shapes"],
                  tr["launches"]["attention_bwd"], attn_key, attn_bwd_flops_bytes,
                  step_per),
        summarize("moe_ffn_bwd", "micro_diffusion_tpu_torch/csrc/moe_ffn_bwd.cu",
                  MOE_BWD_REPLACES, moe_bwd_rows, tr["moe_shapes"],
                  tr["launches"]["moe_bwd"], moe_key, moe_bwd_flops_bytes, step_per),
        summarize("layernorm_modulate", "micro_diffusion_tpu_torch/csrc/adaln.cu",
                  ADALN_REPLACES, adaln_rows, tn["adaln_step"], tn["launches"]["adaln"],
                  lambda r: (r["B"], r["T"], r["D"]), adaln_flops_bytes,
                  f"one XL stage-1 trainer step (mb {TRAIN_MB}, K=1, remat 'dots'), "
                  "summed over its calls", peak_flops=PEAK_FP32_FLOPS),
    ]
    # the forward kernels also run in the train step: their launches there
    kernels[0]["launches_train_step"] = tr["launches"]["attention"]
    kernels[1]["launches_train_step"] = tr["launches"]["moe"]
    log(f"[slice] sampler {res['sampler_ms']:.1f} ms for {PROMPTS} images, "
        f"{res['img_per_s']:.4f} img/s at 256px; latents std {res['latents_std']:.4f}")
    log(f"[train] stage 1 mb {TRAIN_MB}: {tr['ms_per_step']:.1f} ms/step, "
        f"{tr['img_per_s']:.2f} img/s, peak {tr['peak_bytes'] / 2**30:.2f} GiB, "
        f"remat {REMAT}")
    log(f"[trainer] stage 1 through the entry point: {tn['trainer_ips']:.2f} img/s, bare "
        f"step {tn['bare_ips']:.2f} img/s, ratio {tn['ratio']:.3f}; peaks dots "
        f"{tn['dots_peak'] / 2**30:.2f} GiB, full {tn['full_peak'] / 2**30:.2f} GiB, "
        f"gradient rel L2 dots vs full {tn['remat_rel']:.1e}; "
        f"resume: {rs['equal']}/{rs['tensors']} bitwise, rel L2 {rs['rel']:.3e}")
    log(f"[phase] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
