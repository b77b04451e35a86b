#!/usr/bin/env python3
"""Time the port's attention and EC-MoE kernels at the main path's shapes, for one
or more checkouts of the repository, in turns, on one card.

    python3 chip_kernels.py [--moe-only] [ROOT ...]     # default: this checkout

Each ROOT (a checkout, e.g. the parent commit unpacked with `git archive` into a
git-ignored directory) runs in a process of its own, in the order given, so that
two versions compare on one card as `parent change change parent`. Per root:
- the forward kernels (K1 at head_dim 64, K4 at 32, K5 with its logsumexp) and the
  backward ones (K1b/K4b from the saved row statistics, K5b from the logsumexp) at
  the shapes of the XL 256px sampler (B = 8), XL stage 2 (mb 64), XL stage 4 (mb 16)
  and the Tiny stage-4 step (mb 16): the error against the plain version, two
  backward calls bitwise equal, CUDA-event times (chip_smoke.py's `time_ms`) and
  F.scaled_dot_product_attention's on the same inputs;
- the XL 256px CFG forward (B = 8) of the sampler: median wall time of 5 calls and
  the device's busy time in one more under torch.profiler;
- a digest of the K1b/K4b gradients of fixed seeded inputs, from the plain
  forward's out and statistics; the roots' digests are compared at the end (the
  same digest: bitwise equal gradients);
- the expert FFN kernels, forward and backward: K3/K3b on expert-major rows at the
  XL 512px shapes (stage 4's backbone widths, stage 3's mixer, the sampler) and
  K2/K2b on sample-major rows at the stage-1, stage-2 and 256px-sampler shapes: the
  error against the plain version (each backward twice, bitwise equal), CUDA-event
  times, and the time of the cuBLAS chain bmm -> GELU -> bmm (and its autograd
  backward) on the same inputs, for context;
- one K3 and one K3b call at a stage-4 shape under torch.profiler (device time per
  kernel name), the `ptxas -v` lines of the MoE sources, and the time of one
  8192^3 bf16 torch.mm (the card's rate through cuBLAS, for context).
With --moe-only each root runs the MoE part alone (no attention rows, digest or
sampler). Prints one JSON line per root run (`[ab] {...}`), then a table of kernel
ms per shape, one column per run. Exits non-zero without a card or on a failed
check.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

# (kind, B, Tq, Tk, H, D): lane = K1/K1b, bh = K4/K4b, fa = K5/K5b
FWD_SHAPES = [
    ("lane", 8, 256, 256, 16, 64), ("lane", 8, 256, 77, 16, 64), ("lane", 8, 77, 77, 16, 64),
    ("lane", 64, 256, 256, 16, 64), ("lane", 64, 256, 77, 16, 64),
    ("lane", 16, 1024, 1024, 16, 64), ("lane", 16, 1024, 77, 16, 64),
    ("bh", 16, 1024, 1024, 16, 32), ("bh", 16, 1024, 77, 16, 32),
    ("fa", 64, 256, 256, 16, 64), ("fa", 64, 256, 77, 16, 64), ("fa", 64, 77, 77, 16, 64),
]
BWD_SHAPES = [
    ("lane", 64, 256, 256, 16, 64), ("lane", 64, 256, 77, 16, 64),
    ("lane", 16, 1024, 1024, 16, 64), ("bh", 16, 1024, 1024, 16, 32),
    ("fa", 64, 256, 256, 16, 64), ("fa", 64, 256, 77, 16, 64), ("fa", 64, 77, 77, 16, 64),
]
ATTN_TOL, BWD_TOL, LSE_TOL = 2e-2, 1e-2, 1e-3  # chip_smoke.py's limits
MOE_TOL = 2e-2  # chip_smoke.py's MOE_TOL
# (kind, n, e, k, d, f, backward): em = K3/K3b on (e, k, d) rows (n = 1), moe = K2/K2b
MOE_SHAPES = [
    ("em", 1, 8, 4096, 1024, 768, True), ("em", 1, 8, 4096, 1024, 2304, True),
    ("em", 1, 8, 4096, 1024, 3840, True), ("em", 1, 8, 8192, 768, 3072, True),
    ("em", 1, 8, 1024, 1024, 3840, True),
    ("moe", 256, 8, 16, 1024, 2304, True), ("moe", 64, 8, 64, 1024, 2304, True),
    ("moe", 8, 8, 64, 1024, 2304, False),
]
PROFILE_SHAPE = (8, 4096, 1024, 2304)  # (e, m, d, f): a stage-4 K3/K3b call


def worker(root, moe_only=False):
    sys.path.insert(0, root)
    import torch
    import chip_smoke
    from micro_diffusion_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    res = {"root": root, "build_s": time.perf_counter() - t0, "fwd": [], "bwd": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not moe_only:
        attention_rows(torch, chip_smoke, res, gen)
    a = torch.randn(8192, 8192, generator=gen, device="cuda").bfloat16()
    res["mm_8192_ms"] = chip_smoke.time_ms(lambda: torch.mm(a, a), iters=10)
    del a
    res["moe"] = [moe_row(torch, chip_smoke, *shape) for shape in MOE_SHAPES]
    res["moe_profile"] = moe_profile(torch, chip_smoke)
    res["ptxas"] = [f"[ptxas {name}] {line.strip()}" for name, text in logs.items()
                    if name.startswith("moe") for line in text.splitlines()
                    if "registers" in line or "spill" in line or "entry function" in line]
    if not moe_only:
        res["sampler"] = sampler_forward(torch)
    print("[ab] " + json.dumps(res), flush=True)


def attention_rows(torch, chip_smoke, res, gen):
    """The attention kernels' rows and the K1b/K4b digest, into ``res``."""
    import torch.nn.functional as F
    from micro_diffusion_tpu_torch.ops import flash_attention as fa
    from micro_diffusion_tpu_torch.ops import flash_attention_bh as bh
    from micro_diffusion_tpu_torch.ops import flash_attention_lane as fal

    time_ms = chip_smoke.time_ms
    rel = chip_smoke.rel_err
    for kind, b, tq, tk, h, d in FWD_SHAPES:
        q, k, v = chip_smoke.attn_case(tq, tk, h, gen, b, d)
        scale = d**-0.5
        if kind == "fa":
            run = lambda: fa._forward(q, k, v, scale)
            (out, lse), (ref, ref_lse) = run(), fa.flash_attention_plain(q, k, v)
            lse_err = (lse - ref_lse).abs().max().item()
        else:
            mod = fal if kind == "lane" else bh
            run = lambda: mod._forward(q, k, v, scale)
            out, ref, lse_err = run(), fal.flash_attention_lane_plain(q, k, v), 0.0
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= ATTN_TOL and rel(out, ref) <= ATTN_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"{kind} {(b, tq, tk, h, d)}: err {err}, lse {lse_err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        res["fwd"].append(dict(kind=kind, shape=[b, tq, tk, h, d], max_abs_err=err,
                               lse_err=lse_err, ms=time_ms(run, iters=20),
                               sdpa_ms=time_ms(lambda: F.scaled_dot_product_attention(
                                   qt, kt, vt), iters=20)))
    digest = hashlib.sha256()
    for kind, b, tq, tk, h, d in BWD_SHAPES:
        q, k, v = chip_smoke.attn_case(tq, tk, h, gen, b, d)
        do = torch.randn(b, tq, h, d, generator=gen, device="cuda").bfloat16()
        if kind == "fa":
            out, rowv = fa.flash_attention_plain(q, k, v)
            bwd, plain = fa.flash_attention_bwd, fa.flash_attention_bwd_plain
        else:
            out, rowv = fal.flash_attention_lane_stats_plain(q, k, v)
            bwd = fal.flash_attention_lane_bwd if kind == "lane" else bh.flash_attention_bh_bwd
            plain = fal.flash_attention_lane_bwd_saved_plain
        got, again = bwd(q, k, v, out, rowv, do), bwd(q, k, v, out, rowv, do)
        errs = [rel(g, r) for g, r in zip(got, plain(q, k, v, out, rowv, do))]
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        if not (same and max(errs) <= BWD_TOL):
            raise AssertionError(f"{kind} bwd {(b, tq, tk, h, d)}: {errs}, bitwise {same}")
        if kind != "fa":
            for g in got:
                digest.update(g.view(torch.int16).cpu().numpy().tobytes())
        qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg)
        dot = do.transpose(1, 2)
        res["bwd"].append(dict(
            kind=kind, shape=[b, tq, tk, h, d], max_rel_err=max(errs),
            ms=time_ms(lambda: bwd(q, k, v, out, rowv, do), iters=10),
            sdpa_ms=time_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), dot,
                                                        retain_graph=True), iters=10)))
        del got, again
    res["k1b_k4b_digest"] = digest.hexdigest()


def moe_inputs(torch, chip_smoke, kind, n, e, k, d, f, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xg, w1, w2 = chip_smoke.moe_case(k, d, f, gen, n, e)
    do = torch.randn(n, e, k, d, generator=gen, device="cuda").bfloat16()
    return (xg[0], w1, w2, do[0]) if kind == "em" else (xg, w1, w2, do)


def moe_row(torch, chip_smoke, kind, n, e, k, d, f, backward):
    """One K2/K3 shape: the forward (and the backward, twice) against the plain
    versions; kernel times and the library chain's (bmm -> GELU -> bmm, and its
    autograd backward) on the same inputs."""
    from micro_diffusion_tpu_torch.ops import moe_ffn as mf

    time_ms = chip_smoke.time_ms
    xg, w1, w2, do = moe_inputs(torch, chip_smoke, kind, n, e, k, d, f, seed=n * k + f)
    if kind == "em":
        fwd, bwd, chain = mf.moe_ffn_expert_major, mf.moe_ffn_expert_major_bwd, mf._moe_ffn_em_ref
        fwd_plain, bwd_plain = mf.moe_ffn_expert_major_plain, mf.moe_ffn_expert_major_bwd_plain
    else:
        fwd, bwd, chain = mf.moe_ffn, mf.moe_ffn_bwd, mf._moe_ffn_ref
        fwd_plain, bwd_plain = mf.moe_ffn_plain, mf.moe_ffn_bwd_plain
    out = fwd(xg, w1, w2)
    err = (out.float() - fwd_plain(xg, w1, w2).float()).abs().max().item()
    if not err <= MOE_TOL:
        raise AssertionError(f"{kind} {(n, e, k, d, f)}: forward err {err}")
    row = dict(kind=kind, shape=[n, e, k, d, f], max_abs_err=err,
               ms=time_ms(lambda: fwd(xg, w1, w2), iters=10),
               chain_ms=time_ms(lambda: chain(xg, w1, w2), iters=10))
    if backward:
        got, again = bwd(xg, w1, w2, do), bwd(xg, w1, w2, do)
        errs = [chip_smoke.rel_err(g, r) for g, r in zip(got, bwd_plain(xg, w1, w2, do))]
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        if not (same and max(errs) <= BWD_TOL):
            raise AssertionError(f"{kind} bwd {(n, e, k, d, f)}: {errs}, bitwise {same}")
        del got, again
        leaves = [t.detach().requires_grad_() for t in (xg, w1, w2)]
        ref_out = chain(*leaves)
        row.update(bwd_max_rel_err=max(errs), bwd_bitwise_repeatable=same,
                   bwd_ms=time_ms(lambda: bwd(xg, w1, w2, do), iters=5),
                   bwd_chain_ms=time_ms(lambda: torch.autograd.grad(
                       ref_out, leaves, do, retain_graph=True), iters=5))
    return row


def moe_profile(torch, chip_smoke):
    """Device time per kernel name of one K3 and one K3b call at PROFILE_SHAPE."""
    from torch.profiler import ProfilerActivity, profile
    from micro_diffusion_tpu_torch.ops import moe_ffn as mf

    e, m, d, f = PROFILE_SHAPE
    xg, w1, w2, do = moe_inputs(torch, chip_smoke, "em", 1, e, m, d, f, seed=1)
    res = {}
    for name, run in (("K3", lambda: mf.moe_ffn_expert_major(xg, w1, w2)),
                      ("K3b", lambda: mf.moe_ffn_expert_major_bwd(xg, w1, w2, do))):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        res[name] = {ev.key: dict(calls=ev.count, ms=ev.self_device_time_total / 1e3)
                     for ev in prof.key_averages()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and ev.self_device_time_total > 0}
    return res


def sampler_forward(torch):
    """Wall (median of 5) and device-busy ms of one XL 256px CFG forward, B = 8."""
    from torch.profiler import ProfilerActivity, profile
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion

    model = create_latent_diffusion(dit_arch="MicroDiT_XL_2", latent_res=32, device="cuda",
                                    seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    y = torch.randn(4, 77, 1024, generator=gen, device="cuda")
    x = torch.randn(4, 4, 32, 32, generator=gen, device="cuda")
    sigma = torch.full((1,), 2.5, device="cuda")

    def fwd():
        with torch.no_grad():
            model.model_forward_wrapper(x, sigma, y, cfg=5.0)
        torch.cuda.synchronize()

    walls = []
    for i in range(7):
        t0 = time.perf_counter()
        fwd()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = sorted(walls[2:])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dict(wall_ms=walls[len(walls) // 2], profiled_wall_ms=wall, busy_ms=busy,
                idle_share=1 - busy / wall if busy > 0 else None)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_kernels: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    moe_only = "--moe-only" in argv
    roots = [a for a in argv if a != "--moe-only"] or [os.path.dirname(os.path.abspath(__file__))]
    runs = []
    for i, root in enumerate(roots):
        tag = f"run{i}"
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               os.path.abspath(root)] + ["--moe-only"] * moe_only,
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("[ab] ")]
        if proc.returncode != 0 or not line:
            print(f"chip_kernels: {root} failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        print(line[0], flush=True)
        runs.append((tag, dict(json.loads(line[0][5:]), root=root)))
    for part in ("fwd", "bwd") * (not moe_only):
        print(f"{part} ms per call: " + " | ".join(f"{t} {r['root']}" for t, r in runs))
        for j, row in enumerate(runs[0][1][part]):
            cells = " ".join(f"{r[part][j]['ms']:8.4f}" for _, r in runs)
            print(f"  {row['kind']:4s} {str(row['shape']):24s} {cells}   sdpa "
                  f"{row['sdpa_ms']:8.4f}")
    print("MoE ms per call (forward | backward): " + " | ".join(t for t, _ in runs))
    for j, row in enumerate(runs[0][1]["moe"]):
        fwd = " ".join(f"{r['moe'][j]['ms']:8.4f}" for _, r in runs)
        bwd = " ".join(f"{r['moe'][j].get('bwd_ms', float('nan')):8.4f}" for _, r in runs)
        print(f"  {row['kind']:3s} {str(row['shape']):28s} {fwd} | {bwd}   chain "
              f"{row['chain_ms']:8.4f} | {row.get('bwd_chain_ms', float('nan')):8.4f}")
    for t, r in runs:
        mm = r.get("mm_8192_ms")
        print(f"torch.mm 8192^3 bf16 {t}: {mm:.4f} ms, {2 * 8192**3 / mm / 1e9:.1f} TFLOP/s")
        print(f"moe profile {t}: {json.dumps(r['moe_profile'])}")
        for line in r["ptxas"]:
            print(f"  {t} {line}")
    if moe_only:
        return 0
    for t, r in runs:
        print(f"sampler {t}: {json.dumps(r['sampler'])}")
    for t, r in runs[1:]:
        same = r["k1b_k4b_digest"] == runs[0][1]["k1b_k4b_digest"]
        print(f"K1b/K4b gradients {runs[0][0]} vs {t}: bitwise equal {same}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], moe_only="--moe-only" in sys.argv[3:])
    else:
        sys.exit(main(sys.argv[1:]))
