#!/usr/bin/env python3
"""Time the port's attention kernels at the main path's shapes, for one or more
checkouts of the repository, in turns, on one card.

    python3 chip_attention.py [ROOT ...]     # default: this checkout

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
  same digest: bitwise equal gradients).
Prints one JSON line per root run (`[ab] {...}`), then a table of kernel ms per
shape, one column per run. Exits non-zero without a card or on a failed check.
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


def worker(root):
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from micro_diffusion_tpu_torch.ops import _build
    from micro_diffusion_tpu_torch.ops import flash_attention as fa
    from micro_diffusion_tpu_torch.ops import flash_attention_bh as bh
    from micro_diffusion_tpu_torch.ops import flash_attention_lane as fal

    t0 = time.perf_counter()
    _build.build_all()
    res = {"root": root, "build_s": time.perf_counter() - t0, "fwd": [], "bwd": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
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
    res["sampler"] = sampler_forward(torch)
    print("[ab] " + json.dumps(res), flush=True)


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
        print("chip_attention: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    roots = argv or [os.path.dirname(os.path.abspath(__file__))]
    runs = []
    for i, root in enumerate(roots):
        tag = f"run{i}"
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               os.path.abspath(root)], capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("[ab] ")]
        if proc.returncode != 0 or not line:
            print(f"chip_attention: {root} failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        print(line[0], flush=True)
        runs.append((tag, dict(json.loads(line[0][5:]), root=root)))
    for part in ("fwd", "bwd"):
        print(f"{part} ms per call: " + " | ".join(f"{t} {r['root']}" for t, r in runs))
        for j, row in enumerate(runs[0][1][part]):
            cells = " ".join(f"{r[part][j]['ms']:8.4f}" for _, r in runs)
            print(f"  {row['kind']:4s} {str(row['shape']):24s} {cells}   sdpa "
                  f"{row['sdpa_ms']:8.4f}")
    for t, r in runs:
        print(f"sampler {t}: {json.dumps(r['sampler'])}")
    for t, r in runs[1:]:
        same = r["k1b_k4b_digest"] == runs[0][1]["k1b_k4b_digest"]
        print(f"K1b/K4b gradients {runs[0][0]} vs {t}: bitwise equal {same}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
