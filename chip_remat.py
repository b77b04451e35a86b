"""Remat policies A/B on one card: bare MicroDiT-XL train steps under each remat
policy, for one or more checkouts of the port in turns.

    python3 chip_remat.py ROOT [ROOT ...]      # e.g. chip_parent . . chip_parent

ROOT is a checkout of this repository (a parent unpacked with `git archive` into the
git-ignored `chip_parent/`, or `.`). Each ROOT runs in a process of its own that
imports that ROOT's `micro_diffusion_tpu_torch` and builds its kernels there. The
shape is the H100 overlay's stage 2 (`configs/h100_1gpu/res_256_finetune`: 256px, mask
0, microbatch 64, K = 2, the 'onehot' MoE dispatch, fused adaLN), random weights from
a seed with the adaLN-zero layers perturbed, one seeded batch. For each policy of
POLICIES that ROOT's DiT accepts: a warm-up and TIMED bare steps (`make_train_step`),
their median wall ms, img/s and peak memory, then one step under torch.profiler for
its device busy ms (the sum of kernel times) and the idle share of that step's wall.
Prints the card's name and power limit, then one JSON line per root. Needs one card.
About 5 minutes a root (the profiler's summary of a ~36k-launch step is much of it):
four roots take about 20 minutes.
"""

import json
import os
import statistics
import subprocess
import sys
import time

from chip_smoke import perturb_zero_init, smi_line, train_batch

POLICIES = ("full", "dots", "attn_moe", "dots_attn_moe", "dots_xlean_alean",
            "dots_attn_moe_xlean_alean")
MB, K, LATENT, SEED = 64, 2, 32, 0
TIMED = 5


def busy_ms(fn):
    """(wall ms, device busy ms) of one call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, busy


def run_root(root):
    """The bare steps of every accepted policy in the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from micro_diffusion_tpu_torch.models import dit as tdit
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion
    from micro_diffusion_tpu_torch.ops import _build
    from micro_diffusion_tpu_torch.train import (build_optimizer, build_schedule,
                                                 create_train_state, make_train_step)

    _build.build_all()
    accepted = []
    for policy in POLICIES:
        try:
            tdit.MicroDiT_Micro_2(input_size=16, caption_channels=32, device="meta",
                                  remat=True, remat_policy=policy)
        except (NotImplementedError, ValueError):
            continue
        accepted.append(policy)
    model = create_latent_diffusion(dit_arch="MicroDiT_XL_2", latent_res=LATENT,
                                    train_mask_ratio=0.0, device="cuda", seed=SEED,
                                    remat=True, fused_adaln=True, moe_dispatch="onehot")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    perturb_zero_init(model.dit, gen)
    sched = build_schedule({"_target_": "composer.optim.ConstantWithWarmupScheduler",
                            "t_warmup": "100ba"}, 8e-5, 30000)
    tx = build_optimizer(dict(model.dit.named_parameters()), sched, clip_norm=0.5)
    state = create_train_state(model.dit, tx)
    step_fn = make_train_step(model, tx, sched, microbatch_size=MB)
    batch = {k: v.half() if v.dtype == torch.float32 and v.dim() > 1 else v
             for k, v in train_batch(gen, MB * K, LATENT).items()}

    def step():
        nonlocal state
        state, m = step_fn(state, batch, torch.Generator(device="cuda").manual_seed(SEED))
        return float(m["loss"])

    rows = {}
    for policy in accepted:
        model.dit.remat_policy = policy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        times = []
        for _ in range(TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        wall, busy = busy_ms(step)
        ms = statistics.median(times)
        rows[policy] = dict(ms=round(ms, 1), img_per_s=round(MB * K / ms * 1e3, 2),
                            peak_gib=round(peak, 2), times=[round(t, 1) for t in times],
                            profiled_wall_ms=round(wall, 1), busy_ms=round(busy, 2),
                            idle_share=round(1 - busy / wall, 3))
    return {"root": root, "shape": f"XL 256px mask 0, mb {MB}, K = {K}, onehot, fused "
            "adaLN", "policies": rows}


def main(roots):
    import torch

    if not torch.cuda.is_available():
        print("chip_remat: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    print(smi_line(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root],
                             cwd=here, capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--root"]:
        print(json.dumps(run_root(sys.argv[2])), flush=True)
        sys.exit(0)
    sys.exit(main(sys.argv[1:] or ["."]))
