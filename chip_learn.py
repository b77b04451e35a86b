#!/usr/bin/env python3
"""The port's learning proof on one NVIDIA H100: ``python -m
micro_diffusion_tpu_torch.scripts.overfit_proof`` in bf16 for MicroDiT-Micro, then
for MicroDiT-Tiny, 1000 steps each with the autoresume at the half.

    python3 chip_learn.py

Builds the kernels, then runs each proof in this process and holds it to the JAX
script's rule (the last fifth's mean loss below 0.75 of the first fifth's, the last
third's below the first third's, the EMA's fixed-seed generate() more than 0.15
relative L2 from the init's). It counts the EC-MoE kernels' launches: Tiny's MoE
blocks (d 512) run K2 and K2b, so ``moe_ffn`` must launch once a block in every
fitted step and in every forward of the two generate() calls (12 Heun steps: 23
forwards each), and ``moe_ffn_bwd`` once a block a step; Micro's (d 64) run the
plain path, so neither launches. Prints each record (its loss curve too), the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without a card,
and when a rule or a count fails. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MODELS = ("MicroDiT_Micro_2", "MicroDiT_Tiny_2")
STEPS = 1000
DTYPE = "bfloat16"
JAX_RECORD = "bench_runs/overfit_r5_tpu_bf16.json"  # the JAX run on a TPU v5 lite


def log(msg):
    print(msg, flush=True)


def smi_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"


def moe_blocks(model_name, x):
    """The EC-MoE blocks of ``model_name`` (built on the meta device) and whether K2
    takes each at the proof's training shape ``x`` (n, tokens)."""
    import torch
    from micro_diffusion_tpu_torch.models import dit as model_zoo
    from micro_diffusion_tpu_torch.ops.moe_ffn import supported
    from micro_diffusion_tpu_torch.scripts.overfit_proof import CAPTION_CHANNELS

    dit = getattr(model_zoo, model_name)(caption_channels=CAPTION_CHANNELS,
                                         dtype=torch.bfloat16, device="meta")
    n, t = x
    out = []
    for m in dit.modules():
        if hasattr(m, "set_expert_parallel"):
            e, d, f = m.w1.shape
            out.append(supported(n, e, int(m.expert_capacity * t / e), d, f))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_learn: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from micro_diffusion_tpu_torch.ops import _build, moe_ffn
    from micro_diffusion_tpu_torch.scripts import overfit_proof as proof

    log(f"[device] {smi_line()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(ROOT, JAX_RECORD)) as f:
        jax_rec = json.load(f)
    log(f"[learn] JAX record ({JAX_RECORD}, {jax_rec['device']}): loss "
        f"{jax_rec['loss_first_window']} -> {jax_rec['loss_last_window']} (thirds "
        f"{jax_rec['loss_thirds']}), generate rel-change {jax_rec['generate_rel_change_vs_init']}")

    tokens = (proof.LATENT_RES // 2) ** 2  # patch 2, mask ratio 0
    forwards = 2 * (2 * proof.GEN_STEPS - 1)  # two generate() calls, Heun
    failed = []
    for name in MODELS:
        blocks = moe_blocks(name, (proof.BATCH, tokens))
        if any(blocks) and not all(blocks):
            raise AssertionError(f"{name}: K2 takes only some of its MoE blocks: {blocks}")
        kernel_blocks = len(blocks) if all(blocks) else 0
        moe_ffn.moe_ffn.launches = moe_ffn.moe_ffn_bwd.launches = 0
        rec = proof.run(STEPS, name, DTYPE, "cuda", log=lambda m: log(f"[learn] {m}"))
        got = (moe_ffn.moe_ffn.launches, moe_ffn.moe_ffn_bwd.launches)
        want = (kernel_blocks * (STEPS + forwards), kernel_blocks * STEPS)
        log(f"[learn] {name}: K2 / K2b launches {got[0]} / {got[1]}, expected {want[0]} / "
            f"{want[1]} ({len(blocks)} EC-MoE blocks, {'K2' if kernel_blocks else 'plain'}; "
            f"{STEPS} steps, {forwards} generate() forwards)")
        log(f"[learn] {name} record: {json.dumps(rec)}")
        if not rec["pass"]:
            failed.append(f"{name}: JAX's rule")
        if got != want:
            failed.append(f"{name}: launches {got} != {want}")
    if failed:
        log(f"FAILED: {failed}")
        return 1
    log(f"[device] {smi_line()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
