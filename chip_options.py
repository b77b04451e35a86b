#!/usr/bin/env python3
"""The [options] and [prepare] phases of chip_smoke.py alone, on one NVIDIA H100
(about four minutes).

    python3 chip_options.py      # from the repository root, on a machine with a card

Builds the kernels, writes chip_smoke.py's seeded 256px and 512px latents sets, and
runs: the XL stage-4 recipe through cli.main for one step, then chip_smoke.py's
``run_options_flow`` on that trainer (bare steps under remat 'full' with
param_flow_dtype unset and bfloat16: time, peak, idle share, launches);
``run_options_hostcompute`` (the stage-4 EMA in the state against the hostcompute
placement, and the placement's host times); ``run_options_accum`` (XL stage 1 at mb
128, K = 2, a bf16 accumulator under 'scan', 'dispatch' and 'dispatch' with the bf16
flow); and ``run_prepare`` with the random-weight CLIP-H tower and SDXL VAE of
``build_encoders`` (raw files of six datasets -> convert -> precompute -> loader ->
one Tiny step). Exits non-zero when there is no card or a check fails. Imports
nothing of JAX.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_options: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from micro_diffusion_tpu_torch.ops import _build
    from micro_diffusion_tpu_torch.train import cli

    cs.log(f"[device] {cs.smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_options_") as tmp:
        t0 = time.perf_counter()
        cs.write_latents(os.path.join(tmp, "train"), cs.TRAINER_SAMPLES, cs.SEED)
        cs.write_latents(os.path.join(tmp, "eval"), cs.EVAL_SAMPLES, cs.SEED + 1)
        cs.write_latents(os.path.join(tmp, "train512"), cs.STAGE_SAMPLES, cs.SEED + 20, res=512)
        cs.write_latents(os.path.join(tmp, "eval512"), cs.STAGE_EVAL_SAMPLES, cs.SEED + 21,
                         res=512)
        cs.log(f"[options] latents sets written in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        trainer = cli.main(cs.stage_argv(
            "res_512_finetune", os.path.join(tmp, "train512"), os.path.join(tmp, "eval512"),
            os.path.join(tmp, "stage4.jsonl"), 1, "trainer.eval_interval=0"))
        out["flow"] = cs.run_options_flow(trainer)
        del trainer
        cs.free_memory()
        cs.log(f"[phase] options flow {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["hostcompute"] = cs.run_options_hostcompute(tmp)
        out["accum"] = cs.run_options_accum(tmp)
        cs.log(f"[phase] options {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        enc = cs.build_encoders(os.path.join(tmp, "bpe"))
        out["prepare"] = cs.run_prepare(enc, tmp)
        cs.log(f"[phase] prepare {time.perf_counter() - t0:.1f} s")
    cs.log(f"[options] {json.dumps(out)}")
    cs.log(f"[device] {cs.smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
