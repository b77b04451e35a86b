#!/usr/bin/env python3
"""The [dist] phase of chip_smoke.py alone, on one NVIDIA H100 (a few minutes).

    python3 chip_dist.py      # from the repository root, on a machine with a card

Builds the kernels, runs chip_smoke.py's [trainer] phase (the XL stage-1 recipe
through train.cli.main without a process group, on a seeded synthetic MDS set: the
reference losses, grad norms and launch counts), then its ``run_dist``: the same
recipe through ``cli.main --multihost`` in a one-rank NCCL group, 3 steps with a
save at step 2, an autoresume from step 2 bitwise equal to the straight run at step
3, the save and load seconds, the file's bytes and the peak; then 2 gloo ranks
sharing the card (the collective probe and, when gloo takes CUDA tensors, one
cut-XL step at mesh (1, 2, 1) and (1, 1, 2) against one rank). Exits non-zero when
there is no card or a check fails. Imports nothing of JAX.
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_dist: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from micro_diffusion_tpu_torch.ops import _build

    cs.log(f"[device] {cs.smi_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_dist_") as tmp:
        t0 = time.perf_counter()
        tn = cs.run_trainer(tmp)
        cs.log(f"[phase] trainer {time.perf_counter() - t0:.1f} s")
        cs.free_memory()
        t0 = time.perf_counter()
        cs.run_dist(tmp, tn)
        cs.log(f"[phase] dist {time.perf_counter() - t0:.1f} s")
    cs.log(f"[device] {cs.smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
