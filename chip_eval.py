#!/usr/bin/env python3
"""The evaluation phase of chip_smoke.py alone, on one NVIDIA H100 (a few minutes).

    python3 chip_eval.py            # from the repository root, on a machine with a card

Builds the kernels, the random-weight DFN5B CLIP-H text tower and SDXL VAE and a BPE
vocabulary (chip_smoke.py's ``build_encoders``), then runs chip_smoke.py's
``run_eval``: generate_images with an XL model at 512px as the eval CLI builds it,
launch counts checked; K2 at the path's shapes; the Inception pool3 features against
float64 and their rate; the FID CLI; a CLIP ViT-L/14 snapshot card vs CPU; the
GenEval colour judge and scorer; the FID-30K estimate. Exits non-zero when there is
no card. Imports nothing of JAX.
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_eval: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from micro_diffusion_tpu_torch.ops import _build

    cs.log(f"[device] {cs.smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_eval_") as tmp:
        enc = cs.build_encoders(os.path.join(tmp, "bpe"))
        t0 = time.perf_counter()
        cs.run_eval(enc, tmp, torch.Generator(device="cuda").manual_seed(cs.SEED + 20))
        cs.log(f"[phase] eval {time.perf_counter() - t0:.1f} s")
    cs.log(f"[device] {cs.smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
