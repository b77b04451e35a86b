#!/usr/bin/env python3
"""The latent precompute phase of chip_smoke.py alone, on one NVIDIA H100 (about a
minute).

    python3 chip_precompute.py      # from the repository root, on a machine with a card

Builds the random-weight DFN5B CLIP-H text tower and SDXL VAE and a BPE vocabulary
(chip_smoke.py's ``build_encoders``), then runs chip_smoke.py's ``run_precompute``:
128 seeded JPEGs in an image MDS -> caption latents and VAE latents at 256 and 512px
through the port's ``precompute``, the output checked and read back through the
latents loader, one encode on the card against the CPU, the stage times, one batch
under ``profile_trace`` and the 37M-image estimate. No DiT kernel runs on this path,
so none is built. Exits non-zero when there is no card. Imports nothing of JAX.
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_precompute: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    cs.log(f"[device] {cs.smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_precompute_") as tmp:
        enc = cs.build_encoders(os.path.join(tmp, "bpe"))
        t0 = time.perf_counter()
        cs.run_precompute(enc, tmp)
        cs.log(f"[phase] precompute {time.perf_counter() - t0:.1f} s")
    cs.log(f"[device] {cs.smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
