#!/usr/bin/env python3
"""The prompt -> image phases of chip_smoke.py alone, on one NVIDIA H100 (about a minute).

    python3 chip_serve.py            # from the repository root, on a machine with a card

Builds the kernels, the random-weight DFN5B CLIP-H text tower and SDXL VAE and a BPE
vocabulary (chip_smoke.py's ``build_encoders``); at 256px a MicroDiT-XL
generate(text_embeddings=...) of 4 prompts, then generate(prompt=[4 captions]) with
its launch counts checked (``prompt_generate``); one T5-v1.1-XXL forward
(``run_t5``); at 512px an XL model with the stage-4 overlay's settings ('gather',
fused adaLN, pos_interp_scale 2) through chip_smoke.py's ``run_serve512``. Exits
non-zero when there is no card. Imports nothing of JAX.
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_serve: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion
    from micro_diffusion_tpu_torch.ops import _build

    cs.log(f"[device] {cs.smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_serve_") as tok_dir:
        enc = cs.build_encoders(tok_dir)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
        model = create_latent_diffusion(dit_arch="MicroDiT_XL_2", latent_res=32, device="cuda",
                                        seed=cs.SEED)
        cs.perturb_zero_init(model.dit, gen)
        y = torch.randn(cs.PROMPTS, 77, 1024, generator=gen, device="cuda")
        for label in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate(text_embeddings=y, num_inference_steps=cs.STEPS, seed=cs.SEED,
                           return_only_latents=True)
            torch.cuda.synchronize()
            cs.log(f"[serve 256px] latents only ({label}): "
                   f"{(time.perf_counter() - t0) * 1e3 / cs.PROMPTS:.1f} ms per image")
        forwards = 2 * cs.STEPS - 1
        cs.prompt_generate(model, enc, cs.SERVE_CAPTIONS[:cs.PROMPTS], cs.STEPS,
                           cs.launch_dict(attention=69 * forwards, moe=16 * forwards),
                           "[serve 256px]")
        del model
        cs.free_memory()
        cs.run_t5()
        model = create_latent_diffusion(dit_arch="MicroDiT_XL_2", latent_res=64,
                                        pos_interp_scale=2.0, moe_dispatch="gather",
                                        fused_adaln=True, device="cuda", seed=cs.SEED)
        cs.perturb_zero_init(model.dit, gen)
        x = torch.randn(cs.SAMPLE512_PROMPTS, 4, 64, 64, generator=gen, device="cuda")
        with torch.no_grad(), cs.record_path(model.dit) as rec:
            model.model_forward_wrapper(x, torch.full((1,), 2.5, device="cuda"),
                                        y[:cs.SAMPLE512_PROMPTS], cfg=5.0)
        cs.run_serve512(model, enc, rec.forward_launches(forwards))
    cs.log(f"[device] {cs.smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
