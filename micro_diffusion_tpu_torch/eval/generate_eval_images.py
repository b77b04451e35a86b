"""Batched image generation for FID-30K / GenEval evaluation, the port's counterpart
of micro_diffusion_tpu/eval/generate_eval_images.py.

Drives ``LatentDiffusion.generate(prompt=...)`` over a caption list (e.g. 30k
COCO-2014 val captions) in fixed-size batches on ``--device`` (the card unless the
caller asks for the CPU), writing ``%06d.png`` files and a ``manifest.json`` of
{file, caption}. Batch ``lo`` is sampled with seed ``seed + lo``; the images become
uint8 as the JAX package makes them, ``(x * 255).astype(uint8)``, which truncates.
Pair the output with eval/fid.py for the FID score.

CLI:
    python -m micro_diffusion_tpu_torch.eval.generate_eval_images \
        --captions captions.json --outdir gen/ --checkpoint ckpt.pt \
        --dit_arch MicroDiT_XL_2 --latent_res 64 --steps 30 --cfg 5.0 \
        --vae_weights_dir ... --text_encoder_weights_dir ... --tokenizer_dir ... \
        [--device cuda|cpu]
"""

import argparse
import json
import os

import numpy as np


def generate_images(model, captions, outdir: str, batch_size: int = 16, steps: int = 30,
                    cfg: float = 5.0, seed: int = 2024) -> int:
    """Generate one image per caption with ``model`` (its encoders attached) into
    ``outdir``; returns the number of images written."""
    from PIL import Image

    os.makedirs(outdir, exist_ok=True)
    manifest = []
    for lo in range(0, len(captions), batch_size):
        batch = captions[lo:lo + batch_size]
        images = model.generate(prompt=batch, guidance_scale=cfg, num_inference_steps=steps,
                                seed=seed + lo)
        arr = (images.cpu().numpy().transpose(0, 2, 3, 1) * 255).astype(np.uint8)
        for i, caption in enumerate(batch):
            name = f"{lo + i:06d}.png"
            Image.fromarray(arr[i]).save(os.path.join(outdir, name))
            manifest.append({"file": name, "caption": caption})
    with open(os.path.join(outdir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return len(manifest)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--captions", required=True, help="json list of caption strings")
    p.add_argument("--outdir", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="reference .pt, or a checkpoint of the port's trainer")
    p.add_argument("--dit_arch", default="MicroDiT_XL_2")
    p.add_argument("--latent_res", type=int, default=64)
    p.add_argument("--in_channels", type=int, default=4)
    p.add_argument("--pos_interp_scale", type=float, default=2.0)
    p.add_argument("--vae", default="stabilityai/stable-diffusion-xl-base-1.0")
    p.add_argument("--vae_weights_dir", required=True)
    p.add_argument("--text_encoder", default="openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378")
    p.add_argument("--text_encoder_weights_dir", required=True)
    p.add_argument("--tokenizer_dir", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--cfg", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--limit", type=int, default=None, help="cap caption count (30k)")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a "
                   "card) or cpu")
    args = p.parse_args(argv)

    from ..models.diffusion import create_latent_diffusion
    from ..models.interop import load_any_checkpoint

    model = create_latent_diffusion(
        vae_name=args.vae, text_encoder_name=args.text_encoder, dit_arch=args.dit_arch,
        latent_res=args.latent_res, in_channels=args.in_channels,
        pos_interp_scale=args.pos_interp_scale, load_encoders=True,
        weights_dir=args.vae_weights_dir,
        text_encoder_weights_dir=args.text_encoder_weights_dir,
        tokenizer_dir=args.tokenizer_dir, device=args.device)
    load_any_checkpoint(args.checkpoint, model.dit)

    with open(args.captions) as f:
        captions = json.load(f)
    if args.limit:
        captions = captions[:args.limit]
    n = generate_images(model, captions, args.outdir, args.batch_size, args.steps, args.cfg,
                        args.seed)
    print(f"generated {n} images -> {args.outdir}")


if __name__ == "__main__":
    main()
