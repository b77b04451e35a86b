"""Latent precompute on the card: image MDS shards -> fp16 caption and VAE latent MDS
shards. The port of micro_diffusion_tpu/datasets/prepare/precompute.py (``precompute``
:43, ``_encode_and_write`` :115, the CLI :148), itself the counterpart of the
reference's accelerate-launched multi-GPU precompute jobs
(prepare/*/precompute.py:102-248): a disjoint contiguous dataset slice per process,
text-encode the tokenized captions, VAE-encode each image at 256 AND 512 (the sampled
latents, scaled by the VAE's scaling factor), write fp16 bytes per sample into a
per-process MDS subdirectory, then merge the indexes on process 0.

Output columns: {caption, caption_latents, latents_256, latents_512} (+ jpg with
``save_images``), the reference writer's schema (jdb/precompute.py:159-166), which
datasets/latents_loader.py reads.

Where the JAX package uses JAX:
  * the rank and the process count are the arguments; when they are None, the
    ``torch.distributed`` group's when one is initialised, else 0 of 1; with more
    than one process the ranks meet at a ``torch.distributed.barrier()`` before
    process 0 merges the indexes;
  * the VAE noise of batch ``bi`` at ``size`` is drawn from a ``torch.Generator`` on
    the VAE's device seeded from (seed + rank, bi, size) (``noise_seed``);
    ``noise_fn(bi, size, shape)`` overrides the draw (the JAX package draws
    ``normal(fold_in(PRNGKey(seed + rank), bi * 10 + size))`` on the NHWC latents);
  * a batch that raises is skipped as in the reference (precompute.py:232-233), and
    counted: ``precompute`` returns (written, skipped), and the CLI exits non-zero
    when any batch was skipped, so a failed batch never passes for a shorter dataset.

CLI (``--device cpu`` runs it without a card):
    python -m micro_diffusion_tpu_torch.datasets.prepare.precompute \\
        --datadir <image-mds-dir> --savedir <latents-dir> \\
        --vae stabilityai/stable-diffusion-xl-base-1.0 --vae_weights_dir ... \\
        --text_encoder openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378 \\
        --text_encoder_weights_dir ... --tokenizer_dir ... --batch_size 32
"""

import argparse
import os
import sys
import traceback
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ...models.dit import resolve_device
from ...models.text_encoders import UniversalTextEncoder, UniversalTokenizer
from ...models.vae import AutoencoderKL
from ..captions import CaptionProcessor
from ..mds import MDSWriter, merge_index
from .common import PrecomputeImageDataset
from .specs import DATASETS

# "bfloat16" writes float16 as in the JAX package: the loader reads float16 bytes
SAVE_DTYPES = {"float16": np.float16, "float32": np.float32, "bfloat16": np.float16}
SHARD_LIMIT = 256 * (1 << 20)


class PrecomputeCounts(NamedTuple):
    written: int  # samples written by this process
    skipped: int  # batches that raised and were skipped


def batched(it: Iterator[Dict], batch_size: int) -> Iterator[List[Dict]]:
    buf: List[Dict] = []
    for item in it:
        buf.append(item)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def noise_seed(rank_seed: int, bi: int, size: int) -> int:
    """The 64-bit generator seed of batch ``bi``'s VAE noise at ``size``, from
    (seed + rank, bi, size)."""
    return int(np.random.SeedSequence([rank_seed, bi, size]).generate_state(1, np.uint64)[0])


def precompute(
    datadir: List[str],
    savedir: str,
    vae,
    text_encoder,
    tokenizer,
    batch_size: int = 32,
    resize_sizes=(256, 512),
    caption_key: str = "caption",
    clean_captions: bool = False,
    save_images: bool = False,
    save_dtype: str = "float16",
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    seed: int = 0,
    noise_fn: Optional[Callable] = None,
) -> PrecomputeCounts:
    """Run the precompute loop for this process's slice; returns the samples written
    and the batches skipped."""
    dist = torch.distributed
    group = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if group else 0
    if process_count is None:
        process_count = dist.get_world_size() if group else 1
    ds = PrecomputeImageDataset(
        datadir,
        resize_sizes=resize_sizes,
        caption_key=caption_key,
        caption_processor=CaptionProcessor() if clean_captions else None,
    )
    out_dtype = SAVE_DTYPES[save_dtype]

    # the canonical caption/caption_latents names whatever the source caption key
    # (e.g. sa1b's caption_syn_pixart_llava15): the training loader reads them
    columns = {
        "caption": "str",
        "caption_latents": "bytes",
        **{f"latents_{s}": "bytes" for s in resize_sizes},
    }
    if save_images:
        columns["jpg"] = "jpeg"

    writer = MDSWriter(out=os.path.join(savedir, str(process_index)), columns=columns,
                       size_limit=SHARD_LIMIT)
    n = skipped = 0
    for bi, batch in enumerate(batched(ds.iter_slice(process_index, process_count),
                                       batch_size)):
        try:
            n += _encode_and_write(batch, bi, tokenizer, text_encoder, vae, resize_sizes,
                                   out_dtype, save_images, writer, seed + process_index,
                                   noise_fn)
        except Exception:  # fail-soft per batch, counted
            skipped += 1
            print(f"[precompute] skipping batch {bi} ({len(batch)} samples):\n"
                  f"{traceback.format_exc()}", file=sys.stderr)
    writer.finish()

    # barrier + index merge (reference precompute.py:238-248)
    if process_count > 1 and group:
        dist.barrier()
    if process_index == 0:
        merge_index(savedir)
    return PrecomputeCounts(n, skipped)


def _encode_and_write(batch, bi, tokenizer, text_encoder, vae, resize_sizes, out_dtype,
                      save_images, writer, rank_seed, noise_fn) -> int:
    captions = [b["caption"] for b in batch]
    tok = tokenizer.tokenize(captions)
    cond, _ = text_encoder.encode(tok["input_ids"], attention_mask=tok.get("attention_mask"))

    down = 2 ** (len(vae.block_out_channels) - 1)
    latents = {}
    for size in resize_sizes:
        imgs = torch.from_numpy(np.stack([b[f"image_{size}"] for b in batch]))  # [-1, 1]
        if noise_fn is None:
            gen = torch.Generator(device=vae.device).manual_seed(
                noise_seed(rank_seed, bi, size))
            z = vae.encode(imgs, generator=gen)
        else:
            shape = (len(batch), vae.latent_channels, size // down, size // down)
            z = vae.encode(imgs, noise=torch.as_tensor(noise_fn(bi, size, shape)))
        latents[size] = z.float() * vae.scaling_factor
    return _write_batch(batch, captions, cond, latents, out_dtype, save_images, writer)


def _write_batch(batch, captions, cond, latents, out_dtype, save_images, writer) -> int:
    """The batch's encodings to the host in ``out_dtype``, one MDS sample each."""
    cond = cond.float().cpu().numpy().astype(out_dtype)
    latents = {s: z.cpu().numpy().astype(out_dtype) for s, z in latents.items()}
    for i, b in enumerate(batch):
        sample = {
            "caption": captions[i],
            "caption_latents": cond[i].reshape(-1).tobytes(),
            **{f"latents_{s}": z[i].tobytes() for s, z in latents.items()},
        }
        if save_images:
            sample["jpg"] = b["sample"]["jpg"]
        writer.write(sample)
    return len(batch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default=None, choices=sorted(DATASETS) + [None])
    p.add_argument("--datadir", nargs="+", required=True)
    p.add_argument("--savedir", required=True)
    p.add_argument("--vae", default="stabilityai/stable-diffusion-xl-base-1.0")
    p.add_argument("--vae_weights_dir", required=True)
    p.add_argument(
        "--text_encoder", default="openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378"
    )
    p.add_argument("--text_encoder_weights_dir", required=True)
    p.add_argument("--tokenizer_dir", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--model_dtype", default="bfloat16")
    p.add_argument("--save_dtype", default="float16")
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--image_resolutions", type=int, nargs="+", default=[256, 512])
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a "
                   "card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    # the VAE in fp32 compute, the JAX CLI's default (its vae.py:253); the text
    # encoder in --model_dtype
    vae = AutoencoderKL.from_pretrained(args.vae, weights_dir=args.vae_weights_dir,
                                        device=device)
    text_encoder = UniversalTextEncoder(args.text_encoder, dtype=args.model_dtype,
                                        weights_dir=args.text_encoder_weights_dir,
                                        device=device)
    tokenizer = UniversalTokenizer(args.text_encoder, tokenizer_dir=args.tokenizer_dir)

    spec = DATASETS.get(args.dataset) if args.dataset else None
    counts = precompute(
        args.datadir,
        args.savedir,
        vae,
        text_encoder,
        tokenizer,
        batch_size=args.batch_size,
        resize_sizes=tuple(args.image_resolutions),
        caption_key=spec.caption_key if spec else "caption",
        clean_captions=spec.clean_captions if spec else False,
        save_images=args.save_images,
        save_dtype=args.save_dtype,
    )
    print(f"precomputed {counts.written} samples -> {args.savedir}")
    if counts.skipped:
        raise SystemExit(f"precompute: {counts.skipped} batch(es) raised and were skipped; "
                         "the output lacks their samples")


if __name__ == "__main__":
    main()
