"""The port's latent precompute against the JAX package's: the caption cleaner string
for string, resize_center_crop bit for bit, merge_index file for file, and the
precompute end to end (the same image MDS, the tiny CLIP text tower and the tiny VAE
with the same weights on both sides, one tokenizer, ranks 1 then 0 of 2 at batch 4
with a short last batch, JAX's VAE noise injected) sample for sample; the port's
default noise draws, the per-batch skip count, the CLI on the CPU, and the port's
latents loader over the port's output."""

import json
import os
import shutil
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from micro_diffusion_tpu.datasets import captions as jcaptions
from micro_diffusion_tpu.datasets import mds as jmds
from micro_diffusion_tpu.datasets.prepare import common as jcommon
from micro_diffusion_tpu.datasets.prepare import precompute as jprecompute
from micro_diffusion_tpu.datasets.prepare.convert import convert_to_mds
from micro_diffusion_tpu.models import text_encoders as jte
from micro_diffusion_tpu.models import vae as jvae
from micro_diffusion_tpu_torch.datasets import captions as tcaptions
from micro_diffusion_tpu_torch.datasets import mds as tmds
from micro_diffusion_tpu_torch.datasets.latents_loader import (
    build_streaming_latents_dataloader)
from micro_diffusion_tpu_torch.datasets.prepare import common as tcommon
from micro_diffusion_tpu_torch.datasets.prepare import precompute as tprecompute
from micro_diffusion_tpu_torch.models import interop as tinterop
from micro_diffusion_tpu_torch.models import text_encoders as tte
from micro_diffusion_tpu_torch.models import vae as tvae
from micro_diffusion_tpu_torch.utils import clip_bpe

from test_prepare import make_images
from test_vae import _synthetic_diffusers_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKS, SCALE, SIZES = (32, 32, 64, 64), 0.5, (256, 512)
CLIP = dict(vocab_size=1000, width=64, layers=2, heads=4)
N_IMAGES, BATCH = 9, 4  # rank 0 of 2: 5 images (4 + a short 1), rank 1: 4
# The latents are written as float16. fp32 on both sides (the same math summed in
# another order, ~1e-4 of the largest entry), then one fp16 rounding each (2^-11 of a
# value): values that straddle a rounding boundary differ by one fp16 ulp, 2^-10 of
# the value. So: 2e-3 of the largest entry.
LATENT_TOL = 2e-3

# tests/test_prepare.py:40-45's captions, then URLs, @-handles, HTML, CJK, unicode
# dashes, IDs, "free shipping" and IP/date patterns
CAPTIONS = [
    "Check https://example.com/foo NOW",
    "hello   <b>world</b> @someuser",
    "<person> walking",
    "Buy NOW!! free shipping http://x.com/a.jpg",
    "Visit www.shop.co/deals?id=3 or http://a.b.ru/x/y/ and sub.example.org/page",
    "@photo_guy: sunset over the bay #nature @ig_handle2 (repost)",
    "<p>A <i>red</i> car</p> &amp; a &quot;blue&quot; bike &#39;n stuff",
    "富士山 at dawn 日本 and 漢字 ㇰ mixed with ㈱ text",
    "unicode dashes: a–b—c―d‐e ‒ f ー g",
    "IDs like j12345, ab123456, 12ab34 and x9y8z7 in text",
    "Worldwide FREE shipping! free download free, click for details",
    "server at 192.168.0.1 on 12.05.2021, v1.2.3 build",
    "“Smart quotes” and ‘single’ ones «guillemets» ´acute´",
    "page 12 of IMG_2048.jpg images 1920x1080 photo.png image",
    "caf%C3%A9+au+lait   with   spaces\\n and  newlines 3:45  ",
    "a_snake_case-title [bracketed] {braced} | piped * starred ~tilde",
]


def rel_max(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def moved(tree, seed):
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(leaf) + 0.05 * np.random.default_rng(
            zlib.crc32(str(path).encode()) + seed).standard_normal(leaf.shape).astype(
                np.float32), tree)


def read_samples(dirname):
    reader = tmds.MDSReader(dirname)
    return [reader[i] for i in range(len(reader))]


# ------------------------------------------------------------------ helpers vs JAX


@pytest.mark.parametrize("caption", CAPTIONS)
def test_caption_cleaning_matches_jax(caption):
    assert tcaptions.clean_caption(caption) == jcaptions.clean_caption(caption)
    assert tcaptions.CaptionProcessor()(caption) == jcaptions.CaptionProcessor()(caption)
    assert tcaptions.basic_clean(caption) == jcaptions.basic_clean(caption)


@pytest.mark.parametrize("wh", [(600, 560), (300, 700), (513, 513)])
@pytest.mark.parametrize("size", [256, 512])
def test_resize_center_crop_is_bitwise_jax(wh, size):
    arr = np.random.default_rng(wh[0]).integers(0, 256, (wh[1], wh[0], 3), dtype=np.uint8)
    for img in (Image.fromarray(arr), Image.fromarray(arr).convert("L")):
        got = tcommon.resize_center_crop(img, size)
        ref = jcommon.resize_center_crop(img, size)
        assert got.shape == (3, size, size) and got.dtype == np.float32
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("ranks", [2, 11])
def test_merge_index_matches_jax(tmp_path, ranks):
    """Per-rank MDS subdirectories (rank r holds r % 3 + 1 samples) merged by each
    package: the same index.json, byte for byte, in lexicographic rank order."""
    src = tmp_path / "src"
    for r in range(ranks):
        with tmds.MDSWriter(out=str(src / str(r)), columns={"caption": "str", "x": "bytes"},
                            size_limit=64) as w:
            for i in range(r % 3 + 1):
                w.write({"caption": f"rank {r} sample {i}", "x": bytes([r, i]) * 20})
    (src / "not_a_rank").mkdir()  # no index.json: skipped by both
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "port")
    jmds.merge_index(str(tmp_path / "jax"))
    tmds.merge_index(str(tmp_path / "port"))
    got = (tmp_path / "port" / "index.json").read_bytes()
    assert got == (tmp_path / "jax" / "index.json").read_bytes()
    index = json.loads(got)
    assert index["version"] == 2
    subdirs = [s["raw_data"]["basename"].split("/")[0] for s in index["shards"]]
    assert subdirs == sorted(subdirs) and subdirs[0] == "0"
    if ranks == 11:
        assert subdirs.index("10") < subdirs.index("2")
    n = sum(s["samples"] for s in index["shards"])
    assert n == len(read_samples(str(tmp_path / "port"))) == sum(r % 3 + 1 for r in range(ranks))


# ------------------------------------------------------------------ the precompute


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """The image MDS (written by the JAX package's convert_to_mds), the tiny CLIP and
    VAE of each package with the same weights, one tokenizer."""
    root = tmp_path_factory.mktemp("precompute")
    caps = make_images(str(root / "imgs"), n=N_IMAGES, size=(600, 560))
    with open(root / "caps.json", "w") as f:
        json.dump(caps, f)
    assert convert_to_mds("jdb", str(root / "imgs"), str(root / "caps.json"),
                          str(root / "mds")) == N_IMAGES
    clip_dir = root / "clip"
    clip_dir.mkdir()
    (clip_dir / "config.json").write_text(json.dumps(dict(
        vocab_size=CLIP["vocab_size"], hidden_size=CLIP["width"],
        num_hidden_layers=CLIP["layers"], num_attention_heads=CLIP["heads"],
        max_position_embeddings=77, hidden_act="gelu")))
    bpe = clip_bpe.write_bpe_vocab(list(caps.values()) * 3, str(root / "tok"), num_merges=40)
    tok = tte.UniversalTokenizer(str(clip_dir), bpe)
    ids = tok.tokenize(list(caps.values()))["input_ids"]
    assert ids.max() < CLIP["vocab_size"]

    jclip = jte.CLIPTextTransformer(context_length=77, **CLIP)
    clip_params = moved(jax.jit(jclip.init)(jax.random.PRNGKey(1), ids), 1)
    jenc = jte.UniversalTextEncoder(str(clip_dir), dtype="float32", pretrained=False,
                                    params=clip_params)
    sd = _synthetic_diffusers_state_dict(BLOCKS, 1, 4)
    vae_params = moved(jvae.vae_torch_to_params(sd, num_blocks=4, layers_per_block=1), 2)
    jv = jvae.AutoencoderKL(vae_params, BLOCKS, 1, 4, scaling_factor=SCALE)

    tenc = tte.UniversalTextEncoder(str(clip_dir), dtype="float32", pretrained=False,
                                    device="cpu")
    tinterop.load_numpy_state_dict(tenc.model, tinterop.clip_params_to_state_dict(clip_params))
    tv = tvae.AutoencoderKL(BLOCKS, 1, 4, scaling_factor=SCALE, device="cpu")
    tinterop.load_numpy_state_dict(tv, tinterop.vae_params_to_state_dict(vae_params))
    return dict(root=root, mds=str(root / "mds"), clip_dir=clip_dir, bpe=bpe, tok=tok,
                jenc=jenc, jv=jv, tenc=tenc, tv=tv)


def jax_noise(rank, seed=0):
    """The JAX precompute's VAE noise for ``rank`` as a noise_fn: drawn on the NHWC
    latents from fold_in(PRNGKey(seed + rank), bi * 10 + size), then made NCHW."""
    base = jax.random.PRNGKey(seed + rank)

    def draw(bi, size, shape):
        b, c, h, w = shape
        z = jax.random.normal(jax.random.fold_in(base, bi * 10 + size), (b, h, w, c))
        return np.ascontiguousarray(np.transpose(np.asarray(z), (0, 3, 1, 2)))
    return draw


def test_precompute_matches_jax_on_two_ranks(twins):
    t = twins
    jdir, tdir = str(t["root"] / "jax_out"), str(t["root"] / "port_out")
    for rank in (1, 0):  # rank 0 merges, so it goes last
        n = jprecompute.precompute([t["mds"]], jdir, t["jv"], t["jenc"], t["tok"],
                                   batch_size=BATCH, resize_sizes=SIZES,
                                   process_index=rank, process_count=2)
        counts = tprecompute.precompute([t["mds"]], tdir, t["tv"], t["tenc"], t["tok"],
                                        batch_size=BATCH, resize_sizes=SIZES,
                                        process_index=rank, process_count=2,
                                        noise_fn=jax_noise(rank))
        assert counts == (n, 0) and n == (5 if rank == 0 else 4)

    jidx = json.load(open(os.path.join(jdir, "index.json")))["shards"]
    tidx = json.load(open(os.path.join(tdir, "index.json")))["shards"]
    keys = ("column_names", "column_encodings", "column_sizes", "samples")
    assert [(s["raw_data"]["basename"], s["raw_data"]["bytes"], *(s[k] for k in keys))
            for s in tidx] == [(s["raw_data"]["basename"], s["raw_data"]["bytes"],
                                *(s[k] for k in keys)) for s in jidx]
    assert [s["samples"] for s in tidx] == [5, 4]

    got, ref = read_samples(tdir), read_samples(jdir)
    assert len(got) == len(ref) == N_IMAGES
    for g, r in zip(got, ref):
        assert g["caption"] == r["caption"]
        for col, shape in (("caption_latents", (77 * CLIP["width"],)),
                           ("latents_256", (4 * 32 * 32,)), ("latents_512", (4 * 64 * 64,))):
            a, b = (np.frombuffer(s[col], np.float16) for s in (g, r))
            assert a.shape == b.shape == shape, col
            assert np.isfinite(a).all() and rel_max(a, b) <= LATENT_TOL, col

    dl = build_streaming_latents_dataloader(tdir, batch_size=3, image_size=256,
                                            cap_seq_size=77, cap_emb_dim=CLIP["width"],
                                            shuffle=False, num_epochs=1)
    batches = list(dl)
    assert len(batches) == 3
    assert batches[0]["image_latents"].shape == (3, 4, 32, 32)
    assert batches[0]["caption_latents"].shape == (3, 1, 77, CLIP["width"])
    dl512 = build_streaming_latents_dataloader(tdir, batch_size=3, image_size=512,
                                               cap_seq_size=77, cap_emb_dim=CLIP["width"],
                                               shuffle=False, num_epochs=1)
    assert next(iter(dl512))["image_latents"].shape == (3, 4, 64, 64)


def write_twin_images(dirname):
    """An image MDS of two identical samples (convert.py's columns), so that ranks 0
    and 1 of 2 each encode the same image."""
    img = Image.fromarray(np.random.default_rng(3).integers(0, 256, (280, 300, 3),
                                                            dtype=np.uint8))
    with tmds.MDSWriter(out=dirname, columns={"width": "int32", "height": "int32",
                                              "jpg": "jpeg", "caption": "str"}) as w:
        for _ in range(2):
            w.write({"width": 300, "height": 280, "jpg": img, "caption": "a test caption"})


def test_default_noise_is_reproducible_and_per_rank(twins, tmp_path):
    t = twins
    write_twin_images(str(tmp_path / "mds"))
    runs = {}
    for name, rank in (("a", 0), ("b", 0), ("a", 1)):
        out = str(tmp_path / f"out_{name}")
        counts = tprecompute.precompute([str(tmp_path / "mds")], out, t["tv"], t["tenc"],
                                        t["tok"], batch_size=2, resize_sizes=(256,),
                                        process_index=rank, process_count=2, seed=7)
        assert counts == (1, 0)
        runs[name, rank] = (tmp_path / f"out_{name}" / str(rank) / "shard.00000.mds").read_bytes()
    assert runs["a", 0] == runs["b", 0]  # the same seed writes the same bytes
    rank0, rank1 = (read_samples(str(tmp_path / "out_a" / str(r)))[0] for r in (0, 1))
    assert rank0["caption_latents"] == rank1["caption_latents"]  # no noise there
    z0, z1 = (np.frombuffer(s["latents_256"], np.float16) for s in (rank0, rank1))
    assert not np.array_equal(z0, z1)  # the same image, another rank's noise
    # the draw is the one noise_fn stands in for: seeded from (seed + rank, bi, size)
    image = tcommon.resize_center_crop(tmds.MDSReader(str(tmp_path / "mds"))[0]["jpg"], 256)
    mean, logvar = t["tv"].encode_moments(torch.from_numpy(np.stack([image])))
    gen = torch.Generator().manual_seed(tprecompute.noise_seed(7 + 1, 0, 256))
    want = (mean + torch.exp(0.5 * logvar) * torch.randn(mean.shape, generator=gen)) * SCALE
    assert np.array_equal(z1, want.numpy().astype(np.float16).reshape(-1))
    assert len({tprecompute.noise_seed(s, b, z) for s in (0, 1) for b in (0, 1)
                for z in (256, 512)}) == 8


class _FailingEncoder:
    """The text encoder, raising on its second call."""

    def __init__(self, encoder):
        self.encoder, self.calls = encoder, 0

    def encode(self, ids, attention_mask=None):
        self.calls += 1
        if self.calls == 2:
            raise RuntimeError("encoder failed")
        return self.encoder.encode(ids, attention_mask)


def test_a_batch_that_raises_is_skipped_and_counted(twins, tmp_path, capsys):
    t = twins
    write_twin_images(str(tmp_path / "mds"))
    counts = tprecompute.precompute([str(tmp_path / "mds")], str(tmp_path / "out"), t["tv"],
                                    _FailingEncoder(t["tenc"]), t["tok"], batch_size=1,
                                    resize_sizes=(256,), process_index=0, process_count=1)
    assert counts.written == 1 and counts.skipped == 1
    assert "skipping batch 1" in capsys.readouterr().err
    assert len(read_samples(str(tmp_path / "out"))) == 1


def test_cli_on_the_cpu(twins, tmp_path):
    """The CLI over local snapshots (the VAE fp32, the text encoder in --model_dtype)
    writes what precompute() writes with the same objects; without --device it wants
    the card."""
    t = twins
    vae_root = tmp_path / "vae_snapshot"
    (vae_root / "vae").mkdir(parents=True)
    (vae_root / "vae" / "config.json").write_text(json.dumps(
        {"block_out_channels": list(BLOCKS), "layers_per_block": 1, "latent_channels": 4,
         "scaling_factor": SCALE}))
    torch.save(t["tv"].state_dict(), str(vae_root / "vae" / "model.pt"))
    clip_dir = tmp_path / "clip"
    shutil.copytree(t["clip_dir"], clip_dir)
    torch.save(t["tenc"].model.state_dict(), str(clip_dir / "model.pt"))
    argv = ["--datadir", t["mds"], "--vae_weights_dir", str(vae_root),
            "--text_encoder", str(clip_dir), "--text_encoder_weights_dir", str(clip_dir),
            "--tokenizer_dir", t["bpe"], "--batch_size", "4", "--image_resolutions", "256",
            "--model_dtype", "float32"]
    tprecompute.main(argv + ["--savedir", str(tmp_path / "cli"), "--device", "cpu"])
    counts = tprecompute.precompute([t["mds"]], str(tmp_path / "direct"), t["tv"], t["tenc"],
                                    t["tok"], batch_size=4, resize_sizes=(256,))
    assert counts == (N_IMAGES, 0)
    for shard in ("0/shard.00000.mds", "index.json"):
        assert ((tmp_path / "cli" / shard).read_bytes()
                == (tmp_path / "direct" / shard).read_bytes()), shard
    with pytest.raises(RuntimeError, match="CUDA"):
        tprecompute.main(argv + ["--savedir", str(tmp_path / "card")])


def test_download_and_convert_pipelines_import_without_jax():
    """The port's own download and convert pipelines (the eight modules, ported in
    slice 12): in a fresh process, importing all of them loads no jax, no flax and
    nothing of the JAX package."""
    names = ["download", "convert", "cc12m", "coco", "diffdb", "jdb", "sa1b", "textcaps"]
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module('micro_diffusion_tpu_torch.datasets.prepare.' + m)\n"
        "bad = [n for n in sys.modules\n"
        "       if n.split('.')[0] in ('jax', 'flax', 'micro_diffusion_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)


def test_get_dataset_script_on_the_cpu(twins, tmp_path):
    """micro_diffusion_tpu_torch/get_dataset.sh for coco with --device cpu and
    --skip-download (no network): the port's coco convert on raw files in COCO's
    layout, then the port's precompute at 256px over local snapshots of the tiny
    CLIP and VAE (their configs written here, not in the script), then the latents
    loader over its output: every image's latents, finite."""
    from micro_diffusion_tpu_torch.datasets.prepare import coco

    t = twins
    raw = tmp_path / "coco" / "raw"
    (raw / "annotations").mkdir(parents=True)
    (raw / "val2014").mkdir()
    anns = []
    rng = np.random.default_rng(7)
    for i in range(5):
        Image.fromarray((rng.random((280, 300 + 20 * i, 3)) * 255).astype(np.uint8)).save(
            raw / "val2014" / coco.image_file_name(i))
        anns.append({"image_id": i, "caption": f"a test caption number {i}"})
    with open(raw / "annotations" / "captions_val2014.json", "w") as f:
        json.dump({"annotations": anns}, f)
    vae_root = tmp_path / "vae_snapshot"
    (vae_root / "vae").mkdir(parents=True)
    (vae_root / "vae" / "config.json").write_text(json.dumps(
        {"block_out_channels": list(BLOCKS), "layers_per_block": 1, "latent_channels": 4,
         "scaling_factor": SCALE}))
    torch.save(t["tv"].state_dict(), str(vae_root / "vae" / "model.pt"))
    clip_dir = tmp_path / "clip"
    shutil.copytree(t["clip_dir"], clip_dir)
    torch.save(t["tenc"].model.state_dict(), str(clip_dir / "model.pt"))
    env = dict(os.environ, PYTHON=sys.executable, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               VAE_WEIGHTS_DIR=str(vae_root), TEXT_ENCODER_WEIGHTS_DIR=str(clip_dir),
               TOKENIZER_DIR=t["bpe"])
    script = os.path.join(ROOT, "micro_diffusion_tpu_torch", "get_dataset.sh")
    out = subprocess.run(["bash", script, "coco", str(tmp_path / "coco"), "--device", "cpu",
                          "--skip-download", "--", "--text_encoder", str(clip_dir),
                          "--batch_size", "4", "--image_resolutions", "256",
                          "--model_dtype", "float32"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    latents = str(tmp_path / "coco" / "mds_latents_sdxl1_dfnclipH14")
    dl = build_streaming_latents_dataloader(latents, batch_size=5, image_size=256,
                                            cap_seq_size=77, cap_emb_dim=CLIP["width"],
                                            shuffle=False, num_epochs=1)
    batch = next(iter(dl))
    assert batch["image_latents"].shape == (5, 4, 32, 32)
    assert np.isfinite(batch["image_latents"]).all()
