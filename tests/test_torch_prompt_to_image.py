"""Prompt -> image through the port against the JAX package: MicroDiT_Micro_2 at
latent_res 8 with the tiny CLIP text tower and the tiny VAE, the same weights on both
sides (carried across by the port's converters). The composed text_encoder.encode ->
edm_sampler_loop (3 steps, CFG 5, injected x) -> vae.decode / clip path against
JAX's; generate(prompt=...) over a tokenizer directory against the port's own
composed calls; the raw-image training loss against JAX's forward with the same
draws; create_latent_diffusion(load_encoders=True) over local snapshots."""

import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.models import diffusion as jdiffusion
from micro_diffusion_tpu.models import dit as jdit
from micro_diffusion_tpu.models import text_encoders as jte
from micro_diffusion_tpu.models import vae as jvae
from micro_diffusion_tpu_torch.models import diffusion as tdiffusion
from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.models import interop as tinterop
from micro_diffusion_tpu_torch.models import text_encoders as tte
from micro_diffusion_tpu_torch.models import vae as tvae
from micro_diffusion_tpu_torch.utils import clip_bpe

from test_vae import _synthetic_diffusers_state_dict

RES, BLOCKS, SCALE = 8, (32, 32, 64, 64), 0.5
CLIP = dict(vocab_size=1000, width=64, layers=2, heads=4)
PROMPTS = ["a photo of a cat", "two dogs playing in the snow!"]
# fp32 on both sides. Embeddings 1e-4 of their largest entry; latents 1e-3 (abs and
# rel) after five DiT forwards, as tests/test_torch_diffusion.py's sampler test;
# images 1e-3 of the largest entry, the VAE's own error on top of the latents'.
EMB_TOL, LAT_TOL, IMG_TOL = 1e-4, 1e-3, 1e-3


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def rel_max(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def moved(tree, seed):
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(leaf) + 0.05 * np.random.default_rng(
            zlib.crc32(str(path).encode()) + seed).standard_normal(leaf.shape).astype(
                np.float32), tree)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """(JAX LatentDiffusion, its DiT params, port LatentDiffusion, token ids, dirs):
    the tiny CLIP's config.json directory serves as its name on both sides."""
    root = tmp_path_factory.mktemp("serve")
    clip_dir = root / "clip"
    clip_dir.mkdir()
    (clip_dir / "config.json").write_text(json.dumps(dict(
        vocab_size=CLIP["vocab_size"], hidden_size=CLIP["width"],
        num_hidden_layers=CLIP["layers"], num_attention_heads=CLIP["heads"],
        max_position_embeddings=77, hidden_act="gelu")))
    bpe = clip_bpe.write_bpe_vocab(PROMPTS * 3, str(root / "tok"), num_merges=40)
    ids = clip_bpe.CLIPBPETokenizer(bpe)(PROMPTS)["input_ids"]
    assert ids.max() < CLIP["vocab_size"]

    jclip = jte.CLIPTextTransformer(context_length=77, **CLIP)
    clip_params = moved(jax.jit(jclip.init)(jax.random.PRNGKey(1), ids), 1)
    jenc = jte.UniversalTextEncoder(str(clip_dir), dtype="float32", pretrained=False,
                                    params=clip_params)
    sd = _synthetic_diffusers_state_dict(BLOCKS, 1, 4)
    vae_params = moved(jvae.vae_torch_to_params(sd, num_blocks=4, layers_per_block=1), 2)
    jv = jvae.AutoencoderKL(vae_params, BLOCKS, 1, 4, scaling_factor=SCALE)
    jmodel = jdit.MicroDiT_Micro_2(input_size=RES, caption_channels=CLIP["width"],
                                   dtype=jnp.float32)
    x0, y0 = np.zeros((1, 4, RES, RES), np.float32), np.zeros((1, 1, 77, 64), np.float32)
    rng = jax.random.PRNGKey(0)
    params = moved(jax.jit(lambda: jmodel.init({"params": rng, "mask": rng}, x0,
                                               np.zeros(1, np.float32), y0))(), 3)
    jld = jdiffusion.LatentDiffusion(dit=jmodel, vae=jv, text_encoder=jenc, latent_res=RES)

    tenc = tte.UniversalTextEncoder(str(clip_dir), dtype="float32", pretrained=False,
                                    device="cpu")
    tinterop.load_numpy_state_dict(tenc.model, tinterop.clip_params_to_state_dict(clip_params))
    tv = tvae.AutoencoderKL(BLOCKS, 1, 4, scaling_factor=SCALE, device="cpu")
    tinterop.load_numpy_state_dict(tv, tinterop.vae_params_to_state_dict(vae_params))
    tdit_ = tinterop.load_jax_params(tdit.MicroDiT_Micro_2(
        input_size=RES, caption_channels=CLIP["width"], dtype=torch.float32, device="cpu"),
        params).eval()
    tld = tdiffusion.LatentDiffusion(tdit_, vae=tv, text_encoder=tenc,
                                     tokenizer=tte.UniversalTokenizer(str(clip_dir), bpe),
                                     latent_res=RES)
    assert jld.latent_scale == tld.latent_scale == SCALE
    return jld, params, tld, ids, dict(clip=clip_dir, bpe=bpe)


def test_composed_prompt_to_image_matches_jax(twins):
    jld, params, tld, ids, _ = twins
    x = rand((2, 4, RES, RES), 7)
    j_emb = jld.text_encoder.encode(ids)[0]
    j_lat = jax.jit(lambda p, x, y: jld.edm_sampler_loop(p, x, y, steps=3, cfg=5.0))(
        params, x, j_emb)
    j_img = jnp.clip(jld.vae.decode(j_lat / jld.latent_scale) / 2.0 + 0.5, 0.0, 1.0)

    t_emb = tld.text_encoder.encode(ids)[0]
    t_lat = tld.edm_sampler_loop(torch.from_numpy(x), t_emb, steps=3, cfg=5.0)
    t_img = tld.decode_latents(t_lat)
    assert t_emb.shape == (2, 1, 77, 64) and t_img.shape == (2, 3, 8 * RES, 8 * RES)
    assert t_img.dtype == torch.float32 and 0.0 <= t_img.min() and t_img.max() <= 1.0
    assert rel_max(t_emb, j_emb) <= EMB_TOL
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), rtol=LAT_TOL, atol=LAT_TOL)
    assert rel_max(t_img, j_img) <= IMG_TOL
    assert float(t_img.std()) > 0.0


def test_generate_from_prompts_equals_composed_calls(twins):
    _, _, tld, _, _ = twins
    img = tld.generate(prompt=PROMPTS, guidance_scale=5.0, num_inference_steps=3, seed=11)
    ids = tld.tokenizer.tokenize(PROMPTS)["input_ids"]
    emb = tld.text_encoder.encode(ids)[0]
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((2, 4, RES, RES), generator=gen)
    lat = tld.edm_sampler_loop(x, emb, steps=3, cfg=5.0, generator=gen)
    assert torch.equal(img, tld.decode_latents(lat))
    assert torch.equal(tld.generate(tokenized_prompts=ids, num_inference_steps=3, seed=11), img)
    assert torch.equal(tld.generate(prompt=PROMPTS, num_inference_steps=3, seed=11,
                                    return_only_latents=True), lat)


def test_raw_image_loss_matches_jax_forward(twins):
    """forward on {'image', 'captions'}: the VAE's sample times latent_scale, the
    text encoder's embeddings, the EDM loss, with JAX's draws injected (its latent
    noise is drawn NHWC)."""
    jld, params, tld, ids, _ = twins
    images = np.tanh(rand((2, 3, 8 * RES, 8 * RES), 8))
    keep = np.array([1.0, 0.0], np.float32)
    rng = jax.random.PRNGKey(5)
    j_loss, j_lat, j_cond = jax.jit(lambda p, r, b: jld.forward(p, r, b))(
        params, rng, {"image": images, "captions": ids, "drop_caption_mask": keep})
    r_sigma, r_noise, _ = jax.random.split(rng, 3)
    draws = dict(latent_noise=np.transpose(jax.random.normal(rng, (2, RES, RES, 4)), (0, 3, 1, 2)),
                 rnd_normal=jax.random.normal(r_sigma, (2, 1, 1, 1)),
                 noise=jax.random.normal(r_noise, (2, 4, RES, RES)))
    batch = {"image": torch.from_numpy(images), "captions": torch.from_numpy(ids),
             "drop_caption_mask": torch.from_numpy(keep)}
    with torch.no_grad():
        t_loss, t_lat, t_cond = tld(batch, **{k: torch.from_numpy(np.array(v))
                                              for k, v in draws.items()})
    assert rel_max(t_lat, j_lat) <= 1e-4 and rel_max(t_cond, j_cond) <= EMB_TOL
    assert abs(float(t_loss) - float(j_loss)) <= 1e-4 * abs(float(j_loss))


def test_create_latent_diffusion_with_encoders(twins, tmp_path):
    """load_encoders=True over local snapshots (the VAE under 'vae', the CLIP tower's
    state dict, the BPE directory): the VAE follows the factory dtype and images
    come out in [0, 1]; no weights_dir raises FileNotFoundError, as in JAX."""
    from safetensors.torch import save_file

    _, _, tld, _, dirs = twins
    (tmp_path / "vae").mkdir()
    (tmp_path / "vae" / "config.json").write_text(json.dumps(
        {"block_out_channels": list(BLOCKS), "layers_per_block": 1, "latent_channels": 4}))
    save_file(tld.vae.state_dict(), str(tmp_path / "vae" / "model.safetensors"))
    save_file({k: v.contiguous() for k, v in tld.text_encoder.model.state_dict().items()},
              str(dirs["clip"] / "model.safetensors"))
    kw = dict(text_encoder_name=str(dirs["clip"]), dit_arch="MicroDiT_Micro_2",
              latent_res=RES, device="cpu", load_encoders=True)
    for dtype, vae_dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = tdiffusion.create_latent_diffusion(
            dtype=dtype, weights_dir=str(tmp_path), tokenizer_dir=dirs["bpe"],
            text_encoder_weights_dir=str(dirs["clip"]), **kw)
        assert model.vae.compute_dtype == vae_dtype and model.latent_scale == 0.13025
        if dtype == "float32":  # the snapshot holds the twin's weights
            assert torch.equal(model.text_encoder.encode([[1, 2, 3]])[0],
                               tld.text_encoder.encode([[1, 2, 3]])[0])
    img = model.generate(prompt=PROMPTS[:1], num_inference_steps=2, seed=1)
    assert img.shape == (1, 3, 8 * RES, 8 * RES) and img.dtype == torch.float32
    assert torch.isfinite(img).all() and 0.0 <= img.min() and img.max() <= 1.0
    with pytest.raises(FileNotFoundError):
        tdiffusion.create_latent_diffusion(**kw)
