"""The port's CLIP zero-shot judge (micro_diffusion_tpu_torch/models/clip_zero_shot.py)
against the JAX package's: the vision tower with JAX params carried across by
``clip_vision_params_to_state_dict``, and ``CLIPZeroShot`` over the tiny HF CLIPModel
snapshot that tests/test_clip_zero_shot.py writes (image and text embeddings, the
ranking, the preprocessing). fp32 on both sides: embeddings within 1e-5 absolute."""

import jax
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.models import clip_zero_shot as jclip
from micro_diffusion_tpu_torch.models import clip_zero_shot as tclip
from micro_diffusion_tpu_torch.models import interop as tinterop

from test_clip_zero_shot import tiny_clip, write_clip_tokenizer, write_snapshot
from test_torch_prompt_to_image import moved

TOL = 1e-5
TINY = dict(image_size=28, patch_size=14, width=32, layers=2, heads=4)


@pytest.mark.parametrize("quick_gelu", [True, False])
def test_vision_tower_matches_jax(quick_gelu):
    jtower = jclip.CLIPVisionTransformer(use_quick_gelu=quick_gelu, **TINY)
    pixels = np.random.default_rng(1).standard_normal((2, 28, 28, 3)).astype(np.float32)
    params = moved(jax.jit(jtower.init)(jax.random.PRNGKey(0), pixels), 4)
    ref = np.asarray(jtower.apply(params, pixels))

    ttower = tclip.CLIPVisionTransformer(use_quick_gelu=quick_gelu, **TINY)
    tinterop.load_numpy_state_dict(ttower, tinterop.clip_vision_params_to_state_dict(params))
    with torch.no_grad():
        got = ttower(torch.from_numpy(pixels.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_vision_tower_loads_transformers_names():
    """HF CLIPVisionModel's own state dict loads with strict=True, and its round trip
    through the JAX converter gives the same dict back."""
    model, _ = tiny_clip()
    sd = {k: v for k, v in model.vision_model.state_dict().items()
          if not k.endswith("position_ids")}
    ttower = tclip.CLIPVisionTransformer(**TINY)
    ttower.load_state_dict(sd, strict=True)
    back = tinterop.clip_vision_params_to_state_dict(
        jclip.clip_vision_torch_to_params(sd, TINY["layers"]))
    assert back.keys() == sd.keys()
    assert all(np.array_equal(back[k], sd[k].numpy()) for k in sd)
    pixels = torch.from_numpy(
        np.random.default_rng(3).standard_normal((2, 3, 28, 28)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(ttower(pixels).numpy(),
                                   model.vision_model(pixel_values=pixels).pooler_output.numpy(),
                                   rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def judges(tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("clip") / "clip")
    bos_id, eos_id = write_clip_tokenizer(snap)
    model, cfg = tiny_clip(bos_id, eos_id)
    write_snapshot(model, cfg, snap)
    return jclip.CLIPZeroShot(snap), tclip.CLIPZeroShot(snap, device="cpu"), snap


def test_zero_shot_matches_jax(judges):
    jzs, tzs, _ = judges
    rng = np.random.default_rng(2)
    crops = [rng.integers(0, 255, (20, 30, 3), np.uint8), rng.integers(0, 255, (9, 7, 3), np.uint8)]
    texts = ["a photo of a red car", "a photo of a green dog", "a photo of a blue car"]
    assert np.array_equal(tclip.preprocess_images(crops, 28), jclip.preprocess_images(crops, 28))
    np.testing.assert_allclose(tzs.encode_images(crops), jzs.encode_images(crops), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tzs.encode_texts(texts), jzs.encode_texts(texts), rtol=0, atol=TOL)
    assert tzs.encode_texts(texts) is tzs.encode_texts(list(texts))  # cached per list
    many = [rng.integers(0, 255, (16, 16, 3), np.uint8) for _ in range(8)]
    assert tzs.classify(many, texts) == jzs.classify(many, texts)


def test_zero_shot_needs_the_card_unless_asked(judges, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tclip.CLIPZeroShot(judges[2])
