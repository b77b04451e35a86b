"""The PyTorch port's EDM sampling against the JAX package's: the sigma schedule,
the Heun sampler loop on the kernel-shaped DiT with weights carried across, the
generate() entry point, the device rule, and that the port imports no JAX."""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.models import diffusion as jdiffusion
from micro_diffusion_tpu_torch.models import diffusion as tdiffusion
from micro_diffusion_tpu_torch.models import dit as tdit

from test_torch_dit import jax_model_and_params, rand, torch_twin


@pytest.mark.parametrize("num_steps", [2, 3, 18, 30])
def test_sigma_schedule_bit_identical(num_steps):
    j = jdiffusion.LatentDiffusion(dit=None)._sigma_schedule(num_steps)
    t = tdiffusion.LatentDiffusion(dit=None)._sigma_schedule(num_steps)
    assert j.dtype == t.dtype == np.float64
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("cfg_scale", [1.0, 5.0])
def test_edm_sampler_loop_matches_jax(cfg_scale):
    """3 Heun steps from the same x and y, S_churn = 0 (no noise is drawn). Tolerance
    1e-3 (abs and rel), the DiT's on the kernel-shaped config: the sampler adds
    only fp32 elementwise steps on top of five DiT forwards."""
    jmodel, params, (_, _, y) = jax_model_and_params("kernel")
    x = rand((2, 4, 16, 16), 11)
    jld = jdiffusion.LatentDiffusion(dit=jmodel, latent_res=16)
    ref = jax.jit(lambda p, x, y: jld.edm_sampler_loop(p, x, y, steps=3, cfg=cfg_scale))(
        params, x, y)
    tld = tdiffusion.LatentDiffusion(torch_twin("kernel", params), latent_res=16)
    out = tld.edm_sampler_loop(torch.from_numpy(x), torch.from_numpy(y), steps=3,
                               cfg=cfg_scale)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-3)


def test_generate_shape_and_seed():
    model = tdiffusion.create_latent_diffusion(dit_arch="MicroDiT_Micro_2", latent_res=16,
                                               device="cpu", seed=0)
    y = torch.from_numpy(rand((2, 77, 1024), 12))
    run = lambda seed: model.generate(text_embeddings=y, guidance_scale=5.0,
                                      num_inference_steps=3, seed=seed,
                                      return_only_latents=True)
    a, b, c = run(7), run(7), run(8)
    assert a.shape == (2, 4, 16, 16) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # decoding and prompts raise only while no VAE / tokenizer / text encoder is
    # attached (tests/test_torch_prompt_to_image.py drives them attached)
    with pytest.raises(RuntimeError, match="needs a vae, and none is attached"):
        model.generate(text_embeddings=y, num_inference_steps=2)
    with pytest.raises(RuntimeError, match="needs a tokenizer, and none is attached"):
        model.generate(prompt=["a cat"], return_only_latents=True)
    with pytest.raises(RuntimeError, match="needs a text encoder, and none is attached"):
        model.generate(tokenized_prompts=np.zeros((2, 77), np.int64),
                       return_only_latents=True)


def test_no_device_means_the_card(monkeypatch):
    """device=None selects CUDA and raises without a card; it never picks the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdiffusion.create_latent_diffusion(dit_arch="MicroDiT_Micro_2")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdit.MicroDiT_Micro_2()


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import micro_diffusion_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "banned = ('jax', 'flax', 'micro_diffusion_tpu', 'transformers', 'safetensors',\n"
        "          'open_clip', 'diffusers', 'sentencepiece', 'regex')\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in banned]\n"
        "assert not bad, bad\n"
        "assert 'micro_diffusion_tpu_torch.models.diffusion' in sys.modules\n"
        "assert 'micro_diffusion_tpu_torch.models.text_encoders' in sys.modules\n"
        "assert 'micro_diffusion_tpu_torch.models.vae' in sys.modules\n"
        "assert 'micro_diffusion_tpu_torch.train.train_step' in sys.modules\n"
        "for m in ('datasets.prepare.precompute', 'datasets.prepare.common',\n"
        "          'datasets.prepare.specs', 'datasets.captions',\n"
        "          'models.convert_checkpoint', 'utils.profiling', 'parallel.mesh',\n"
        "          'parallel.sharding', 'parallel.dryrun'):\n"
        "    assert 'micro_diffusion_tpu_torch.' + m in sys.modules, m\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
