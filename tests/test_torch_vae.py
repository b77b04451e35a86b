"""The port's AutoencoderKL against the JAX package's: encode_mode, the clipped logvar
and decode with the JAX weights carried across by the port's converter (block_out
(32, 32, 64, 64), 1 layer a block, 4 and 16 latent channels, a 32x32 image, fp32 and
bf16); the diffusers-named state dicts of tests/test_vae.py and of
tests/test_vae_oracle.py's torch oracle loaded strict; sampling, the compute-dtype
rules, and from_pretrained over a local snapshot."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.models import vae as jvae
from micro_diffusion_tpu_torch.models import interop as tinterop
from micro_diffusion_tpu_torch.models import vae as tvae

from test_vae import _synthetic_diffusers_state_dict
from test_vae_oracle import _TorchVAE

BLOCKS = (32, 32, 64, 64)
# relative to the largest entry: fp32 ~1e-4 (the same convolutions summed in another
# order); bf16 3e-2 (every conv rounds its output to bf16 in both frameworks)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def rel_max(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def jax_params(latent):
    """JAX-side weights without an init compile: tests/test_vae.py's diffusers-named
    state dict through the JAX converter, every leaf moved by seeded noise (so the
    GroupNorm scales and the conv biases are informative)."""
    sd = _synthetic_diffusers_state_dict(BLOCKS, 1, latent)
    rng = np.random.default_rng(latent)
    sd = {k: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32) for k, v in sd.items()}
    return jvae.vae_torch_to_params(sd, num_blocks=4, layers_per_block=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("latent", [4, 16])
def test_vae_matches_jax(latent, dtype):
    params = jax_params(latent)
    jmod = jvae.AutoencoderKL(params, BLOCKS, 1, latent, compute_dtype=JDT[dtype])
    images = np.tanh(rand((2, 3, 32, 32), 1))
    z = rand((2, latent, 4, 4), 2)
    x = jnp.transpose(jnp.asarray(images), (0, 2, 3, 1))
    mean, logvar = jax.jit(lambda p, x: jmod.module.apply(p, x, method="encode_moments"))(
        params, x)
    ref_img = jmod.decode(z)

    tmod = tvae.AutoencoderKL(BLOCKS, 1, latent, compute_dtype=TDT[dtype], device="cpu")
    tinterop.load_numpy_state_dict(tmod, tinterop.vae_params_to_state_dict(params))
    t_mean, t_logvar = tmod.encode_moments(torch.from_numpy(images))
    img = tmod.decode(torch.from_numpy(z))
    assert t_mean.dtype == t_logvar.dtype == img.dtype == torch.float32
    assert t_mean.shape == (2, latent, 4, 4) and img.shape == (2, 3, 32, 32)
    assert torch.equal(tmod.encode_mode(torch.from_numpy(images)), t_mean)
    assert rel_max(t_mean, np.transpose(mean, (0, 3, 1, 2))) <= TOL[dtype]
    assert rel_max(t_logvar, np.transpose(logvar, (0, 3, 1, 2))) <= TOL[dtype]
    assert rel_max(img, ref_img) <= TOL[dtype]


def test_diffusers_state_dicts_load_strict():
    """tests/test_vae.py's synthetic diffusers-named dict loads strict (4 blocks); the
    torch oracle of tests/test_vae_oracle.py (2 blocks) loads strict and the port
    matches its encode_moments and decode (fp32, 1e-4)."""
    sd = _synthetic_diffusers_state_dict(BLOCKS, 1, 4)
    tmod = tvae.AutoencoderKL(BLOCKS, 1, 4, device="cpu")
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    assert set(tmod.state_dict()) == set(sd)

    torch.manual_seed(0)
    oracle = _TorchVAE(chans=(32, 64), layers=1, latent=4).eval()
    port = tvae.AutoencoderKL((32, 64), 1, 4, device="cpu")
    port.load_state_dict(oracle.state_dict(), strict=True)
    images = torch.from_numpy(np.tanh(rand((2, 3, 16, 16), 3)))
    with torch.no_grad():
        mean, logvar = oracle.encode_moments(images)
        ref_img = oracle.decode(mean)
    t_mean, t_logvar = port.encode_moments(images)
    assert rel_max(t_mean, mean) <= 1e-4
    assert rel_max(t_logvar, logvar.clamp(-30, 20)) <= 1e-4
    assert rel_max(port.decode(mean), ref_img) <= 1e-4


def test_encode_samples_and_seeds():
    vae = tvae.AutoencoderKL(BLOCKS, 1, 4, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.tanh(rand((1, 3, 32, 32), 4)))
    draw = lambda seed: vae.encode(images, generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(1), draw(1), draw(2)
    assert a.shape == (1, 4, 4, 4) and torch.equal(a, b) and not torch.equal(a, c)
    noise = torch.from_numpy(rand((1, 4, 4, 4), 5))
    mean, logvar = vae.encode_moments(images)
    assert torch.equal(vae.encode(images, noise=noise), mean + torch.exp(0.5 * logvar) * noise)
    assert not any(p.requires_grad for p in vae.parameters())
    img = vae.decode(a)
    assert img.shape == (1, 3, 32, 32) and torch.isfinite(img).all()


def test_from_pretrained(tmp_path):
    """A local snapshot (config.json + diffusers safetensors, under 'vae' for SDXL, at
    the root for ostris/vae-kl-f8-d16) loads strict; no weights_dir raises."""
    from safetensors.torch import save_file

    for name, sub, latent in (("stabilityai/stable-diffusion-xl-base-1.0", "vae", 4),
                              ("ostris/vae-kl-f8-d16", "", 16)):
        root = tmp_path / name.replace("/", "_")
        (root / sub).mkdir(parents=True)
        (root / sub / "config.json").write_text(json.dumps(
            {"block_out_channels": list(BLOCKS), "layers_per_block": 1,
             "latent_channels": latent, "scaling_factor": 0.5}))
        sd = _synthetic_diffusers_state_dict(BLOCKS, 1, latent)
        save_file({k: torch.from_numpy(v) for k, v in sd.items()},
                  str(root / sub / "diffusion_pytorch_model.safetensors"))
        vae = tvae.AutoencoderKL.from_pretrained(name, str(root), compute_dtype=torch.bfloat16,
                                                 device="cpu")
        assert vae.latent_channels == latent and vae.scaling_factor == 0.5
        assert vae.compute_dtype == torch.bfloat16
        for k, v in sd.items():
            assert np.array_equal(vae.state_dict()[k].numpy(), v), k
    with pytest.raises(FileNotFoundError, match="weights_dir"):
        tvae.AutoencoderKL.from_pretrained("stabilityai/stable-diffusion-xl-base-1.0")
