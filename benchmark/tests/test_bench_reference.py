"""The plain reference against the port, on the CPU at the Micro and Tiny sizes: with
the port computing in float32 the two agree to float32 round-off, so the gaps the
checks read on the card are the program's precision and nothing else."""

import json
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import bpe, edm
from benchmark.reference.dit import MicroDiT
from benchmark.reference.encoders import VAE, CLIPText

HERE = os.path.dirname(os.path.abspath(__file__))


def config_file(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


TINY = dict(config_file("micro-256")["model"], arch="MicroDiT_Tiny_2", depth=16, dim=512,
            head_dim=32, multiple_of=256, mixer_depth=4, mixer_dim=512, num_experts=8)


def port_dit(m, latent_res):
    """The port's DiT computing in float32. Its MoE dispatch is 'batched', the same
    function as products in the compute dtype: the fused expert kernels' contract
    rounds the hidden to bf16 whatever the input dtype."""
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion

    return create_latent_diffusion(dit_arch=m["arch"], latent_res=latent_res,
                                   pos_interp_scale=m["pos_interp_scale"], dtype="float32",
                                   moe_dispatch="batched", device="cpu").dit


@pytest.mark.parametrize("size,mask_ratio", [("micro", 0.0), ("micro", 0.75), ("tiny", 0.0),
                                             ("tiny", 0.75)])
def test_dit_matches_the_port_in_float32(size, mask_ratio):
    from micro_diffusion_tpu_torch.ops.masking import make_token_mask

    m = config_file("micro-512")["model"] if size == "micro" else TINY
    port = port_dit(m, m["latent_res"])
    ref = MicroDiT(m)
    names = {k: tuple(p.shape) for k, p in port.named_parameters()}
    assert names == {k: tuple(p.shape) for k, p in ref.named_parameters()}
    inputs.fill_weights(dict(port.named_parameters()), 5)
    inputs.fill_weights(dict(ref.named_parameters()), 5)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, m["latent_res"], m["latent_res"], generator=g)
    t = torch.randn(3, generator=g)
    y = torch.randn(3, m["caption_len"], m["caption_channels"], generator=g)
    mask = make_token_mask(g, 3, (m["latent_res"] // 2) ** 2, mask_ratio) if mask_ratio else None
    with torch.no_grad():
        want = port.forward_without_cfg(x, t, y, mask_ratio, token_mask=mask)["sample"]
        got = ref(x, t, y, None if mask is None else (mask.ids_keep, mask.ids_restore))
    assert torch.linalg.vector_norm(got - want) <= 1e-5 * torch.linalg.vector_norm(want)


def test_encoders_match_the_port_in_float32():
    from micro_diffusion_tpu_torch.models.text_encoders import CLIPTextTransformer
    from micro_diffusion_tpu_torch.models.vae import AutoencoderKL

    t = dict(vocab=300, width=64, layers=2, heads=4, context=77, quick_gelu=False)
    port_text = CLIPTextTransformer(300, 64, 2, 4, 77, False, torch.float32, device="cpu")
    ref_text = CLIPText(t)
    v = dict(channels=[32, 64], layers=1, latent_channels=4, scaling_factor=0.13025)
    port_vae = AutoencoderKL(block_out_channels=(32, 64), layers_per_block=1, device="cpu")
    ref_vae = VAE(v)
    for port, ref in ((port_text, ref_text), (port_vae, ref_vae)):
        assert ({k: tuple(p.shape) for k, p in port.named_parameters()}
                == {k: tuple(p.shape) for k, p in ref.named_parameters()})
        inputs.fill_weights(dict(port.named_parameters()), 3)
        inputs.fill_weights(dict(ref.named_parameters()), 3)
    ids = torch.randint(0, 300, (2, 77), generator=torch.Generator().manual_seed(1))
    z = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.allclose(ref_text(ids), port_text(ids), rtol=1e-4, atol=1e-4)
        want = (port_vae.decode(z / 0.13025) / 2 + 0.5).clamp(0, 1)
        assert torch.allclose(ref_vae.decode_images(z), want, atol=1e-5)


def test_tokenizer_is_the_ports():
    from micro_diffusion_tpu_torch.utils.clip_bpe import CLIPBPETokenizer

    pool = inputs.captions(os.path.join(harness.BENCH, "traffic", "captions.txt"))
    with tempfile.TemporaryDirectory() as d:
        bpe.write_bpe_vocab(pool, d, num_merges=200)
        np.testing.assert_array_equal(bpe.CLIPBPETokenizer(d)(pool)["input_ids"],
                                      CLIPBPETokenizer(d)(pool)["input_ids"])


def _cell(config, traffic, params, limits, fault=None, fp32=False, seed=2**31 + 77):
    cfg = config_file(config)
    if fp32:
        cfg["recipe"]["overrides"] = cfg["recipe"]["overrides"] + ["model.dtype=float32"]
        for part in cfg.get("sample", {}).values():
            part["dtype"] = "float32"
    wl = {"config": config, "traffic": traffic, "chips": 1, "params": params, "limits": limits}
    return harness.Cell(name="test", workload=wl, config=cfg, traffic=harness.traffic(traffic),
                        seed=seed, seconds=0.0, trace=False, device="cpu",
                        tmpdir=tempfile.mkdtemp(), t0=time.perf_counter(), per_layer=[],
                        fault=fault)


TRAIN_PARAMS = {"samples": 32, "followed_steps": 3, "ref_rows": 4}
TIGHT = {"loss": 1e-5, "grad": 1e-5, "update": 1e-3, "ema": 1e-3, "data_rows": 0, "path": 0}


@pytest.mark.parametrize("config,ema_start", [
    pytest.param("micro-256", None, id="micro-256"),
    pytest.param("micro-512", None, id="micro-512"),
    pytest.param("micro-512", 0, id="micro-512-ema-decay")])
def test_training_run_matches_the_reference_in_float32(config, ema_start):
    """The runner's whole check, with the port in float32: every reading at round-off
    (the change's last digits swing with Adam's sign on near-zero gradients). With the
    EMA decaying from the first step, its change is (1 - smoothing) = 1/400 of the
    parameters', on weights that float32 rounds no finer: its round-off is 1e-2."""
    cell = _cell(config, "train", TRAIN_PARAMS, TIGHT, fp32=True)
    if ema_start is not None:
        cell.config["recipe"]["overrides"].append(f"algorithms.ema.ema_start={ema_start}ba")
        cell.config["train"]["ema"]["start"] = ema_start
        cell.workload["limits"] = dict(TIGHT, ema=1e-2)
    out = harness.runner("train").run(cell)
    assert harness.judged(out["checks"]), out["checks"]


def test_sampling_run_matches_the_reference_in_float32():
    params = {"prompts": 4, "steps": 3, "check_per_call": 2}
    # start and heun: float32 round-off against the float64 replay, ~1e-6 of the state
    # at 3 steps, whatever the thread count
    limits = {"start": 1e-5, "heun": 1e-5, "denoise": 1e-4, "decode": 1e-4, "path": 0}
    out = harness.runner("sample").run(_cell("micro-512", "sample-b32", params, limits,
                                              fp32=True))
    assert harness.judged(out["checks"]), out["checks"]


def test_sampler_is_edm_heun():
    """The reference sampler on the denoiser of data x0 ~ N(0, s_d^2): a network
    output of 0 leaves D = c_skip x, the posterior mean, whose probability-flow ODE
    scales x by sqrt(s_d^2 + sigma^2): from 80 * noise at sigma_max to
    0.9 / sqrt(0.81 + 80^2) of that at sigma = 0 (to second order in the step: 1.5%
    off at 30 steps, 1e-5 at 1000)."""
    class Gaussian(torch.nn.Module):
        def forward(self, x, c_noise, y, mask=None):
            return torch.zeros_like(x)

    x = torch.randn(2, 4, 8, 8, dtype=torch.float64)
    out = edm.heun_sample(Gaussian(), x, torch.zeros(2, 3, 5), 1000, 5.0)
    torch.testing.assert_close(out, x * 80 * 0.9 / (0.81 + 80 ** 2) ** 0.5, rtol=1e-4,
                               atol=0)
