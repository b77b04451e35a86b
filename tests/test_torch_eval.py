"""The port's FID path and image generation (micro_diffusion_tpu_torch/eval/fid.py,
generate_eval_images.py, run_eval.sh; load_any_checkpoint) against the JAX package's:
the streaming statistics and the Frechet distance (relative 1e-10: the same float64
arithmetic), the .npz statistics across packages, the FID CLI of both packages on the
same PNG directories with the synthetic Inception (relative 1e-4: the features agree
to 1e-5 of their scale, tests/test_torch_inception.py), ``generate_images`` (names,
manifest, per-batch seeds, truncating uint8), the port's run_eval.sh end to end on
the CPU, and LogDiffusionImages through the attached encoders."""

import contextlib
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from micro_diffusion_tpu.eval import fid as jfid
from micro_diffusion_tpu.eval import inception as jinc
from micro_diffusion_tpu_torch.eval import fid as tfid
from micro_diffusion_tpu_torch.eval.generate_eval_images import generate_images
from micro_diffusion_tpu_torch.models import diffusion as tdiffusion
from micro_diffusion_tpu_torch.models import interop as tinterop
from micro_diffusion_tpu_torch.models import text_encoders as tte
from micro_diffusion_tpu_torch.models import vae as tvae
from micro_diffusion_tpu_torch.train import callbacks as tcallbacks
from micro_diffusion_tpu_torch.train import trainer as ttrainer
from micro_diffusion_tpu_torch.utils import clip_bpe

from test_run_eval import build_checkpoint, build_weights_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FID_TOL = 1e-4


def test_stats_and_frechet_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((n, 64)) * rng.uniform(0.5, 2) for n in (50, 64, 7)]
    t, j = tfid.FIDStats(dim=64), jfid.FIDStats(dim=64)
    for f in feats:
        t.update(f.astype(np.float32))
        j.update(f.astype(np.float32))
    np.testing.assert_allclose(t.mean, j.mean, rtol=1e-10)
    np.testing.assert_allclose(t.cov, j.cov, rtol=1e-10)
    other = tfid.FIDStats(dim=64)
    other.update(rng.standard_normal((90, 64)) + 0.3)
    got = tfid.compute_fid_from_stats(t, other)
    assert got == pytest.approx(jfid.frechet_distance(j.mean, j.cov, other.mean, other.cov),
                                rel=1e-10)
    # statistics saved by either package load in the other
    t.save(tmp_path / "t.npz")
    j.save(tmp_path / "j.npz")
    for a, b in ((tfid.FIDStats.load(tmp_path / "j.npz"), j),
                 (jfid.FIDStats.load(tmp_path / "t.npz"), t)):
        assert a.n == b.n and np.array_equal(a.sum, b.sum)
        assert np.array_equal(a.outer_sum, b.outer_sum)
    with pytest.raises(ValueError, match="features of shape"):
        t.update(np.zeros((2, 3)))


def write_pngs(dirname, n, side, seed, top=256):
    """``n`` PNGs of uniform noise in [0, top), ``side`` high, wider by 3 px each."""
    from PIL import Image

    os.makedirs(dirname, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, top, (side, side + 3 * i, 3), np.uint8)).save(
            os.path.join(dirname, f"{i}.png"))


def spread_params():
    """``synthetic_params(0)`` made variance-preserving (He-scaled convolutions, BN the
    identity): with the plain synthetic set every image's features agree to ~1e-3 of
    their size, and the CLI's FID, printed to 4 decimals, is 0.0000 for any two sets."""
    out = {}
    for k, v in jinc.synthetic_params(0).items():
        if k.endswith("conv.weight"):
            v = v * np.float32(2**0.5)
        elif k.endswith("bn.weight"):
            v = np.ones_like(v)
        elif k.endswith("running_var"):
            v = np.full_like(v, 1.0 - jinc.BN_EPS)
        else:  # bn.bias, running_mean
            v = np.zeros_like(v)
        out[k] = v
    return out


def test_fid_cli_matches_jax(tmp_path, capsys):
    """Both packages' CLIs on the same two directories of 4 PNGs (64 px, some wider
    than high: the centre crop) with synthetic pt_inception weights."""
    write_pngs(tmp_path / "real", 4, 64, 0)
    write_pngs(tmp_path / "fake", 4, 64, 1, top=100)  # darker: an FID well above 0
    for got, ref in zip(tfid.iter_image_dir_batches(str(tmp_path / "real"), 3),
                        jfid.iter_image_dir_batches(str(tmp_path / "real"), 3)):
        assert np.array_equal(got, ref)
    weights = tmp_path / "pt_inception.pth"
    torch.save({k: torch.from_numpy(v) for k, v in spread_params().items()}, weights)
    args = ["--real", str(tmp_path / "real"), "--fake", str(tmp_path / "fake"),
            "--inception_weights", str(weights)]
    jfid.main(args)
    ref = json.loads(capsys.readouterr().out)
    tfid.main(args + ["--device", "cpu", "--save_real_stats", str(tmp_path / "real.npz")])
    got = json.loads(capsys.readouterr().out)
    assert (got["real_n"], got["fake_n"]) == (ref["real_n"], ref["fake_n"]) == (4, 4)
    assert np.isfinite(got["fid"]) and got["fid"] > 1.0
    assert got["fid"] == pytest.approx(ref["fid"], rel=FID_TOL)
    assert jfid.FIDStats.load(str(tmp_path / "real.npz")).n == 4


RES, BLOCKS = 8, (32, 32, 64, 64)
CAPTIONS = ["a red car", "a green dog on grass", "a blue boat", "two cats", "a bus"]


@pytest.fixture(scope="module")
def micro_model(tmp_path_factory):
    """MicroDiT_Micro_2 at latent_res 8 with a tiny CLIP text tower, a BPE tokenizer
    and the tiny VAE, random weights from seeded generators, on the CPU."""
    root = tmp_path_factory.mktemp("gen")
    clip_dir = root / "clip"
    clip_dir.mkdir()
    (clip_dir / "config.json").write_text(json.dumps(dict(
        vocab_size=1000, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=77, hidden_act="gelu")))
    tok = clip_bpe.write_bpe_vocab(CAPTIONS, str(root / "tok"), num_merges=30)
    gen = torch.Generator().manual_seed(0)
    model = tdiffusion.create_latent_diffusion(
        text_encoder_name=str(clip_dir), dit_arch="MicroDiT_Micro_2", latent_res=RES,
        dtype="float32", device="cpu")
    with torch.no_grad():
        for p in model.dit.parameters():  # no zero-initialised layer: images vary
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    model.text_encoder = tte.UniversalTextEncoder(str(clip_dir), dtype="float32",
                                                  pretrained=False, device="cpu",
                                                  generator=gen)
    model.tokenizer = tte.UniversalTokenizer(str(clip_dir), tok)
    model.vae = tvae.AutoencoderKL(BLOCKS, 1, 4, scaling_factor=0.5, device="cpu").init_weights(gen)
    model.latent_scale = 0.5
    return model


def test_generate_images(micro_model, tmp_path):
    """%06d.png names, manifest.json of {file, caption}, batch lo sampled with seed
    seed + lo, and the PNGs hold (x * 255).astype(uint8) of those images: truncated."""
    from PIL import Image

    n = generate_images(micro_model, CAPTIONS, str(tmp_path), batch_size=2, steps=2, cfg=5.0,
                        seed=7)
    names = [f"{i:06d}.png" for i in range(5)]
    assert n == 5 and sorted(os.listdir(tmp_path)) == names + ["manifest.json"]
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest == [{"file": f, "caption": c} for f, c in zip(names, CAPTIONS)]
    truncated_differs = False
    for lo in (0, 2, 4):
        images = micro_model.generate(prompt=CAPTIONS[lo:lo + 2], guidance_scale=5.0,
                                      num_inference_steps=2, seed=7 + lo)
        scaled = images.numpy().transpose(0, 2, 3, 1) * 255
        for i in range(images.shape[0]):
            png = np.asarray(Image.open(tmp_path / names[lo + i]))
            assert np.array_equal(png, scaled[i].astype(np.uint8))
            truncated_differs |= not np.array_equal(png, np.round(scaled[i]).astype(np.uint8))
    assert truncated_differs  # the check above tells truncation from rounding
    first = np.asarray(Image.open(tmp_path / names[0]))
    assert first.std() > 0 and not np.array_equal(
        first, np.asarray(Image.open(tmp_path / names[2])))


def test_load_any_checkpoint(micro_model, tmp_path):
    """A reference .pt; the port trainer's checkpoint (EMA preferred, a step directory
    or a folder of them); an orbax directory raises and names the converter."""
    dit = micro_model.dit
    sd = {k: v.clone() for k, v in dit.state_dict().items()}
    torch.save(sd, tmp_path / "ref.pt")
    got = tinterop.load_any_checkpoint(str(tmp_path / "ref.pt"))
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)

    params = dict(dit.named_parameters())
    ema = {k: v.detach() + 1.0 for k, v in params.items()}
    for name, payload in (("with_ema", {"ema_params": ema}), ("no_ema", {})):
        step_dir = tmp_path / name / "3"
        step_dir.mkdir(parents=True)
        torch.save({"step": 3, "params": {k: v.detach() for k, v in params.items()},
                    "opt_state": {}, "loader": {}, **payload}, step_dir / ttrainer.CKPT_FILE)
    fresh = tdiffusion.create_latent_diffusion(
        text_encoder_name=str(micro_model.text_encoder.name), dit_arch="MicroDiT_Micro_2",
        latent_res=RES, dtype="float32", device="cpu", seed=1).dit
    tinterop.load_any_checkpoint(str(tmp_path / "with_ema"), fresh)
    assert all(torch.equal(p, ema[k]) for k, p in fresh.named_parameters())
    got = tinterop.load_any_checkpoint(str(tmp_path / "no_ema" / "3"))
    assert all(torch.equal(got[k], p) for k, p in params.items())

    orbax = tmp_path / "orbax"
    (orbax / "5" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax.*params_to_torch_state_dict"):
        tinterop.load_any_checkpoint(str(orbax))


def test_run_eval_script_full_chain_on_the_cpu(tmp_path):
    """micro_diffusion_tpu_torch/eval/run_eval.sh --device cpu over the weights layout
    of tests/test_run_eval.py: checkpoint load -> sampling -> decode -> PNGs ->
    Inception FID -> GenEval generation and scoring with the CLIP colour judge."""
    weights, caption_dim = build_weights_dir(tmp_path)
    ckpt = build_checkpoint(tmp_path, weights / "text_encoder", caption_dim)
    (tmp_path / "captions.json").write_text(json.dumps(["a red car", "a green dog",
                                                        "a blue boat"]))
    write_pngs(tmp_path / "real", 4, 32, 0)
    inception = tmp_path / "pt_inception.pth"
    torch.save({k: torch.from_numpy(v) for k, v in jinc.synthetic_params(0).items()}, inception)
    manifest = tmp_path / "geneval.jsonl"
    manifest.write_text(
        json.dumps({"tag": "single_object", "prompt": "a photo of a car",
                    "include": [{"class": "car", "count": 1}]}) + "\n"
        + json.dumps({"tag": "colors", "prompt": "a photo of a red dog",
                      "include": [{"class": "dog", "count": 1, "color": "red"}]}) + "\n")
    (tmp_path / "det.json").write_text(json.dumps([
        [{"class": "car", "bbox": [2, 2, 20, 20], "score": 0.9}],
        [{"class": "dog", "bbox": [2, 2, 20, 20], "score": 0.9}]]))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        ["bash", os.path.join(REPO, "micro_diffusion_tpu_torch", "eval", "run_eval.sh"),
         str(ckpt), str(weights), str(out), "--captions", str(tmp_path / "captions.json"),
         "--real", str(tmp_path / "real"), "--inception", str(inception),
         "--geneval-manifest", str(manifest), "--detections", str(tmp_path / "det.json"),
         "--arch", "MicroDiT_Micro_2", "--latent_res", "8", "--pos_interp_scale", "1.0",
         "--text-encoder-name", str(weights / "text_encoder"), "--steps", "2", "--cfg", "1.5",
         "--batch", "2", "--seed", "7", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert len([f for f in os.listdir(out / "fid_images") if f.endswith(".png")]) == 3
    fid = json.loads((out / "fid.json").read_text())
    assert np.isfinite(fid["fid"]) and (fid["real_n"], fid["fake_n"]) == (4, 3)
    scores = json.loads((out / "geneval.json").read_text())
    assert scores["color_judge"] == "clip_zero_shot" and scores["single_object"] == 1.0
    assert 0.0 <= scores["colors"] <= 1.0 and "overall" in scores
    rows = [json.loads(l) for l in (out / "geneval_results.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and set(rows[0]) == {"filename", "tag", "prompt", "correct"}


def test_clis_need_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    weights = tmp_path / "w.pth"
    torch.save({k: torch.from_numpy(v) for k, v in jinc.synthetic_params(0).items()}, weights)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfid.main(["--real", str(tmp_path), "--fake", str(tmp_path),
                   "--inception_weights", str(weights)])


class RecordingLogger(tcallbacks.Logger):
    def __init__(self):
        self.images, self.scalars = [], []

    def log_scalars(self, scalars, step):
        self.scalars.append((step, scalars))

    def log_images(self, name, images, step):
        self.images.append((name, np.asarray(images), step))


class StubTrainer:
    """What LogDiffusionImages reads of a Trainer: the model, the loggers, the step,
    log / print and the eval-weights context (which it must enter)."""

    def __init__(self, model, loggers):
        self.model, self.loggers, self.global_step = model, loggers, 5
        self.swaps, self.printed = 0, []

    @contextlib.contextmanager
    def eval_weights(self):
        self.swaps += 1
        yield

    def log(self, scalars):
        for logger in self.loggers:
            logger.log_scalars(scalars, self.global_step)

    def print(self, msg):
        self.printed.append(msg)


def test_log_diffusion_images_through_the_attached_encoders(micro_model, tmp_path):
    """With a tokenizer, a text encoder and a VAE attached the callback samples the
    prompts through them and hands each decoded image (3, H, W) in [0, 1] to every
    logger under prompt[:100], as the JAX callback does; Tensorboard stores them, the
    JSONL logger drops them; without a VAE it logs the latents' spread."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    prompts = ["a red car " * 12, "a blue boat"]
    rec = RecordingLogger()
    tb = tcallbacks.TensorboardLogger(str(tmp_path / "tb"))
    jsonl = tcallbacks.JSONLLogger(str(tmp_path / "m.jsonl"))
    trainer = StubTrainer(micro_model, [rec, tb, jsonl])
    cb = tcallbacks.LogDiffusionImages(prompts=prompts, sampling_steps=2, seed=3)
    cb.eval_end(trainer, 0.5)
    tb.close()
    jsonl.close()
    want = micro_model.generate(prompt=prompts, guidance_scale=5.0, num_inference_steps=2,
                                seed=3).numpy()
    assert trainer.swaps == 1 and not trainer.printed and not rec.scalars
    assert [(n, s) for n, _, s in rec.images] == [(p[:100], 5) for p in prompts]
    for (_, img, _), ref in zip(rec.images, want):
        assert img.shape == (3, 8 * RES, 8 * RES) and np.array_equal(img, ref)
    acc = EventAccumulator(str(tmp_path / "tb"), size_guidance={"images": 0}).Reload()
    assert sorted(acc.Tags()["images"]) == sorted(p[:100] for p in prompts)
    assert (tmp_path / "m.jsonl").read_text() == ""

    trainer.loggers = [rec]
    vae = micro_model.vae
    micro_model.vae = None
    try:
        cb.eval_end(trainer, 0.5)
    finally:
        micro_model.vae = vae
    assert len(rec.images) == 2 and rec.scalars[0][0] == 5
    assert np.isfinite(rec.scalars[0][1]["images/latent_std"])
