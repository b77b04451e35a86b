"""The port's profiling helpers (micro_diffusion_tpu_torch/utils/profiling.py) on the
CPU: profile_trace writes a Chrome trace of the profiled block; StepTimer records one
time per stop and their mean; the span recorder keeps its records (nesting, units,
exceptions, the ring's bound), opens a profiler scope only under a profiler, and
records the trainer's and the sampler's phases."""

import json
import os
import time

import numpy as np
import pytest
import torch

from micro_diffusion_tpu_torch.utils import profiling
from micro_diffusion_tpu_torch.utils.profiling import StepTimer, profile_trace, span, spans


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profile_trace(str(tmp_path / "trace")) as prof:
        (a @ a).sum().item()
    assert os.listdir(tmp_path / "trace") == [os.path.basename(prof.trace_path)]
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_step_timer_records_each_stop():
    timer = StepTimer()
    assert timer.mean == 0.0
    dts = []
    for _ in range(3):
        timer.start()
        time.sleep(0.01)
        dts.append(timer.stop(torch.ones(8).sum()))
    timer.start()
    dts.append(timer.stop())  # no scalar: the current CUDA device, none here
    assert timer.times == dts and min(dts[:3]) >= 0.01
    assert abs(timer.mean - sum(dts) / 4) < 1e-12


def _since(first_id):
    return [s for s in spans() if s["id"] >= first_id]


def test_spans_nest_inherit_their_unit_and_flag_exceptions():
    with span("outer", unit=7) as outer:
        with span("inner", device=torch.device("cpu")) as inner:
            inner.tags = {"k": 1}
        with pytest.raises(KeyError):
            with span("failing", unit=8):
                raise KeyError("x")
    with span("top"):
        pass
    got = {s["name"]: s for s in _since(outer.id)}
    assert [s["name"] for s in _since(outer.id)] == ["inner", "failing", "outer", "top"]
    assert got["inner"]["parent"] == got["failing"]["parent"] == outer.id
    assert got["outer"]["parent"] is None and got["top"]["parent"] is None
    assert (got["inner"]["unit"], got["failing"]["unit"], got["top"]["unit"]) == (7, 8, None)
    assert got["failing"]["error"] and not got["outer"]["error"]
    assert got["inner"]["tags"] == {"k": 1}
    o, i = got["outer"], got["inner"]
    assert o["start_ms"] <= i["start_ms"] <= i["end_ms"] <= o["end_ms"]
    assert i["device_start_ms"] is None and i["device_end_ms"] is None  # no card
    assert outer.seconds == pytest.approx((o["end_ms"] - o["start_ms"]) * 1e-3)


def test_the_ring_keeps_the_newest_spans():
    with span("first") as first:
        pass
    for _ in range(profiling.RING_SPANS):
        with span("filler"):
            pass
    kept = spans()
    assert len(kept) == profiling.RING_SPANS and kept[0]["id"] > first.id
    assert kept[-1]["name"] == "filler"


def test_a_profiler_scope_only_under_a_profiler(tmp_path, monkeypatch):
    opened = []
    real = profiling.record_function

    def counting(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(profiling, "record_function", counting)
    with span("train.step"):
        pass
    assert opened == []
    with profile_trace(str(tmp_path)) as prof:
        with span("train.step", unit=0):
            with span("step.forward"):
                torch.ones(4).sum()
    assert opened == ["train.step", "step.forward"]
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("train.step") == names.count("step.forward") == 1


def _write_latents(dirname, n, res):
    from micro_diffusion_tpu_torch.datasets import MDSWriter

    rng = np.random.default_rng(0)
    with MDSWriter(out=str(dirname), columns={"caption_latents": "bytes",
                                              f"latents_{8 * res}": "bytes"}) as w:
        for _ in range(n):
            w.write({"caption_latents": rng.standard_normal((1, 77, 1024))
                     .astype(np.float16).tobytes(),
                     f"latents_{8 * res}": rng.standard_normal((4, res, res))
                     .astype(np.float16).tobytes()})


def test_trainer_fit_records_its_phases(tmp_path):
    """A Micro fit of 3 steps of 2 microbatches, with the host_cadence EMA, an eval
    at step 3 and the final save: each step's span and its parts, the trainer's
    phases, and ``data_wait_s`` the sum of the ``data.wait`` spans."""
    from micro_diffusion_tpu_torch.train import cli

    res = 8
    _write_latents(tmp_path / "ds", 8, res)
    ds = str(tmp_path / "ds")
    loader = "micro_diffusion_tpu.datasets.latents_loader.build_streaming_latents_dataloader"
    cfg = {
        "seed": 3,
        "model": {"_target_": "micro_diffusion_tpu.models.diffusion.create_latent_diffusion",
                  "text_encoder_name": "openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378",
                  "dit_arch": "MicroDiT_Micro_2", "dtype": "float32", "latent_res": res,
                  "train_mask_ratio": 0.5},
        "dataset": {"image_size": 8 * res, "train_batch_size": 4, "eval_batch_size": 4,
                    "train": {"_target_": loader, "datadir": ds, "drop_last": True},
                    "eval": {"_target_": loader, "datadir": ds, "drop_last": True}},
        "algorithms": {"ema": {"smoothing": 0.9, "placement": "host_cadence"}},
        "optimizer": {"lr": 1e-4},
        "scheduler": {"_target_": "composer.optim.ConstantScheduler"},
        "trainer": {"device": "cpu", "max_duration": "3ba", "eval_interval": "3ba",
                    "device_train_microbatch_size": 2, "metric_window": 1,
                    "save_folder": str(tmp_path / "ckpt")},
    }
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with span("marker") as marker:
            pass
        trainer = cli.build_from_config(cfg)
        trainer.fit()
    finally:
        torch.set_num_threads(threads)
    got = _since(marker.id + 1)
    steps = [s for s in got if s["name"] == "train.step"]
    assert [s["unit"] for s in steps] == [0, 1, 2] and not any(s["error"] for s in steps)
    for s in steps:
        parts = [c["name"] for c in got if c["parent"] == s["id"]]
        assert parts == ["step.forward", "step.backward", "step.accumulate"] * 2 + \
            ["step.update"], parts
        assert all(c["unit"] == s["unit"] for c in got if c["parent"] == s["id"])
    count = {n: sum(s["name"] == n for s in got) for n in profiling.SPAN_NAMES}
    assert count["trainer.ema"] == count["trainer.metrics"] == 3
    assert count["trainer.eval"] == count["trainer.save"] == 1  # at step 3; the final save
    assert count["trainer.stage"] == 3 and count["data.wait"] >= 3
    waits = [s for s in got if s["name"] == "data.wait"]
    assert trainer.data_wait_s == pytest.approx(
        sum(s["end_ms"] - s["start_ms"] for s in waits) * 1e-3)
    assert set(count) >= {s["name"] for s in got}  # every name is a contract name


def test_generate_records_its_parts(tmp_path):
    """Two tiny prompt -> image calls of 2 sampler steps: each call one sample.encode,
    3 sample.forward and one sample.decode under its own sample.call unit."""
    from micro_diffusion_tpu_torch.models.diffusion import create_latent_diffusion
    from micro_diffusion_tpu_torch.models.text_encoders import (UniversalTextEncoder,
                                                                UniversalTokenizer)
    from micro_diffusion_tpu_torch.models.vae import AutoencoderKL
    from micro_diffusion_tpu_torch.utils import clip_bpe

    clip = tmp_path / "clip"
    clip.mkdir()
    (clip / "config.json").write_text(json.dumps(dict(
        vocab_size=1000, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        max_position_embeddings=77, hidden_act="gelu")))
    prompts = ["a red cube", "two cats"]
    vocab = clip_bpe.write_bpe_vocab(prompts * 3, str(tmp_path / "tok"), num_merges=20)
    model = create_latent_diffusion(text_encoder_name=str(clip), dit_arch="MicroDiT_Micro_2",
                                    latent_res=4, dtype="float32", device="cpu")
    model.text_encoder = UniversalTextEncoder(str(clip), dtype="float32", pretrained=False,
                                              device="cpu")
    model.vae = AutoencoderKL(block_out_channels=(32, 32), layers_per_block=1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for module in (model.text_encoder, model.vae):
        for p in module.parameters():
            p.data.copy_(0.02 * torch.randn(p.shape, generator=gen))
    model.tokenizer = UniversalTokenizer(str(clip), vocab)
    with span("marker") as marker:
        pass
    for seed in (1, 2):
        images = model.generate(prompt=prompts, num_inference_steps=2, seed=seed)
        assert images.shape == (2, 3, 8, 8)
    got = _since(marker.id + 1)
    calls = [s for s in got if s["name"] == "sample.call"]
    assert len(calls) == 2 and calls[1]["unit"] == calls[0]["unit"] + 1
    for call in calls:
        parts = [s["name"] for s in got if s["parent"] == call["id"]]
        assert parts == ["sample.encode"] + ["sample.forward"] * 3 + ["sample.decode"]
        assert all(s["unit"] == call["unit"] for s in got if s["parent"] == call["id"])
