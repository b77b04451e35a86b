"""The runner of sampling traffic: a closed loop of prompt -> image calls,
``LatentDiffusion.generate(prompt=[...])``, as the FID-30K job makes them.

Set-up: the DiT is built from the stage's recipe and H100 overlay (the model block
the trainer builds), the CLIP text tower and the VAE from the configuration's sizes,
and all three are filled with the benchmark's seeded weights; the tokenizer reads a
BPE vocabulary learned from the mix's caption pool. One call of the window's batch
with ``warmup_steps`` sampler steps warms every shape.

Window: from a synchronised point, whole calls, each of ``prompts`` captions drawn
by the seed from the pool, ``steps`` EDM Heun steps at guidance ``guidance``, the
images brought to the host; the fewest calls whose time reaches ``--seconds``. The
rate is all the window's images over all its time. With ``--trace 1`` one more call
runs under ``torch.profiler``.

Check: in each window call the sampler's states of ``check_per_call`` images are
kept (``Recorder``), at batch positions taken in turn from one order that the seed
draws, so that the window's calls check every position between them; once the
program is freed, the plain reference (reference/dit.py, edm.py, encoders.py, bpe.py)
follows them from the same prompts: the start against the call's noise, every guided
denoiser output against the reference's at the same state, each state against the
Heun update of the ones before (in float64), the image against the reference's decode
of the final latents. A whole trajectory compared end to end separates bf16 from an
fp8 control by less than 3x (the ODE spreads both errors alike); the denoiser's gap at
the recorded states separates them.
"""

import gc
import json
import os
import time

import numpy as np
import torch

from benchmark import checks, harness, inputs
from benchmark.reference import bpe, edm
from benchmark.reference.dit import MicroDiT
from benchmark.reference.encoders import VAE, CLIPText
from benchmark.reference.precision import no_tf32
from benchmark.work import flops

TRACE_SCOPE = "benchmark.traced_window"
SEEDS = {"dit": 2, "text": 3, "vae": 4}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def text_encoder_dir(t: dict, root: str) -> str:
    """A local CLIP text snapshot's config.json with the configuration's sizes (the
    port reads the architecture from it)."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"vocab_size": t["vocab"], "hidden_size": t["width"],
                   "num_hidden_layers": t["layers"], "num_attention_heads": t["heads"],
                   "max_position_embeddings": t["context"],
                   "hidden_act": "quick_gelu" if t["quick_gelu"] else "gelu"}, f)
    return root


def build_program(cell, vocab_dir):
    """The port's LatentDiffusion with its text encoder, VAE and tokenizer attached,
    every weight the benchmark's."""
    from micro_diffusion_tpu_torch.models.text_encoders import (UniversalTextEncoder,
                                                                UniversalTokenizer)
    from micro_diffusion_tpu_torch.models.vae import AutoencoderKL
    from micro_diffusion_tpu_torch.train.config import instantiate, load_config

    cfg, dev = cell.config, cell.device
    r, t, v = cfg["recipe"], cfg["sample"]["text_encoder"], cfg["sample"]["vae"]
    recipe = load_config(os.path.join(harness.ROOT, r["config_path"]), r["config_name"],
                         r.get("overrides", []))
    model = instantiate(recipe["model"], device=dev, seed=0)
    name = t.get("name") or text_encoder_dir(t, os.path.join(cell.tmpdir, "text_encoder"))
    model.text_encoder = UniversalTextEncoder(name, dtype=t["dtype"], pretrained=False,
                                              device=dev)
    model.vae = AutoencoderKL(block_out_channels=v["channels"], layers_per_block=v["layers"],
                              latent_channels=v["latent_channels"],
                              scaling_factor=v["scaling_factor"],
                              compute_dtype=getattr(torch, v["dtype"]), device=dev)
    model.tokenizer = UniversalTokenizer(name, vocab_dir)
    for part, module in (("dit", model.dit), ("text", model.text_encoder.model),
                         ("vae", model.vae)):
        inputs.fill_weights(dict(module.named_parameters()), inputs.sub_seed(cell.seed,
                                                                             SEEDS[part]))
    return model


def _plant(model, fault):
    """The tests' faults under the timed path: 'unchanged', a sampler whose every step
    returns its state as it found it (the denoiser returns its input); 'altered',
    images changed where they are produced (mirrored)."""
    if fault == "unchanged":
        model.model_forward_wrapper = lambda x, sigma, y, cfg=1.0, **kw: {"sample": x}
    elif fault == "altered":
        decode = model.decode_latents
        model.decode_latents = lambda latents: torch.flip(decode(latents), dims=[-1])


class Recorder:
    """Wraps the model's guided denoiser (``model_forward_wrapper``, which the sampler
    calls 2 * steps - 1 times a call) and keeps, for the rows to check of the current
    call, each call's input and output (the sampler's state and the denoised
    estimate), on the device, in float32."""

    def __init__(self, model):
        self.rows, self.calls = None, []
        denoise = model.model_forward_wrapper

        def recording(x, sigma, y, cfg=1.0, **kw):
            out = denoise(x, sigma, y, cfg=cfg, **kw)
            if self.rows is not None:
                self.calls.append((x[self.rows].float(), out["sample"][self.rows].float()))
            return out
        model.model_forward_wrapper = recording

    def start(self, rows, device):
        self.rows, self.calls = torch.tensor(rows, device=device), []

    def stop(self):
        calls, self.rows, self.calls = self.calls, None, []
        return calls


def run(cell):
    p, cfg, dev = cell.params, cell.config, cell.device
    cuda = torch.device(dev).type == "cuda"
    harness.build_kernels(dev)
    pool = inputs.captions(os.path.join(harness.BENCH, "traffic", p["captions"]))
    vocab_dir = bpe.write_bpe_vocab(pool, os.path.join(cell.tmpdir, "vocab"),
                                    num_merges=p["bpe_merges"])
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    model = build_program(cell, vocab_dir)
    if cell.fault:
        _plant(model, cell.fault)
    recorder = Recorder(model)
    k, steps, guidance = p["prompts"], p["steps"], p["guidance"]

    def call(i, n_steps, rows=None):
        """Generate call ``i``; with ``rows``, those images' sampler states kept."""
        prompts = inputs.draw_prompts(cell.seed, i, pool, k)
        seed = inputs.sub_seed(cell.seed, 5, i)
        if rows is not None:
            recorder.start(rows, dev)
        images = model.generate(prompt=prompts, guidance_scale=guidance,
                                num_inference_steps=n_steps, seed=seed)
        images = images.float().cpu().numpy()
        return {"prompts": prompts, "seed": seed, "rows": rows, "images": images,
                "calls": recorder.stop() if rows is not None else None}

    call(0, p["warmup_steps"])  # the window's calls are 1, 2, ...
    _sync(dev)
    setup_end = time.perf_counter()
    path = p.get("path", {})
    counters = path.get("present", []) + path.get("absent", [])
    launches0 = harness.launch_counts(counters)
    done, ends = [], [setup_end]
    while True:
        i = len(done) + 1
        done.append(call(i, steps, check_rows(cell.seed, i, k, p["check_per_call"])))
        ends.append(time.perf_counter())
        elapsed = ends[-1] - setup_end
        if elapsed >= cell.seconds:
            break
    images = len(done) * k
    launches = {n: c - launches0[n] for n, c in harness.launch_counts(counters).items()}
    out = {"e2e": {"sample_img_per_s": images / elapsed, "setup_s": setup_end - cell.t0},
           "attempted": images, "log": {"call_s": [round(float(c), 4) for c in np.diff(ends)]},
           "failed": sum(int(not np.isfinite(c["images"]).all()) for c in done)}
    if cell.trace:
        prof = torch.profiler.profile(activities=_activities(dev))
        prof.start()
        with torch.profiler.record_function(TRACE_SCOPE):
            call(len(done) + 1, steps)
            _sync(dev)
        prof.stop()
        trace_file = os.path.join(cell.tmpdir, "trace.json")
        prof.export_chrome_trace(trace_file)
        del prof
        out["record"], out["trace"] = _record(cell, trace_file, images / elapsed,
                                              {"units": len(done), "seconds": elapsed})
    out["peak"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del model, recorder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    items = [{"prompt": c["prompts"][r], "seed": c["seed"], "row": r,
              "xs": [x[j] for x, _ in c["calls"]], "ds": [d[j] for _, d in c["calls"]],
              "image": c["images"][r]}
             for c in done for j, r in enumerate(c["rows"])]
    numbers = reference_check(cell, vocab_dir, items)
    if cuda:
        numbers["path"] = checks.path_violations(launches, path)
    out["checks"], out["readings"] = checks.with_limits(numbers, cell.workload["limits"])
    return out


def check_rows(seed: int, call: int, k: int, n: int) -> list:
    """The ``n`` batch positions of ``k`` that window call ``call`` (1, 2, ...) checks:
    the next ``n`` of one order drawn from the seed, taken in turn."""
    order = np.random.default_rng((seed, 11)).permutation(k)
    return sorted(int(order[((call - 1) * n + j) % k]) for j in range(n))


def reference_models(cell, precision="fp32"):
    """The plain DiT, CLIP text tower and VAE with the run's weights (the DiT's and the
    VAE's products in ``precision``; the text tower's in float32)."""
    cfg = cell.config
    m, t, v = cfg["model"], cfg["sample"]["text_encoder"], cfg["sample"]["vae"]
    with torch.device(cell.device):
        dit, text, vae = MicroDiT(m, precision), CLIPText(t), VAE(v, precision)
    for part, module in (("dit", dit), ("text", text), ("vae", vae)):
        inputs.fill_weights(dict(module.named_parameters()),
                            inputs.sub_seed(cell.seed, SEEDS[part]))
    return dit, text, vae


def trajectory_numbers(cell, items) -> tuple:
    """({'start', 'heun'}, the final latents) of ``items`` (see ``reference_check``):
    the first state against the call's noise at sigma_max, and each state against the
    Heun update of the ones before, both in float64, relative to the state's largest
    magnitude."""
    p, m, dev = cell.params, cell.config["model"], cell.device
    shape = (p["prompts"], m["in_channels"], m["latent_res"], m["latent_res"])
    t0 = edm.sampler_steps(p["steps"])[0]
    start = heun = 0.0
    finals = []
    for it in items:
        gen = torch.Generator(device=dev).manual_seed(it["seed"])
        noise = torch.randn(shape, generator=gen, device=dev)[it["row"]]
        start = max(start, edm.relative_gap(it["xs"][0].double(), noise.double() * t0))
        gap, final = edm.heun_replay(it["xs"], it["ds"], p["steps"])
        heun = max(heun, gap)
        finals.append(final)
    return {"start": start, "heun": heun}, finals


REF_BLOCK = 16  # images a reference forward takes at once


def reference_check(cell, vocab_dir, items):
    """The numbers of checks.py's sampling rows for ``items`` (an image each: its
    prompt, its call's generate seed, its row, the sampler's recorded denoiser inputs
    ``xs`` and outputs ``ds``, the image): the reference follows the sampler from its
    own recorded states, and checks the start and the update it skips by themselves."""
    p, cfg, dev = cell.params, cell.config, cell.device
    t = cfg["sample"]["text_encoder"]
    steps, n = p["steps"], len(items)
    with no_tf32(), torch.no_grad():
        numbers, finals = trajectory_numbers(cell, items)
        dit, text, vae = reference_models(cell)
        tok = bpe.CLIPBPETokenizer(vocab_dir)
        ids = tok([it["prompt"] for it in items], max_length=t["context"])["input_ids"]
        y = text(torch.from_numpy(ids).to(dev))
        _, plan = edm.sampler_steps(steps)
        sigmas = [s for tc, tn, _ in plan for s in (tc, tn)][:2 * steps - 1]
        err, ref = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        for lo in range(0, n, REF_BLOCK):
            hi = min(n, lo + REF_BLOCK)
            y2 = torch.cat([y[lo:hi], torch.zeros_like(y[lo:hi])])
            for j, sigma in enumerate(sigmas):
                x = torch.stack([it["xs"][j] for it in items[lo:hi]])
                want = edm.guided(dit, x, sigma, y2, p["guidance"])
                got = torch.stack([it["ds"][j] for it in items[lo:hi]])
                err[lo:hi] += (got - want).flatten(1).square().sum(1)
                ref[lo:hi] += want.flatten(1).square().sum(1)
        decoded = torch.cat([vae.decode_images(torch.stack(finals[lo:lo + REF_BLOCK]))
                             for lo in range(0, n, REF_BLOCK)]).cpu().numpy()
    return {**numbers, "denoise": float((err / ref).sqrt().max()),
            "decode": checks.image_gap([it["image"] for it in items], list(decoded))}


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _record(cell, path, rate, window):
    from benchmark import trace

    p, m = cell.params, cell.config["model"]
    summary = trace.summarize(trace.load(path), TRACE_SCOPE)
    forwards = 2 * p["steps"] - 1
    rows = 2 * p["prompts"]
    work = flops.function_work(m, rows, 0.0, train=False)
    record = {"kind": "sample", "chips": 1, "images_per_s": rate,
              "model_flops_per_image": 2 * forwards * flops.model_flops(m),
              "least_s": {fn: work[fn][2] * forwards for fn in work},
              "kernels": harness.kernel_tables(), "trace": summary, "window": window,
              "traced_units": 1}
    return record, summary
