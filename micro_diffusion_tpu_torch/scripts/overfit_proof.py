"""The learning proof of the port, the counterpart of ``scripts/overfit_proof.py``.

Trains a small MicroDiT over a real horizon through the port's ``Trainer`` (AdamW
with warm-up and clipping, the EMA, a checkpoint at the half and an autoresume from
it in a fresh trainer) on a fixed fixture of two batches, and shows that

  1. the loss descends: the mean of the last fifth of the logged losses is below
     0.75 of the first fifth's, and the last third's below the first third's (the
     EDM loss draws a fresh sigma and noise every step, so windows, not points);
  2. the EMA's fixed-seed ``generate()`` moves: its latents at the end are more
     than 0.15 relative L2 away from the init's (the same sampler seed both times).

    python -m micro_diffusion_tpu_torch.scripts.overfit_proof --out rec.json \\
        [--steps 1000] [--model MicroDiT_Micro_2|MicroDiT_Tiny_2] \\
        [--dtype float32|bfloat16] [--device cuda|cpu] [--workdir DIR]

The setup and the pass rule are the JAX script's (``scripts/overfit_proof.py``
:42-85, :139-158): 2 batches of 8 latents (4 x 32 x 32, 0.9 x a normal draw) with
1 x 8 x 64 caption latents, mask ratio 0, latent scale 1; lr 1e-3 after 20 warm-up
steps, weight decay 0.01, clip norm 1.0, EMA 0.99 from step 50, the loss logged
every 5 steps; ``generate()`` of 4 fixed caption latents, 12 steps, guidance 2.0,
seed 11. The draws come from numpy generators with fixed seeds (JAX's keys cannot
be reproduced in torch). ``--model`` is this script's own: at Micro's widths the
EC-MoE kernel's shape rule (ops/moe_ffn.py ``supported``: d % 128) sends every block
to the plain path, Tiny's (d 512) to the kernels K2 / K2b.

Writes the JAX record's keys to ``--out`` and exits 1 when the rule fails. The
device is the card unless ``--device cpu``; without a card the run raises.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MODELS = ("MicroDiT_Micro_2", "MicroDiT_Tiny_2")
LATENT_RES, CAPTION_CHANNELS, CAPTION_TOKENS = 32, 64, 8
N_BATCHES, BATCH = 2, 8
SEED = 7               # the model's init and the trainer's step generators
METRIC_WINDOW = 5      # a loss row every 5 steps
GEN_CAPTIONS, GEN_STEPS, GEN_GUIDANCE, GEN_SEED = 4, 12, 2.0, 11
FIRST_LAST_RATIO, MIN_GENERATE_CHANGE = 0.75, 0.15


def fixture_batches(n_batches: int = N_BATCHES, batch: int = BATCH) -> list:
    """The fixed fixture: ``n_batches`` numpy batches of ``batch`` samples, each
    with its own caption latents, cycled every epoch."""
    batches = []
    for i in range(n_batches):
        rng = np.random.default_rng(1000 + i)
        batches.append({
            "image_latents": 0.9 * rng.standard_normal(
                (batch, 4, LATENT_RES, LATENT_RES), np.float32),
            "caption_latents": rng.standard_normal(
                (batch, 1, CAPTION_TOKENS, CAPTION_CHANNELS), np.float32),
            "drop_caption_mask": np.ones((batch,), np.float32),
        })
    return batches


def caption_embeddings() -> np.ndarray:
    """The fixed caption latents of the ``generate()`` probe."""
    return np.random.default_rng(42).standard_normal(
        (GEN_CAPTIONS, 1, CAPTION_TOKENS, CAPTION_CHANNELS), np.float32)


def build_model(model_name: str, dtype: torch.dtype, device: torch.device):
    from ..models import dit as model_zoo
    from ..models.diffusion import LatentDiffusion

    dit = getattr(model_zoo, model_name)(caption_channels=CAPTION_CHANNELS, dtype=dtype,
                                         device=device)
    dit.init_weights(torch.Generator(device=device).manual_seed(SEED))
    return LatentDiffusion(dit, latent_res=LATENT_RES, train_mask_ratio=0.0,
                           latent_scale=1.0)


def build_trainer(model, batches, max_steps: int, save_folder: str, metrics_path: str,
                  autoresume: bool = False):
    from ..train.callbacks import JSONLLogger
    from ..train.trainer import Trainer

    return Trainer(
        model=model,
        optimizer={"lr": 1e-3, "weight_decay": 0.01},
        schedulers={"_target_": "composer.optim.ConstantWithWarmupScheduler",
                    "t_warmup": "20ba"},
        train_dataloader=batches,
        max_duration=f"{max_steps}ba",
        device_train_microbatch_size=None,
        seed=SEED,
        ema={"smoothing": 0.99, "ema_start": 50, "update_interval": 1},
        algorithms={"gradient_clipping": {"clipping_type": "norm", "clip_norm": 1.0}},
        save_folder=save_folder,
        save_interval=f"{max_steps}ba",
        loggers=[JSONLLogger(metrics_path)],
        metric_window=METRIC_WINDOW,
        autoresume=autoresume,
    )


def ema_generate(trainer, emb: np.ndarray) -> np.ndarray:
    """The fixed-seed ``generate()`` latents of the trainer's EMA weights."""
    with trainer.eval_weights():
        out = trainer.model.generate(text_embeddings=torch.from_numpy(emb),
                                     guidance_scale=GEN_GUIDANCE,
                                     num_inference_steps=GEN_STEPS, seed=GEN_SEED,
                                     return_only_latents=True)
    return out.float().cpu().numpy()


def windows(vals) -> dict:
    """The pass rule's windows of the logged losses (JAX overfit_proof.py:139-148):
    the first and last fifths (at least 2 rows each) and the thirds."""
    n = len(vals)
    w = max(2, n // 5)
    thirds = [float(np.mean(vals[i * n // 3:(i + 1) * n // 3])) for i in range(3)]
    return {"first": float(np.mean(vals[:w])), "last": float(np.mean(vals[-w:])),
            "thirds": thirds}


def passes(first: float, last: float, thirds, rel: float) -> bool:
    return bool(last < FIRST_LAST_RATIO * first and thirds[2] < thirds[0]
                and rel > MIN_GENERATE_CHANGE)


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if device.type != "cuda":
        return device.type
    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = ""
    return f"{name}, {limit or 'power limit not read'}"


def resolve(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    return dev


def run(steps: int, model_name: str = MODELS[0], dtype: str = "float32",
        device: str = "cuda", workdir: str | None = None, log=print) -> dict:
    """Train ``steps`` steps (a fresh trainer autoresumes at the half) and return
    the record; the checkpoints and the metrics go under ``workdir`` (a temporary
    directory when None)."""
    if model_name not in MODELS:
        raise ValueError(f"model {model_name!r}: one of {MODELS}")
    torch_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    dev = resolve(device)
    with tempfile.TemporaryDirectory(prefix="overfit_proof_") as tmp:
        workdir = workdir or tmp
        os.makedirs(workdir, exist_ok=True)
        metrics_path = os.path.join(workdir, "metrics.jsonl")
        if os.path.exists(metrics_path):
            os.remove(metrics_path)
        save_folder = os.path.join(workdir, "ckpts")
        batches = fixture_batches()
        emb = caption_embeddings()
        half = steps // 2

        t0 = time.perf_counter()
        trainer = build_trainer(build_model(model_name, torch_dtype, dev), batches, half,
                                save_folder, metrics_path)
        if trainer.global_step:
            raise RuntimeError(f"{save_folder} already holds a checkpoint: use an empty "
                               "--workdir")
        gen_init = ema_generate(trainer, emb)
        trainer.fit()
        trainer.close()
        # a fresh trainer on a fresh model resumes from the half-way checkpoint
        trainer = build_trainer(build_model(model_name, torch_dtype, dev), batches, steps,
                                save_folder, metrics_path, autoresume=True)
        resumed_at = trainer.global_step
        if resumed_at != half:
            raise RuntimeError(f"the fresh trainer resumed at step {resumed_at}, not {half}")
        trainer.fit()
        trainer.close()
        gen_final = ema_generate(trainer, emb)
        wall = time.perf_counter() - t0

        with open(metrics_path) as f:
            rows = [json.loads(line) for line in f]
    losses = [(r["step"], r["loss/train/total"]) for r in rows if "loss/train/total" in r]
    steps_l, vals = zip(*losses)
    win = windows(vals)
    rel = float(np.linalg.norm(gen_final - gen_init) / np.linalg.norm(gen_init))
    rec = {
        "model": f"{model_name} ({dtype})",
        "path": "Trainer (optimizer+EMA+checkpoint, autoresume mid-run)",
        "steps": steps,
        "resume_at": resumed_at,
        "wall_s": round(wall, 1),
        "loss_first_window": round(win["first"], 4),
        "loss_last_window": round(win["last"], 4),
        "loss_thirds": [round(t, 4) for t in win["thirds"]],
        "loss_curve": [[int(s), round(float(v), 4)] for s, v in zip(steps_l, vals)],
        "generate_rel_change_vs_init": round(rel, 4),
        "device": device_name(dev),
        "pass": passes(win["first"], win["last"], win["thirds"], rel),
    }
    log(f"{model_name} ({dtype}): loss {win['first']:.4f} -> {win['last']:.4f} (thirds "
        f"{', '.join(f'{t:.4f}' for t in win['thirds'])}); generate rel-change {rel:.4f}; "
        f"pass={rec['pass']} ({wall:.1f} s)")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="where the JSON record is written")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--model", default=MODELS[0], choices=MODELS)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="the DiT's compute dtype (bfloat16 is the card's recipe path)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a "
                    "card) or cpu")
    ap.add_argument("--workdir", default=None, help="checkpoints and metrics (default: a "
                    "temporary directory, removed at the end)")
    args = ap.parse_args(argv)
    rec = run(args.steps, args.model, args.dtype, args.device, args.workdir,
              log=lambda m: print(m, file=sys.stderr, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr, flush=True)
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
