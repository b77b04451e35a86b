"""The port's training entry point (slice 3) against the JAX package's: the MDS
latents loader batch for batch, the recipe configs and the H100 overlays, the
whole ``Trainer.fit`` for 3 steps against the JAX ``Trainer.fit`` on the same
dataset, and the port's checkpointing (resume, weights-only load, the EMA stage
transition, reference .pt weights), the options it refuses and those it took last.

Everything runs on the CPU in fp32 at Micro size (``trainer.device=cpu``).
"""

import copy
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.datasets import latents_loader as jloader
from micro_diffusion_tpu.train import callbacks as jcallbacks
from micro_diffusion_tpu.train import config as jconfig
from micro_diffusion_tpu.train import trainer as jtrainer_module
from micro_diffusion_tpu_torch.datasets import MDSWriter
from micro_diffusion_tpu_torch.datasets import latents_loader as tloader
from micro_diffusion_tpu_torch.models import interop as tinterop
from micro_diffusion_tpu_torch.ops import masking as tmasking
from micro_diffusion_tpu_torch.train import callbacks as tcallbacks
from micro_diffusion_tpu_torch.train import cli, trainer as ttrainer
from micro_diffusion_tpu_torch.train import config as tconfig

from test_torch_adaln import jax_mask
from test_torch_dit import rand
from train import build_from_config as jax_build_from_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERLAYS = os.path.join(ROOT, "micro_diffusion_tpu_torch", "configs", "h100_1gpu")
STAGES = ("res_256_pretrain", "res_256_finetune", "res_512_pretrain", "res_512_finetune")
RES = 16  # latent resolution (image_size 128): 64 tokens, 16 kept at mask 0.75


def write_latents(dirname, n, seed=0):
    rng = np.random.default_rng(seed)
    with MDSWriter(out=str(dirname), columns={"caption_latents": "bytes",
                                              "latents_128": "bytes"}) as w:
        for _ in range(n):
            w.write({"caption_latents": rng.standard_normal((1, 77, 1024))
                     .astype(np.float16).tobytes(),
                     "latents_128": (0.5 * rng.standard_normal((4, RES, RES)))
                     .astype(np.float16).tobytes()})


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("latents") / "ds"
    write_latents(d, 48)
    return str(d)


def make_config(datadir, **trainer):
    """A stage-1-style recipe at Micro size, written with the JAX package's
    targets (the port re-points them)."""
    return {
        "seed": 18,
        "algorithms": {"gradient_clipping": {"clipping_type": "norm", "clip_norm": 0.25}},
        "model": {
            "_target_": "micro_diffusion_tpu.models.diffusion.create_latent_diffusion",
            "vae_name": "stabilityai/stable-diffusion-xl-base-1.0",
            "text_encoder_name": "openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378",
            "dit_arch": "MicroDiT_Micro_2", "precomputed_latents": True, "in_channels": 4,
            "pos_interp_scale": 1.0, "dtype": "float32", "latent_res": RES,
            "p_mean": -0.6, "p_std": 1.2, "train_mask_ratio": 0.75,
        },
        "dataset": {
            "image_size": 8 * RES, "train_batch_size": 16, "eval_batch_size": 16,
            "cap_drop_prob": 0.1,
            "train": {"_target_": "micro_diffusion_tpu.datasets.latents_loader."
                                  "build_streaming_latents_dataloader",
                      "datadir": datadir, "drop_last": True, "shuffle": True},
        },
        "optimizer": {"_target_": "torch.optim.AdamW", "lr": 1e-4, "weight_decay": 0.1,
                      "eps": 1e-8, "betas": [0.9, 0.999]},
        "scheduler": {"_target_": "composer.optim.CosineAnnealingWithWarmupScheduler",
                      "t_warmup": "2ba", "alpha_f": 0.33},
        "trainer": {"_target_": "composer.Trainer", "device": "cpu", "max_duration": "3ba",
                    "device_train_microbatch_size": 8, "run_name": "test", "seed": 18,
                    "metric_window": 1, **trainer},
    }


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These models are Micro-sized: intra-op threads buy nothing, and in a parallel
    test run the threads of several workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ loader


@pytest.mark.parametrize("shuffle_algo", ["full", "block"])
def test_loader_matches_jax(tmp_path, shuffle_algo):
    """Bit-identical batches for the same seed: across an epoch boundary (10
    samples, batch 4, drop_last: 2 steps per epoch) and after state_dict ->
    load_state_dict into a fresh loader. The JAX reader reads the port's shards."""
    write_latents(tmp_path / "ds", 10, seed=3)
    kw = dict(datadir=str(tmp_path / "ds"), batch_size=4, image_size=8 * RES,
              cap_drop_prob=0.5, seed=7, shuffle_algo=shuffle_algo, shuffle_block_size=4)
    j, t = jloader.build_streaming_latents_dataloader(**kw), \
        tloader.build_streaming_latents_dataloader(**kw)

    def take(loader, n):
        it = iter(loader)
        out = [next(it) for _ in range(n)]
        it.close()
        return out

    for bj, bt in zip(take(j, 5), take(t, 5)):
        assert bj.keys() == bt.keys()
        for k in bj:
            assert bj[k].dtype == bt[k].dtype and np.array_equal(bj[k], bt[k]), k
    j2, t2 = jloader.build_streaming_latents_dataloader(**kw), \
        tloader.build_streaming_latents_dataloader(**kw)
    j2.load_state_dict(j.state_dict())
    t2.load_state_dict(t.state_dict())
    assert j.state_dict() == t.state_dict() == {"epoch": 2, "step_in_epoch": 1}
    for bj, bt in zip(take(j2, 3), take(t2, 3)):
        for k in bj:
            assert np.array_equal(bj[k], bt[k]), k


def test_loader_iterated_again_resumes_where_the_consumer_stopped(tmp_path):
    """Two batches taken, the iterator closed (its thread had prefetched further),
    then a new iterator: it yields step 3, the batch a fresh loader yields third,
    not the first batch after the prefetched ones."""
    write_latents(tmp_path / "ds", 48, seed=4)
    kw = dict(datadir=str(tmp_path / "ds"), batch_size=4, image_size=8 * RES, seed=7,
              prefetch_factor=2)
    loader = tloader.build_streaming_latents_dataloader(**kw)
    it = iter(loader)
    first = [next(it) for _ in range(2)]
    it.close()
    assert loader.state_dict() == {"epoch": 0, "step_in_epoch": 2}
    it = iter(loader)
    third = next(it)
    it.close()
    assert loader.state_dict() == {"epoch": 0, "step_in_epoch": 3}
    fresh = iter(tloader.build_streaming_latents_dataloader(**kw))
    expected = [next(fresh) for _ in range(3)]
    fresh.close()
    for got, want in zip(first + [third], expected):
        for k in want:
            assert np.array_equal(got[k], want[k]), k


# ------------------------------------------------------------------ configs


def _targets(node):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "_target_":
                yield v
            else:
                yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


def test_recipes_and_overlays_load():
    """The four recipes load to the JAX loader's dicts; the four H100 overlays carry
    the per-rank batch 256, the reference's microbatches, fused adaLN, remat 'full'
    (the overlays' one rule; their comments give the card's numbers), the 'gather'
    dispatch at 512px, and the card; every _target_ resolves to a port callable;
    others raise."""
    microbatches = dict(zip(STAGES, (256, 64, 32, 16)))
    policies = dict(zip(STAGES, ("full", "full", "full", "full")))
    dispatch = dict(zip(STAGES, ("onehot", "onehot", "gather", "gather")))
    for stage in STAGES:
        cfg = tconfig.load_config(os.path.join(ROOT, "configs"), stage)
        assert cfg == jconfig.load_config(os.path.join(ROOT, "configs"), stage)
        over = tconfig.load_config(OVERLAYS, stage)
        assert over["exp_name"] == cfg["exp_name"]
        assert over["dataset"]["train_batch_size"] == 256
        assert over["trainer"]["device_train_microbatch_size"] == microbatches[stage]
        assert over["trainer"]["device"] == "cuda"
        assert over["model"]["fused_adaln"] is True
        assert over["model"]["remat"] is True
        assert over["model"]["remat_policy"] == policies[stage]
        assert over["model"]["moe_dispatch"] == dispatch[stage]
        for target in set(_targets(over)) | set(_targets(cfg)):
            fn = tconfig.resolve_target(target)
            assert callable(fn) and fn.__module__.startswith("micro_diffusion_tpu_torch."), \
                target
        # the overlay's model block builds as written (on the meta device: no weights)
        model = tconfig.instantiate(over["model"], device="meta")
        assert model.dit.remat_policy == policies[stage]
        assert model.latent_res == over["model"]["latent_res"]
        assert model.dit.blocks[1].mlp.dispatch == dispatch[stage]
        assert model.dit.blocks[0].norm1.fused_adaln
    # a JAX target resolves to the port's module of the same name once it is ported
    # (the VAE since slice 6, the CLIP vision tower since slice 7, the profiling
    # helpers since slice 8, the parallel layer since slice 9, the native MDS gather
    # since slice 10, the host-EMA classes and split-dispatch steps since slice 12), and
    # raises while it is not (utils/platform.py, which the port does not port:
    # README.md, 'Not ported')
    from micro_diffusion_tpu_torch.datasets.native import gather
    from micro_diffusion_tpu_torch.models.clip_zero_shot import CLIPVisionTransformer
    from micro_diffusion_tpu_torch.models.vae import AutoencoderKL
    from micro_diffusion_tpu_torch.parallel.mesh import make_mesh
    from micro_diffusion_tpu_torch.utils.profiling import StepTimer
    assert tconfig.resolve_target("micro_diffusion_tpu.models.vae.AutoencoderKL") \
        is AutoencoderKL
    assert tconfig.resolve_target(
        "micro_diffusion_tpu.models.clip_zero_shot.CLIPVisionTransformer") \
        is CLIPVisionTransformer
    assert tconfig.resolve_target("micro_diffusion_tpu.utils.profiling.StepTimer") \
        is StepTimer
    assert tconfig.resolve_target("micro_diffusion_tpu.parallel.mesh.make_mesh") is make_mesh
    assert tconfig.resolve_target("micro_diffusion_tpu.datasets.native.gather") is gather
    from micro_diffusion_tpu_torch import train as ttrain_pkg
    for name in ("HostEMA", "AsyncHostEMA", "HostComputeEMA", "make_grad_step",
                 "make_apply_step", "make_ema_step"):  # since slice 12
        assert tconfig.resolve_target(f"micro_diffusion_tpu.train.{name}") \
            is getattr(ttrain_pkg, name)
    for bad in ("os.system",
                "micro_diffusion_tpu.utils.platform.apply_platform_override",
                "micro_diffusion_tpu.train.trainer.NoSuchThing"):
        with pytest.raises(ValueError, match="no counterpart"):
            tconfig.resolve_target(bad)


def test_overlays_resolve_without_jax():
    """In a fresh process: load every overlay, resolve every target, import the
    entry point; no jax and nothing of micro_diffusion_tpu is imported."""
    code = (
        "import sys\n"
        "from micro_diffusion_tpu_torch.train import cli, config\n"
        "import micro_diffusion_tpu_torch.train.__main__\n"
        f"for stage in {STAGES!r}:\n"
        f"    cfg = config.load_config({OVERLAYS!r}, stage)\n"
        "    stack = [cfg]\n"
        "    while stack:\n"
        "        node = stack.pop()\n"
        "        if isinstance(node, dict):\n"
        "            if '_target_' in node:\n"
        "                config.resolve_target(node['_target_'])\n"
        "            stack.extend(node.values())\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'flax', 'micro_diffusion_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)


def test_entry_point_needs_the_card_unless_asked(dataset_dir, tmp_path, monkeypatch):
    """The overlays say trainer.device=cuda: without a card the entry point raises
    (never falls back to the CPU); --multihost raises without torchrun's
    environment and, on cuda, without a card; a TPU device raises."""
    assert not torch.cuda.is_available()
    base = ["--config-path", OVERLAYS, "--config-name", "res_256_pretrain"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(base + ["model.dit_arch=MicroDiT_Micro_2"])
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["--multihost"] + base)
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", "29500")):
        monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(base)  # a set WORLD_SIZE joins the group as --multihost does
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        cli.main(["--config-path", os.path.join(ROOT, "configs"), "--config-name",
                  "res_256_pretrain"])  # the recipe's own trainer.device: tpu


# ------------------------------------------------------------------ the slice


class _Collect:
    """A callback for either trainer: the host metrics of every window."""

    def __init__(self):
        self.rows = []

    def fit_start(self, trainer):
        pass

    def step_end(self, trainer, metrics):
        self.rows.append({k: float(v) for k, v in metrics.items()})

    def eval_end(self, trainer, eval_loss):
        pass

    def fit_end(self, trainer):
        pass


def _fit_parity(cfg, monkeypatch, mask_ratio, res=RES):
    """Trainer.fit of ``cfg`` in both frameworks on the same dataset, the port from
    the JAX trainer's initial params and with its per-step draws; returns both
    trainers, the per-window host metrics of each, and the JAX final params and EMA
    (its ``eval_params``, wherever the placement keeps it) under the port's names."""
    # the JAX trainer on one device, as the port's (tests/conftest.py makes 8 CPU devices)
    make_mesh = jtrainer_module.make_mesh
    monkeypatch.setattr(jtrainer_module, "make_mesh", lambda data=None, fsdp=1, tensor=1:
                        make_mesh(data=1, devices=jax.devices()[:1]))
    jtrainer = jax_build_from_config(copy.deepcopy(cfg))
    init = jax.tree.map(np.asarray, jtrainer.state.params)
    jcollect = _Collect()
    jtrainer.callbacks.append(jcollect)
    jtrainer.fit()
    to_torch = lambda tree: tinterop.params_to_torch_state_dict(jax.tree.map(np.asarray, tree))
    jfinal = to_torch(jtrainer.state.params)
    jema = to_torch(jtrainer.eval_params()) if jtrainer.ema_cfg is not None else None

    ptrainer = cli.build_from_config(copy.deepcopy(cfg))
    tinterop.load_jax_params(ptrainer.model.dit, init)
    if ptrainer.state.ema_params is not None:
        ptrainer._mirror_ema()  # the EMA starts as a copy of the initial params
    tcollect = _Collect()
    ptrainer.callbacks.append(tcollect)
    dit, mb = jtrainer.model.dit, cfg["trainer"]["device_train_microbatch_size"]
    k = cfg["dataset"]["train_batch_size"] // mb

    @jax.jit
    def jax_draws(step):
        rng = jax.random.fold_in(jax.random.PRNGKey(cfg["seed"]), step)
        out = []
        for i in range(k):
            r_sigma, r_noise, r_mask = jax.random.split(jax.random.fold_in(rng, i), 3)
            out.append((jax.random.normal(r_sigma, (mb, 1, 1, 1)),
                        jax.random.normal(r_noise, (mb, 4, res, res)),
                        jax_mask(dit, init, r_mask, mb, (res // 2) ** 2, mask_ratio)))
        return out

    step_fn = ptrainer._step_fn

    def with_jax_draws(state, batch, generator):
        draws = [{"rnd_normal": torch.from_numpy(np.array(s)),
                  "noise": torch.from_numpy(np.array(n)),
                  "token_mask": tmasking.token_mask_from_keep(torch.from_numpy(np.asarray(m) == 0))}
                 for s, n, m in jax_draws(state.step)]
        return step_fn(state, batch, draws=draws)

    ptrainer._step_fn = with_jax_draws
    ptrainer.fit()
    return ptrainer, tcollect.rows, jcollect.rows, jfinal, jema


def _assert_fit_parity(ptrainer, trows, jrows, jfinal, steps):
    """Per-step loss and grad norm within 1e-3 relative, lr within 1e-6; the final
    params within 2 * (sum of the lrs) absolute (Adam moves an entry by about lr a
    step whatever its gradient, so an entry whose tiny gradient differs in sign may
    part by up to twice that); the mean difference 100x tighter."""
    assert len(trows) == len(jrows) == steps
    for t, j in zip(trows, jrows):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-3)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-3)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
    tol = 2 * sum(r["lr"] for r in jrows)
    diffs = []
    for name, p in ptrainer.state.params.items():
        d = np.abs(p.detach().numpy() - jfinal[name])
        diffs.append(d.mean())
        assert d.max() <= tol, (name, d.max(), tol)
    assert np.mean(diffs) <= tol / 100
    return tol


def test_fit_matches_jax_trainer(dataset_dir, monkeypatch):
    """3 steps of Trainer.fit (Micro, fp32, mask 0.75, batch 16 in K = 2
    microbatches, clip 0.25, cosine warmup 2 steps to lr 1e-4) in both frameworks
    on the same dataset. The port starts from the JAX trainer's initial params;
    its per-batch step gets JAX's draws (fold_in(PRNGKey(seed), step), then the
    microbatch index; sigma / noise / mask keys split from that). Per-step loss
    and grad norm within 1e-3 relative, lr within 1e-6; the final params within
    2 * (sum of the lrs) absolute: Adam moves an entry by about lr a step whatever
    its gradient, so an entry whose tiny gradient differs in sign may part by up
    to twice that; the mean difference is held 100x tighter."""
    cfg = make_config(dataset_dir)
    ptrainer, trows, jrows, jfinal, _ = _fit_parity(cfg, monkeypatch, 0.75)
    _assert_fit_parity(ptrainer, trows, jrows, jfinal, 3)


def test_fit_matches_jax_trainer_at_512px_stage_settings(dataset_dir, monkeypatch):
    """The stage-3/4 settings through Trainer.fit in both frameworks: Micro, fp32,
    moe_dispatch 'gather', pos_interp_scale 2, the stage-3/4 noise schedule, an
    in-state EMA from step 1 (so it decays within the run), K = 2, constant lr
    after a 1-step warmup, clip 0.5. The tolerances of the stage-1 parity test,
    the EMA held to the params' own."""
    cfg = make_config(dataset_dir)
    cfg["model"].update(moe_dispatch="gather", pos_interp_scale=2.0, p_mean=0.0, p_std=0.6)
    cfg["algorithms"] = {
        "gradient_clipping": {"clipping_type": "norm", "clip_norm": 0.5},
        "ema": {"_target_": "diffusion.algorithms.ema.EMA", "smoothing": 0.9,
                "ema_start": "1ba", "update_interval": "1ba"}}
    cfg["scheduler"] = {"_target_": "composer.optim.ConstantWithWarmupScheduler",
                        "t_warmup": "1ba"}
    ptrainer, trows, jrows, jfinal, jema = _fit_parity(cfg, monkeypatch, 0.75)
    assert ptrainer.model.dit.blocks[1].mlp.dispatch == "gather"
    tol = _assert_fit_parity(ptrainer, trows, jrows, jfinal, 3)
    assert jema is not None
    lagging = 0
    for name, e in ptrainer.state.ema_params.items():
        assert np.abs(e.numpy() - jema[name]).max() <= tol, name
        lagging += not torch.equal(e, ptrainer.state.params[name])
    assert lagging >= 0.9 * len(jema)  # the EMA decayed: it lags the moving params


# ------------------------------------------------------------------ checkpoints


def _fit(datadir, tmp, name, steps, **trainer):
    cfg = make_config(datadir, max_duration=f"{steps}ba", device_train_microbatch_size=4,
                      save_folder=str(tmp / name), **trainer)
    cfg["dataset"]["train_batch_size"] = 8
    t = cli.build_from_config(cfg)
    t.fit()
    return t


def test_resume_equals_an_uninterrupted_run(dataset_dir, tmp_path):
    """2 steps, a checkpoint, and an autoresume to 5 give the same parameters,
    moments and loader position as 5 steps straight, bit for bit: the loader's
    position is in the checkpoint and each step's draws depend on (seed, step)
    alone. The checkpoint after step 2 records the loader at 2 batches, not the
    prefetched third."""
    straight = _fit(dataset_dir, tmp_path, "straight", 5)
    first = _fit(dataset_dir, tmp_path, "resumed", 2)
    ckpt = torch.load(tmp_path / "resumed" / "2" / ttrainer.CKPT_FILE, weights_only=True)
    assert ckpt["step"] == 2 and ckpt["loader"] == {"epoch": 0, "step_in_epoch": 2}
    assert first.state.step == 2
    resumed = _fit(dataset_dir, tmp_path, "resumed", 5, autoresume=True)
    assert resumed.state.step == 5 and resumed.state.opt_state.count == 5
    assert resumed.train_loader.state_dict() == straight.train_loader.state_dict()
    for k, p in straight.state.params.items():
        assert torch.equal(resumed.state.params[k], p), k
        assert torch.equal(resumed.state.opt_state.mu[k], straight.state.opt_state.mu[k]), k
    assert sorted(os.listdir(tmp_path / "resumed")) == ["5"]  # keeps 1 (the recipe's)


def test_weights_only_load_and_reference_pt(dataset_dir, tmp_path):
    """load_weights_only takes the weights of a port checkpoint and starts the step
    and the optimizer afresh; a reference-style .pt (prefixed keys, computed
    buffers) loads its weights."""
    src = _fit(dataset_dir, tmp_path, "src", 2)
    cfg = make_config(dataset_dir, load_path=str(tmp_path / "src"), load_weights_only=True,
                      load_strict_model_weights=False,
                      load_ignore_keys=["state/model/dit.pos_embed"])
    t = cli.build_from_config(cfg)
    assert t.state.step == 0 and t.state.opt_state.count == 0
    assert not any(m.any() for m in t.state.opt_state.mu.values())
    for k, p in src.state.params.items():
        assert torch.equal(t.state.params[k], p), k

    sd = {f"dit.{k}": v for k, v in src.model.dit.state_dict().items()}
    sd["dit.pos_embed"] = src.model.dit.pos_embed
    torch.save({"state": {"model": sd}}, tmp_path / "ref.pt")
    t = cli.build_from_config(make_config(dataset_dir, load_path=str(tmp_path / "ref.pt")))
    for k, p in src.state.params.items():
        assert torch.equal(t.state.params[k], p), k


def test_ema_stage_transition(dataset_dir, tmp_path):
    """A checkpoint without EMA (stage 2) loaded in full into a stage with EMA
    (stage 3): the step carries over and the EMA starts as a copy of the loaded
    weights; the EMA then decays (ema_start 0) and is checkpointed."""
    _fit(dataset_dir, tmp_path, "noema", 2)
    cfg = make_config(dataset_dir, load_path=str(tmp_path / "noema"), max_duration="4ba",
                      save_folder=str(tmp_path / "withema"))
    cfg["algorithms"]["ema"] = {"_target_": "diffusion.algorithms.ema.EMA",
                                "smoothing": 0.9, "ema_start": "0ba", "update_interval": "1ba"}
    t = cli.build_from_config(cfg)
    assert t.state.step == 2
    for k, p in t.state.params.items():
        assert torch.equal(t.state.ema_params[k], p), k
    t.fit()
    ckpt = torch.load(tmp_path / "withema" / "4" / ttrainer.CKPT_FILE, weights_only=True)
    key = "blocks.0.attn.qkv.weight"
    assert not torch.equal(ckpt["ema_params"][key], ckpt["params"][key])


def test_stage_chain_2_to_4_through_the_overlays(tmp_path):
    """The recipe's stage handoffs through the H100 overlays, at Micro size on the
    CPU (the chain chip_smoke.py's [chain] runs with Tiny on the card): stage 2 at
    latent 16 (64 tokens) for 2 steps and a save; stage 3 at latent 32 (256 tokens,
    pos_interp_scale 2, 'gather') loads stage 2's weights only, across the change of
    pos_embed (a computed buffer, rebuilt at 256 tokens), every parameter present,
    the EMA mirrored, the step and moments afresh; 2 steps and a save; stage 4 loads
    stage 3's full state with the recipe's load_ignore_keys: params, both moments,
    the EMA, the step and the count equal what stage 3 saved, bit for bit; then 2
    steps and an eval."""
    ds = tmp_path / "ds"
    rng = np.random.default_rng(3)
    with MDSWriter(out=str(ds), columns={"caption_latents": "bytes", "latents_128": "bytes",
                                         "latents_256": "bytes"}) as w:
        for _ in range(24):
            w.write({"caption_latents": rng.standard_normal((1, 77, 1024))
                     .astype(np.float16).tobytes(),
                     "latents_128": (0.5 * rng.standard_normal((4, 16, 16)))
                     .astype(np.float16).tobytes(),
                     "latents_256": (0.5 * rng.standard_normal((4, 32, 32)))
                     .astype(np.float16).tobytes()})

    def stage(name, *extra):
        argv = ["--config-path", OVERLAYS, "--config-name", name, "trainer.device=cpu",
                "model.dit_arch=MicroDiT_Micro_2", "model.dtype=float32",
                "model.fused_adaln=false", "model.remat=false",
                f"dataset.train.datadir={ds}", f"dataset.eval.datadir={ds}",
                "dataset.train_batch_size=8", "dataset.eval_batch_size=8",
                "trainer.device_train_microbatch_size=4", "trainer.eval_interval=0",
                "trainer.save_interval=0", "trainer.save_num_checkpoints_to_keep=1",
                f"trainer.save_folder={tmp_path / name}",
                f"callbacks.image_monitor.prompts_file={ROOT}/configs/eval_prompts.yaml",
                "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
                f"logger.progress.path={tmp_path / name}.jsonl", *extra]
        return tconfig.load_config(OVERLAYS, name, argv[4:])

    s2 = cli.build_from_config(stage("res_256_finetune", "model.latent_res=16",
                                     "dataset.image_size=128", "trainer.load_path=null",
                                     "trainer.max_duration=2ba"))
    s2.fit()
    assert s2.model.dit.pos_embed.shape == (1, 64, 64)

    s3 = cli.build_from_config(stage(
        "res_512_pretrain", "model.latent_res=32", "dataset.image_size=256",
        f"trainer.load_path={tmp_path / 'res_256_finetune'}", "trainer.max_duration=2ba",
        "algorithms.ema.ema_start=1ba"))
    assert s3.model.dit.pos_embed.shape == (1, 256, 64)
    assert s3.model.dit.blocks[1].mlp.dispatch == "gather"
    assert set(s3.state.params) == set(s2.state.params)
    assert s3.state.step == 0 and not any(m.any() for m in s3.state.opt_state.mu.values())
    for k, p in s2.state.params.items():
        assert torch.equal(s3.state.params[k], p) and torch.equal(s3.state.ema_params[k], p), k
    s3.fit()
    saved = torch.load(tmp_path / "res_512_pretrain" / "2" / ttrainer.CKPT_FILE,
                       weights_only=True)

    s4 = cli.build_from_config(stage(
        "res_512_finetune", "model.latent_res=32", "dataset.image_size=256",
        f"trainer.load_path={tmp_path / 'res_512_pretrain'}", "trainer.max_duration=4ba",
        "trainer.eval_interval=4ba", "algorithms.ema.ema_start=1ba"))
    assert s4.model.dit.blocks[1].mlp.dispatch == "gather"
    assert s4.state.step == 2 and s4.state.opt_state.count == saved["opt_state"]["count"]
    for k in saved["params"]:
        assert torch.equal(s4.state.params[k], saved["params"][k]), k
        assert torch.equal(s4.state.ema_params[k], saved["ema_params"][k]), k
        assert torch.equal(s4.state.opt_state.mu[k], saved["opt_state"]["mu"][k]), k
        assert torch.equal(s4.state.opt_state.nu[k], saved["opt_state"]["nu"][k]), k
    evals = []
    s4.callbacks.append(type("Eval", (_Collect,), {"eval_end": lambda self, t, loss:
                                                     evals.append(loss)})())
    s4.fit()
    assert s4.state.step == 4 and len(evals) == 1 and np.isfinite(evals[0])


def test_train_e2e_script_chains_the_four_stages(tmp_path):
    """micro_diffusion_tpu_torch/train_e2e.sh runs the four recipes through the H100
    overlays, each stage loading the one before from ./trained_models/<exp_name>/
    (Micro on the CPU, 1 step: stages 2 and 4 resume at the loaded step and only
    save, stage 3 trains a step from stage 2's weights at 512px)."""
    ds = tmp_path / "ds"
    rng = np.random.default_rng(4)
    with MDSWriter(out=str(ds), columns={"caption_latents": "bytes", "latents_256": "bytes",
                                         "latents_512": "bytes"}) as w:
        for _ in range(8):
            w.write({"caption_latents": rng.standard_normal((1, 77, 1024))
                     .astype(np.float16).tobytes(),
                     "latents_256": rng.standard_normal((4, 32, 32)).astype(np.float16).tobytes(),
                     "latents_512": rng.standard_normal((4, 64, 64)).astype(np.float16).tobytes()})
    script = os.path.join(ROOT, "micro_diffusion_tpu_torch", "train_e2e.sh")
    overrides = ["trainer.device=cpu", "model.dit_arch=MicroDiT_Micro_2", "model.dtype=float32",
                 "model.fused_adaln=false", "model.remat=false", f"dataset.train.datadir={ds}",
                 f"dataset.eval.datadir={ds}", "dataset.train_batch_size=4",
                 "trainer.device_train_microbatch_size=4", "trainer.max_duration=1ba",
                 f"callbacks.image_monitor.prompts_file={ROOT}/configs/eval_prompts.yaml",
                 "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
                 f"logger.progress.path={tmp_path / 'metrics.jsonl'}"]
    env = dict(os.environ, PYTHON=sys.executable, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(["bash", script, *overrides], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for exp in ("MicroDiTXL_mask_75_res_256_pretrain", "MicroDiTXL_mask_0_res_256_finetune",
                "MicroDiTXL_mask_75_res_512_pretrain", "MicroDiTXL_mask_0_res_512_finetune"):
        assert os.listdir(tmp_path / "trained_models" / exp) == ["1"], exp
    assert "loaded weights from" in out.stdout and out.stdout.count("loaded full state") == 2


@pytest.mark.parametrize("change,match", [
    (dict(accum_mode="bogus"), "accum_mode 'bogus'"),
    (dict(param_flow_dtype="float32"), "param_flow_dtype 'float32'"),
    (dict(ema_placement="bogus"), "EMA placement 'bogus'"),
    (dict(mesh_shape={"data": 2}), "does not equal the world"),
    (dict(device="tpu"), "'cuda' or 'cpu'"),
    pytest.param(dict(load_path="orbax"), "orbax.*scripts/orbax_to_torch.py",
                 id="change5-orbax"),
])
def test_unported_options_raise(dataset_dir, tmp_path, change, match):
    """Options the trainer cannot serve raise ValueError: values outside the
    accumulation modes, flow dtypes and EMA placements, a mesh the world does not
    fill, a TPU device, an orbax directory (naming the converter)."""
    cfg = make_config(dataset_dir)
    if "ema_placement" in change:
        cfg["algorithms"]["ema"] = {"smoothing": 0.9, "placement": change["ema_placement"]}
    elif "mesh_shape" in change:
        cfg["misc"] = {"mesh_shape": change["mesh_shape"]}
    elif "load_path" in change:
        os.makedirs(tmp_path / "orbax" / "2" / "state")  # an orbax manager's layout
        cfg["trainer"]["load_path"] = str(tmp_path / "orbax")
    else:
        cfg["trainer"].update(change)
    with pytest.raises(ValueError, match=match):
        cli.build_from_config(cfg)


@pytest.mark.parametrize("change", [
    dict(accum_mode="dispatch", grad_accum_dtype="bfloat16"),
    dict(param_flow_dtype="bfloat16"),
    dict(ema_placement="hostcompute"),
    dict(ema_placement="host_cadence"),
])
def test_ported_options_build_and_step(dataset_dir, change):
    """The options of the JAX trainer that the port took in this slice (they raised
    before): each builds and takes a step (tests/test_torch_options.py,
    test_torch_host_ema.py and test_torch_placements.py hold them against JAX)."""
    cfg = make_config(dataset_dir, max_duration="1ba")
    if "ema_placement" in change:
        cfg["algorithms"]["ema"] = {"smoothing": 0.9, "placement": change["ema_placement"]}
    else:
        cfg["trainer"].update(change)
    t = cli.build_from_config(cfg)
    t.fit()
    assert t.state.step == 1
    if "ema_placement" in change:
        assert t.ema_placement == change["ema_placement"] and t._ema_weights() is not None


def test_callbacks_and_loggers(tmp_path):
    """The JSONL logger writes one object per call; NaNCatcher raises on a
    non-finite loss; LogDiffusionImages without prompt latents warns once and logs
    nothing, as the JAX callback does."""
    log = tcallbacks.JSONLLogger(str(tmp_path / "m.jsonl"))
    log.log_scalars({"a": 1.0}, 3)
    log.close()
    assert [json.loads(l) for l in open(tmp_path / "m.jsonl")] == [{"step": 3, "a": 1.0}]

    class Stub:
        global_step, printed, logged = 7, [], []
        model = types.SimpleNamespace(tokenizer=None, text_encoder=None, vae=None)

        def print(self, msg):
            self.printed.append(msg)

        def log(self, scalars):
            self.logged.append(scalars)

    with pytest.raises(RuntimeError, match="NaN"):
        tcallbacks.NaNCatcher().step_end(Stub(), {"loss": float("nan")})
    images = tcallbacks.LogDiffusionImages(prompts_file=os.path.join(ROOT, "configs",
                                                                     "eval_prompts.yaml"))
    assert len(images.prompts) == len(jcallbacks.LogDiffusionImages(
        prompts_file=os.path.join(ROOT, "configs", "eval_prompts.yaml")).prompts)
    stub = Stub()
    images.eval_end(stub, 0.5)
    images.eval_end(stub, 0.5)
    assert len(stub.printed) == 1 and not stub.logged


def test_eval_with_ema_weights_and_prompt_latents(dataset_dir, tmp_path):
    """evaluate() runs one epoch of the eval loader with the EMA weights and puts the
    trained weights back; LogDiffusionImages samples the prompt latents (2 Heun
    steps here) inside the same swap and logs the latents' spread."""
    cfg = make_config(dataset_dir)  # 3 steps: the lr is 0 at step 0
    cfg["dataset"]["eval"] = dict(cfg["dataset"]["train"], shuffle=False)
    cfg["algorithms"]["ema"] = {"smoothing": 0.5, "ema_start": "0ba", "update_interval": "1ba"}
    np.save(tmp_path / "prompts.npy", rand((2, 1, 77, 1024), 5).astype(np.float16))
    t = cli.build_from_config(cfg)
    t.fit()
    t.loggers = [tcallbacks.JSONLLogger(str(tmp_path / "m.jsonl"))]
    t.callbacks = [tcallbacks.LogDiffusionImages(
        prompt_latents_path=str(tmp_path / "prompts.npy"), sampling_steps=2)]
    key = "final_layer.linear.weight"
    trained = t.state.params[key].clone()
    assert not torch.equal(t.state.ema_params[key], trained)
    loss = t.evaluate()
    t.close()
    assert np.isfinite(loss) and torch.equal(t.state.params[key], trained)
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["metrics/eval/loss"] for r in rows if "metrics/eval/loss" in r] == [loss]
    assert all(np.isfinite(r["images/latent_std"]) for r in rows if "images/latent_std" in r)
    assert sum("images/latent_std" in r for r in rows) == 1
