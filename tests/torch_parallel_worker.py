"""One rank of the port's sharded train step on the CPU (gloo), for
tests/test_torch_parallel.py, and the same steps in one process.

    python tests/torch_parallel_worker.py INPUTS OUT DATA FSDP TENSOR

with torchrun's environment (``micro_diffusion_tpu_torch.parallel.dryrun.launch``
sets it). ``INPUTS`` (torch.save) holds the DiT weights by name, the global batch
and the per-row draws of each step; every scenario of ``SCENARIOS`` runs
``len(batches)`` steps from those weights on this rank's rows, and rank 0 writes
each scenario's losses, grad norms and whole params / mu / nu / EMA to ``OUT``,
with TENSOR > 1 also the injected draws under each of ``REMAT_POLICIES`` (under
``"remat"``), and the shape of ``make_multislice_mesh`` over DATA nodes.
Imports no JAX.
"""

import os
import sys

import torch

from micro_diffusion_tpu_torch.models.diffusion import LatentDiffusion
from micro_diffusion_tpu_torch.models.dit import DiT
from micro_diffusion_tpu_torch.ops.masking import token_mask_from_keep
from micro_diffusion_tpu_torch.parallel import (Zero2, batch_sharding, init_distributed,
                                                make_mesh, make_multislice_mesh, shard_params)
from micro_diffusion_tpu_torch.train.optim import build_optimizer, constant_schedule
from micro_diffusion_tpu_torch.train.train_step import create_train_state, make_train_step
from micro_diffusion_tpu_torch.train.trainer import step_seed

# a small DiT whose compile JAX can afford twice in the test: block 1 is an EC-MoE
# block of 4 experts (every 2nd block, not the last), 16 tokens, 4 kept at mask 0.75
PAR = dict(patch_size=2, in_channels=4, depth=3, qkv_multipliers=(1.0,),
           ffn_multipliers=(2.0,), use_patch_mixer=False, use_bias=False, num_experts=4,
           expert_capacity=2.0, input_size=8, dim=32, head_dim=16, multiple_of=16,
           caption_channels=16)
LATENT, CAPTION = 8, (8, 16)
LR, CLIP, EMA, SEED = 1e-4, 0.25, 0.99, 11
SCENARIOS = ("injected", "generator")
# expert parallelism under selective remat: the injected draws with the DiT's blocks
# checkpointed under each policy, run where the mesh has tensor > 1 ('attn_moe' keeps
# the MoE output, 'dots' the 2-D products)
REMAT_POLICIES = ("attn_moe", "dots")


def weights(seed: int = 0) -> dict:
    """The port's init, every parameter perturbed so the zero-init ones are live."""
    dit = DiT(dtype=torch.float32, device="cpu", **PAR)
    gen = torch.Generator().manual_seed(seed)
    dit.init_weights(gen)
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen)
            for k, v in dit.state_dict().items()}


def build(weights: dict, remat_policy: str | None = None) -> LatentDiffusion:
    dit = DiT(dtype=torch.float32, device="cpu", remat=remat_policy is not None,
              remat_policy=remat_policy or "full", **PAR)
    dit.load_state_dict(weights)
    return LatentDiffusion(dit, latent_res=LATENT, train_mask_ratio=0.75, latent_scale=1.0)


def run(inputs: dict, scenario: str, microbatch: int, mesh=None,
        remat_policy: str | None = None) -> dict:
    """The steps of ``inputs`` on this rank's rows (all rows without a mesh), in
    microbatches of ``microbatch``, the blocks under ``remat_policy`` (None: no
    remat); whole tensors by name from every rank."""
    model = build(inputs["weights"], remat_policy)
    zero = None
    if mesh is not None:
        shard_params(model.dit, mesh)
        zero = Zero2(model.dit, mesh)
    sched = constant_schedule(LR)
    tx = build_optimizer(dict(model.dit.named_parameters()), sched, clip_norm=CLIP)
    state = create_train_state(model.dit, tx, use_ema=True, grad_shardings=zero)
    step = make_train_step(model, tx, sched, microbatch_size=microbatch, ema_smoothing=EMA,
                           ema_start=0, grad_shardings=zero)
    rows = batch_sharding(mesh).rows(inputs["batches"][0]["image_latents"].shape[0])
    losses, norms = [], []
    for s, (batch, draws) in enumerate(zip(inputs["batches"], inputs["draws"])):
        mine = {k: v[rows] for k, v in batch.items()}
        if scenario == "injected":
            d = {k: v[rows] for k, v in draws.items()}
            per = [{"rnd_normal": d["rnd_normal"][i:i + microbatch],
                    "noise": d["noise"][i:i + microbatch],
                    "token_mask": token_mask_from_keep(d["keep"][i:i + microbatch])}
                   for i in range(0, len(d["keep"]), microbatch)]
            state, m = step(state, mine, draws=per)
        else:
            state, m = step(state, mine, torch.Generator().manual_seed(step_seed(SEED, s)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    opt = state.opt_state
    whole = {
        "params": {k: zero.gather_param(v.detach(), k) if zero else v.detach()
                   for k, v in state.params.items()},
        "mu": {k: zero.gather_state(v, k) if zero else v for k, v in opt.mu.items()},
        "nu": {k: zero.gather_state(v, k) if zero else v for k, v in opt.nu.items()},
        "ema": {k: zero.gather_param(v, k) if zero else v for k, v in state.ema_params.items()},
    }
    return {"loss": losses, "grad_norm": norms, **whole}


def main(inputs_path, out_path, data, fsdp, tensor) -> None:
    init_distributed("cpu", timeout=120)
    mesh = make_mesh(int(data), int(fsdp), int(tensor))
    inputs = torch.load(inputs_path, weights_only=True)
    rows = inputs["batches"][0]["image_latents"].shape[0] // mesh.axis_size("batch")
    results = {s: run(inputs, s, rows // 2, mesh) for s in SCENARIOS}
    if int(tensor) > 1:
        results["remat"] = {p: run(inputs, "injected", rows // 2, mesh, p)
                            for p in REMAT_POLICIES}
    # the same world as `data` nodes of fsdp x tensor ranks each
    os.environ["LOCAL_WORLD_SIZE"] = str(int(fsdp) * int(tensor))
    results["multislice"] = make_multislice_mesh(int(data), int(fsdp), int(tensor)).shape
    if mesh.rank == 0:
        torch.save(results, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
