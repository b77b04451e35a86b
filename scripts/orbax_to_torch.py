"""Carry a JAX training run to the PyTorch port: an orbax checkpoint of the JAX
``Trainer`` -> a checkpoint folder of the port's trainer.

    python scripts/orbax_to_torch.py SRC OUT [--step N]

SRC is an orbax manager directory (the JAX trainer's ``save_folder``; its latest step,
or ``--step N``) or one step directory of it. The step's ``state`` item
({step, params, opt_state, ema_params}, micro_diffusion_tpu/train/trainer.py
``_state_to_save``) is restored without a template, and its ``loader`` item (the data
loader's position) when there is one. Written: ``OUT/<step>/checkpoint.pt`` in the
port trainer's layout (micro_diffusion_tpu_torch/train/trainer.py ``save``):

    {"step", "params", "opt_state": {"count", "mu", "nu"}, "loader"[, "ema_params"]}

with the torch names of micro_diffusion_tpu/models/interop.py
``params_to_torch_state_dict`` on the parameters, both Adam moments and the EMA.
Every leaf keeps its dtype and its bits: bfloat16 moments and EMAs are carried as
their 16-bit patterns, never through float32. ``ema_params`` is written only when
the orbax state has one (the port's trainer then starts its EMA from the
parameters, as the JAX trainer does).

The optax state is found by its shape, whatever the recipe built (train/optim.py
``build_optimizer``): every Adam state ({count, mu, nu}: ``adamw``, or one per group
of ``multi_transform``, whose masked leaves come back as None; bf16 moments under
``low_precision_moments`` or ``mu_dtype``) is merged leaf by leaf into one tree, each
leaf taken from the one group that holds it. The port keeps one update count, so
every count in the state (the Adam counts and the learning-rate schedules') must be
equal; otherwise the conversion stops and names them. ``step`` and the count are
carried as they are.

Then, in the port: ``trainer.load_path=OUT`` (the full state; with
``trainer.load_weights_only=true`` the weights, for the next stage of the recipe),
or ``trainer.save_folder=OUT trainer.autoresume=true``, which also restores the
loader's position; ``load_any_checkpoint`` / ``eval/generate_eval_images.py
--checkpoint OUT`` read the EMA first.

The random stream does not carry over: JAX draws step s from
``fold_in(PRNGKey(seed), s)``, which torch cannot reproduce, so the resumed run draws
its noise, sigmas, token masks and caption drops from the port's generator for
(seed, step). Everything else in the state is the JAX run's, bit for bit.

Runs where JAX and orbax are installed (a TPU host, or any CPU machine with the JAX
package), on the CPU; it needs torch too, and imports nothing of the port.
"""

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_FILE = "checkpoint.pt"  # micro_diffusion_tpu_torch/train/trainer.py CKPT_FILE


def to_tensor(arr: Any) -> torch.Tensor:
    """A restored leaf as a torch tensor with the same dtype and bits (a C-ordered
    copy: the restored arrays are read-only, and kernels come transposed)."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy refuses it
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _prune(tree: Any) -> Any:
    """``tree`` without its None leaves (a masked group's placeholders), or None."""
    if isinstance(tree, dict):
        out = {k: v for k, v in ((k, _prune(v)) for k, v in tree.items()) if v is not None}
        return out or None
    return tree


def torch_names(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax params-shaped tree -> {torch name: tensor}, its None leaves dropped."""
    from micro_diffusion_tpu.models.interop import params_to_torch_state_dict

    pruned = _prune(tree)
    if pruned is None:
        return {}
    return {k: to_tensor(v) for k, v in params_to_torch_state_dict(pruned).items()}


def _walk(node: Any, path: str, adam: List[Tuple[str, dict]], counts: List[Tuple[str, int]]):
    if isinstance(node, dict):
        if "count" in node:
            counts.append((f"{path}/count", int(np.asarray(node["count"]))))
        if {"mu", "nu"} <= node.keys():
            adam.append((path, node))
            return
        for k, v in node.items():
            if k != "count":
                _walk(v, f"{path}/{k}", adam, counts)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{path}/{i}", adam, counts)


def merge_adam_states(opt_state: Any) -> Dict[str, Any]:
    """{"count", "mu", "nu"} of an optax state restored without a template: the Adam
    states found in it merged leaf by leaf, their counts and every other count in the
    state required equal."""
    adam, counts = [], []
    _walk(opt_state, "opt_state", adam, counts)
    if not adam:
        raise ValueError("no Adam state ({count, mu, nu}) in the checkpoint's opt_state")
    if len({c for _, c in counts}) != 1:
        raise ValueError("the optimizer's counts differ; the port keeps one: "
                         + ", ".join(f"{p} = {c}" for p, c in counts))
    merged: Dict[str, Dict[str, torch.Tensor]] = {"mu": {}, "nu": {}}
    owner: Dict[str, str] = {}
    for path, state in adam:
        for moment in ("mu", "nu"):
            for name, t in torch_names(state[moment]).items():
                if name in merged[moment]:
                    raise ValueError(f"{moment} of {name} is in two Adam states: "
                                     f"{owner[name]} and {path}")
                merged[moment][name] = t
                owner[name] = path
    return {"count": counts[0][1], **merged}


def restore(src: str, step: int | None = None) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """(step, state, loader) of an orbax manager directory (its latest step, or
    ``step``) or of one step directory; ``loader`` is {} when the step has none.
    Restored on the host's CPU."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp

    src = os.path.abspath(src)
    if not os.path.isdir(src):
        raise FileNotFoundError(f"no directory {src}")
    if os.path.isdir(os.path.join(src, "state")):  # one step directory
        step_dir = src
        if step is not None and os.path.basename(src) != str(step):
            raise ValueError(f"{src} is one step directory; --step {step} names another")
    else:
        steps = ocp.CheckpointManager(src).all_steps()
        if not steps:
            raise FileNotFoundError(f"no orbax checkpoint under {src}")
        if step is not None and step not in steps:
            raise FileNotFoundError(f"no step {step} under {src}; it has {sorted(steps)}")
        step_dir = os.path.join(src, str(max(steps) if step is None else step))
    items = {"state": ocp.args.StandardRestore()}
    if os.path.isdir(os.path.join(step_dir, "loader")):
        items["loader"] = ocp.args.JsonRestore()
    restored = ocp.Checkpointer(ocp.CompositeCheckpointHandler()).restore(
        step_dir, args=ocp.args.Composite(**items))
    state = jax.tree.map(np.asarray, restored["state"])
    return int(state["step"]), state, dict(restored["loader"] if "loader" in items else {})


def convert(src: str, out: str, step: int | None = None) -> str:
    """Write the port checkpoint of ``src`` under ``out``; returns its path."""
    step, state, loader = restore(src, step)
    params = torch_names(state["params"])
    opt = merge_adam_states(state["opt_state"])
    payload = {"step": step, "params": params, "opt_state": opt, "loader": loader}
    trees = {"opt_state.mu": opt["mu"], "opt_state.nu": opt["nu"]}
    if state.get("ema_params") is not None:
        payload["ema_params"] = trees["ema_params"] = torch_names(state["ema_params"])
    for what, tree in trees.items():
        if set(tree) != set(params):
            raise ValueError(f"{what} names differ from the parameters': missing "
                             f"{sorted(set(params) - set(tree))[:5]}, unexpected "
                             f"{sorted(set(tree) - set(params))[:5]}")
        for k, t in tree.items():
            if t.shape != params[k].shape:
                raise ValueError(f"{what}[{k}] has shape {tuple(t.shape)}, the parameter "
                                 f"{tuple(params[k].shape)}")
    path = os.path.join(out, str(step), CKPT_FILE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The resumed run draws its noise, sigmas, masks and caption drops from the "
               "port's generator for (seed, step), not from JAX's keys: the random stream "
               "differs from the one the JAX run would have drawn; the state does not.")
    parser.add_argument("src", help="orbax manager directory or one step directory of it")
    parser.add_argument("out", help="the port checkpoint folder to write (OUT/<step>/"
                                    f"{CKPT_FILE})")
    parser.add_argument("--step", type=int, default=None,
                        help="the step to convert (default: the latest)")
    args = parser.parse_args(argv)
    if ROOT not in sys.path:  # the JAX package beside this script
        sys.path.insert(0, ROOT)
    path = convert(args.src, args.out, args.step)
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    print(json.dumps({"written": path, "step": ckpt["step"],
                      "count": ckpt["opt_state"]["count"], "params": len(ckpt["params"]),
                      "ema": "ema_params" in ckpt, "loader": ckpt["loader"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
