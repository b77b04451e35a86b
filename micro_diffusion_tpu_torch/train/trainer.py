"""The training loop of the port: counterpart of micro_diffusion_tpu/train/trainer.py
(``Trainer`` :57-772), on one device or one rank of a process group.

  * one step per batch through ``make_train_step`` (microbatch accumulation, AdamW
    with clipping, EMA in the state), with ``grad_accum_dtype`` and
    ``param_flow_dtype``. ``accum_mode: dispatch`` (the v5e overlays) takes the
    same step: ``make_train_step`` already runs ``make_grad_step`` once per
    microbatch into a zeroed accumulator and then ``make_apply_step``, which is
    what JAX's dispatch mode calls one by one (the two modes are semantically
    identical there too);
  * the EMA placements (JAX trainer.py:137-155): ``in_state``, the EMA tree in
    the state, updated inside the step; ``host_cadence``, the same tree updated
    by ``make_ema_step`` after every ``update_interval``-th step (before
    ``ema_start`` it mirrors the parameters, at the interval only);
    ``hostcompute``, fp32 chunks in pinned host memory (train/host_ema.py
    ``HostComputeEMA``) made at the first update from ``ema_start`` on, saved
    reassembled on the host in the checkpoint's ``ema_params`` and rebuilt from
    it on a resume;
  * the next batch is staged while the step runs: copied into pinned host memory
    and to the card on a side stream, which the step's stream waits for before
    use; never past ``max_duration``;
  * metrics stay on the card and are fetched every ``metric_window`` steps;
  * each phase is a span of utils/profiling.py (``data.wait``, ``trainer.stage``,
    ``train.step`` with device ends, ``trainer.ema``, ``trainer.metrics``,
    ``trainer.eval``, ``trainer.save``), so ``spans()`` and a trace show where the
    host was while the card waited;
  * eval over one epoch of the eval loader, with the EMA weights when there are;
  * checkpoints: ``torch.save`` of {step, params, opt_state, ema_params, loader}
    into ``<save_folder>/<step>/checkpoint.pt``, the newest
    ``save_num_checkpoints_to_keep`` kept; ``load_path`` (a port checkpoint
    folder or step directory, or a reference ``.pt``), ``load_weights_only``,
    ``load_ignore_keys`` (printed: structural no-ops, as in JAX) and
    ``autoresume``, which also restores the loader's position.

Random draws: step ``s`` draws from a ``torch.Generator`` seeded from (seed, s)
alone, as JAX draws from ``fold_in(PRNGKey(seed), s)``, so a resumed run repeats
an uninterrupted one and the checkpoint carries no generator state.

In a process group (train/cli.py ``--multihost``, or ``torchrun``'s WORLD_SIZE)
the ranks form a (data, fsdp, tensor) mesh of ``mesh_shape`` (default: all data;
parallel/mesh.py), which must equal the world. Each rank loads its rows of the
global batch, the step runs ZeRO-2 and, under ``tensor``, expert parallelism
(parallel/sharding.py), and the step's generator skips the draws of the rows
before the rank's, so that every row draws what it draws in one process.
Only rank 0 prints and logs; the eval loss is the mean over the ranks' batches
(a rank's eval draws come from (seed, batch, rank)); checkpoints keep the one
format, whole tensors by name, written by rank 0 after the shards are gathered,
and a load on any world size takes its slices, so a checkpoint from n ranks
resumes on m. The loader position in them is global.

An orbax (JAX) checkpoint directory raises, naming the converter that turns it
into a checkpoint folder of this trainer where JAX is installed
(``scripts/orbax_to_torch.py``: the whole state of a JAX run, its loader position
included).
"""

import contextlib
import dataclasses
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.interop import load_torch_checkpoint
from ..parallel import Zero2, make_mesh, shard_params
from ..utils.profiling import span
from .callbacks import Callback, Logger
from .optim import AdamState, build_optimizer, build_schedule
from .host_ema import HostComputeEMA
from .train_step import (FLOW_DTYPES, create_train_state, make_ema_step, make_eval_step,
                         make_train_step)

CKPT_FILE = "checkpoint.pt"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
ACCUM_MODES = ("scan", "dispatch")
EMA_PLACEMENTS = ("in_state", "host_cadence", "hostcompute")


def parse_duration(v: Any) -> int:
    """'250000ba' -> 250000 (batches are the only unit, as in the recipes)."""
    if isinstance(v, int):
        return v
    s = str(v)
    if not s.endswith("ba"):
        raise ValueError(f"only 'ba' durations are supported, got {v!r}")
    return int(s[:-2])


def _dtype(name: Optional[str], what: str, allowed=tuple(_DTYPES.values())
           ) -> Optional[torch.dtype]:
    if name is None:
        return None
    names = sorted(k for k, v in _DTYPES.items() if v in allowed)
    if name not in names:
        raise ValueError(f"{what} {name!r}: one of {names}")
    return _DTYPES[name]


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The seed of step ``step``'s generator: a function of (seed, step) only, and
    of the rank for ranks other than 0."""
    entropy = [int(seed), int(step)] + ([int(rank)] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _step_dirs(folder: str) -> List[int]:
    """Steps with a port checkpoint under ``folder``, ascending."""
    if not os.path.isdir(folder):
        return []
    return sorted(int(d) for d in os.listdir(folder)
                  if d.isdigit() and os.path.exists(os.path.join(folder, d, CKPT_FILE)))


def find_checkpoint(path: str) -> str:
    """The checkpoint file for ``path``: a step directory, or a folder of them
    (the latest step). Raises for an orbax (JAX) checkpoint directory, naming the
    converter: the card's machine has no JAX to read one."""
    if os.path.isfile(os.path.join(path, CKPT_FILE)):
        return os.path.join(path, CKPT_FILE)
    steps = _step_dirs(path)
    if steps:
        return os.path.join(path, str(steps[-1]), CKPT_FILE)
    if os.path.isdir(path) and any(d.isdigit() for d in os.listdir(path)):
        raise ValueError(f"{path} looks like an orbax (JAX) checkpoint directory; the port "
                         "loads its own checkpoints and reference .pt files. Convert it "
                         "where JAX is installed: python scripts/orbax_to_torch.py "
                         f"{path} OUT [--step N], then load OUT")
    raise FileNotFoundError(f"no checkpoint under {path}")


class Trainer:
    def __init__(
        self,
        model,
        optimizer: Dict[str, Any],
        schedulers: Dict[str, Any],
        train_dataloader: Any,
        eval_dataloader: Any = None,
        max_duration: Any = "1000ba",
        eval_interval: Any = 0,
        save_interval: Any = 0,
        save_folder: Optional[str] = None,
        save_num_checkpoints_to_keep: int = 1,
        device_train_microbatch_size: Optional[int] = None,
        run_name: str = "run",
        seed: int = 18,
        load_path: Optional[str] = None,
        load_ignore_keys: Optional[Sequence[str]] = None,
        load_weights_only: bool = False,
        load_strict_model_weights: bool = True,
        loggers: Optional[List[Logger]] = None,
        callbacks: Optional[List[Callback]] = None,
        algorithms: Optional[Dict[str, Any]] = None,
        ema: Optional[Dict[str, Any]] = None,
        mesh_shape: Optional[Dict[str, int]] = None,
        metric_window: int = 10,
        device: Optional[str] = None,
        autoresume: bool = False,
        accum_mode: str = "scan",
        grad_accum_dtype: str = "float32",
        param_flow_dtype: Optional[str] = None,
        **_: Any,
    ):
        if accum_mode not in ACCUM_MODES:
            raise ValueError(f"accum_mode {accum_mode!r}: one of {ACCUM_MODES}")
        self.accum_mode = accum_mode
        self.accum_dtype = _dtype(grad_accum_dtype, "grad_accum_dtype")
        self.param_flow_dtype = _dtype(param_flow_dtype, "param_flow_dtype", FLOW_DTYPES)
        mesh_shape = {k: v for k, v in (mesh_shape or {}).items() if v is not None}
        self.mesh = None
        if dist.is_initialized():
            self.mesh = make_mesh(data=mesh_shape.get("data"), fsdp=mesh_shape.get("fsdp", 1),
                                  tensor=mesh_shape.get("tensor", 1))
        elif any(v != 1 for v in mesh_shape.values()):
            raise ValueError(f"mesh_shape {mesh_shape} does not equal the world of one "
                             "process: start one process per device (torchrun, --multihost)")
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.model = model
        self.device = next(model.parameters()).device
        if device is not None and torch.device(device).type != self.device.type:
            raise ValueError(f"trainer device {device!r} but the model is on {self.device}")
        self.train_loader = train_dataloader
        self.eval_loader = eval_dataloader
        self.max_steps = parse_duration(max_duration)
        self.eval_interval = parse_duration(eval_interval) if eval_interval else 0
        self.save_interval = parse_duration(save_interval) if save_interval else 0
        self.keep = int(save_num_checkpoints_to_keep)
        self.microbatch_size = device_train_microbatch_size
        self.run_name = run_name
        self.seed = int(seed)
        self.loggers = loggers or []
        self.callbacks = callbacks or []
        self.metric_window = int(metric_window)
        self.num_chips = self.mesh.size if self.mesh is not None else 1
        self.global_batch_size = (getattr(train_dataloader, "global_batch_size", None)
                                  or getattr(train_dataloader, "batch_size", 0))

        algorithms = algorithms or {}
        clip_norm = None
        if "gradient_clipping" in algorithms:
            clip_norm = float(algorithms["gradient_clipping"]["clip_norm"])
        ema = ema or algorithms.get("ema")
        self.ema_cfg = None
        if ema:
            placement = str(ema.get("placement", "in_state"))
            if placement not in EMA_PLACEMENTS:
                raise ValueError(f"EMA placement {placement!r}: one of {EMA_PLACEMENTS}")
            self.ema_cfg = {
                "placement": placement,
                "smoothing": float(ema.get("smoothing", 0.9999)),
                "ema_start": parse_duration(ema.get("ema_start", 0)),
                "update_interval": max(1, parse_duration(ema.get("update_interval", 1))),
                "dtype": _dtype(ema.get("dtype"), "EMA dtype"),
            }

        self.lr_schedule = build_schedule(schedulers, float(optimizer["lr"]), self.max_steps)
        self.zero = None
        if self.mesh is not None:
            shard_params(model.dit, self.mesh)
            self.zero = Zero2(model.dit, self.mesh)
        self.tx = build_optimizer(
            dict(model.dit.named_parameters()), self.lr_schedule,
            weight_decay=float(optimizer.get("weight_decay", 0.1)),
            betas=tuple(optimizer.get("betas", (0.9, 0.999))),
            eps=float(optimizer.get("eps", 1e-8)), clip_norm=clip_norm,
            low_precision_moments=bool(optimizer.get("low_precision_moments", False)),
            mu_dtype=_dtype(optimizer.get("mu_dtype"), "mu_dtype"))
        self.ema_placement = self.ema_cfg["placement"] if self.ema_cfg else "in_state"
        # hostcompute: the EMA lives off the state, made at the first update from
        # ema_start on (before it the EMA would mirror the parameters)
        self._hc_ema = None
        self.state = create_train_state(
            model.dit, self.tx,
            use_ema=self.ema_cfg is not None and self.ema_placement != "hostcompute",
            ema_dtype=self.ema_cfg["dtype"] if self.ema_cfg else None, grad_shardings=self.zero)
        self._step_fn = self._make_step()
        self._ema_step = (make_ema_step(self.ema_cfg["smoothing"])
                          if self.ema_placement == "host_cadence" else None)
        self._eval_fn = make_eval_step(model)
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        self._save_loader_state = None

        self.save_dir = (os.path.abspath(save_folder.format(run_name=run_name))
                         if save_folder else None)
        if load_path:
            self.load(load_path, load_weights_only, load_ignore_keys, load_strict_model_weights)
        elif autoresume and self.save_dir and _step_dirs(self.save_dir):
            self._resume(find_checkpoint(self.save_dir))

    # ------------------------------------------------------------------ utils

    @property
    def global_step(self) -> int:
        return self.state.step

    def print(self, msg: str) -> None:
        if self.is_main:
            print(f"[trainer:{self.run_name}] {msg}", flush=True)

    def log(self, scalars: Dict[str, float]) -> None:
        if not self.is_main:
            return
        for logger in self.loggers:
            logger.log_scalars(scalars, self.global_step)

    def close(self) -> None:
        for logger in self.loggers:
            logger.close()
        if self._hc_ema is not None:  # its queued decays done, its failure raised
            self._hc_ema.block()

    def _ema_weights(self) -> Optional[dict]:
        """The EMA by name on the device, or None where the parameters stand for
        it (no EMA, or hostcompute before ema_start)."""
        if self._hc_ema is not None:
            return self._hc_ema.materialize(self.device)
        return self.state.ema_params

    @contextlib.contextmanager
    def eval_weights(self):
        """Run the model with the EMA weights inside the block, when there is an
        EMA (JAX ``eval_params``); the trained weights are put back after it."""
        ema = self._ema_weights()
        if ema is None:
            yield
            return
        params = self.state.params
        with torch.no_grad():
            saved = {k: p.detach().clone() for k, p in params.items()}
            for k, p in params.items():
                p.copy_(ema[k])
        try:
            yield
        finally:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])

    # ------------------------------------------------------------------ ckpt

    def save(self) -> None:
        """Write the state at this step; in a process group every rank calls it, the
        shards are gathered and rank 0 writes (to the host first), then a barrier."""
        if self.save_dir is None:
            return
        step = self.global_step
        path = os.path.join(self.save_dir, str(step), CKPT_FILE)
        exists = [os.path.exists(path)]
        if self.mesh is not None:
            dist.broadcast_object_list(exists, src=0)
        if exists[0]:
            return  # already saved at this step (an interval save == the final save)
        loader_state = self._save_loader_state
        if loader_state is None and hasattr(self.train_loader, "state_dict"):
            loader_state = self.train_loader.state_dict()
        opt = self.state.opt_state
        params, mu, nu, ema = (self.state.params, opt.mu, opt.nu, self.state.ema_params)
        if self._hc_ema is not None:  # reassembled on the host, as JAX's (:393-398)
            ema = self._hc_ema.materialize("cpu")
        if self.zero is not None:
            def whole(gather, tree):  # every rank gathers; rank 0 keeps a host copy
                out = {}
                for k, v in tree.items():
                    t = gather(v.detach().to(self.device), k)
                    out[k] = t.cpu() if self.is_main else None
                return out

            params = whole(self.zero.gather_param, params)
            mu, nu = whole(self.zero.gather_state, mu), whole(self.zero.gather_state, nu)
            if ema is not None:
                ema = whole(self.zero.gather_param, ema)
        if self.is_main:
            payload = {"step": step, "params": params,
                       "opt_state": {"count": opt.count, "mu": mu, "nu": nu},
                       "loader": loader_state or {}}
            if ema is not None:
                payload["ema_params"] = ema
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(payload, path + ".tmp")
            os.replace(path + ".tmp", path)
            for old in _step_dirs(self.save_dir)[:-self.keep] if self.keep > 0 else []:
                shutil.rmtree(os.path.join(self.save_dir, str(old)))
        del params, mu, nu, ema
        if self.mesh is not None:
            dist.barrier()
        self.print(f"saved checkpoint at step {step}")

    def _read(self, path: str) -> dict:
        if self.mesh is not None:  # each rank maps the file and copies its slices
            return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        return torch.load(path, map_location=self.device, weights_only=True)

    def _resume(self, path: str) -> None:
        ckpt = self._read(path)
        self._apply_restored(ckpt, weights_only=False, strict=True)
        if ckpt.get("loader") and hasattr(self.train_loader, "load_state_dict"):
            self.train_loader.load_state_dict(ckpt["loader"])
        self.print(f"resumed from checkpoint step {self.global_step}")

    def load(self, load_path: str, weights_only: bool = False,
             ignore_keys: Optional[Sequence[str]] = None, strict: bool = True) -> None:
        """Load a reference .pt (weights) or a port checkpoint (full state, or the
        weights alone with ``weights_only``)."""
        for key in ignore_keys or []:
            # the lr/scheduler state derives from (step, config); dit.pos_embed is a
            # computed constant
            self.print(f"load_ignore_keys: '{key}' (structural no-op in this trainer)")
        if load_path.endswith((".pt", ".pth", ".bin")):
            if self.zero is None:
                load_torch_checkpoint(load_path, self.model.dit, strict=strict)
                self._mirror_ema()
            else:  # this rank's slices of the whole tensors
                self._apply_restored({"params": load_torch_checkpoint(load_path)},
                                     weights_only=True, strict=strict)
            self.print(f"loaded torch weights from {load_path}")
            return
        path = find_checkpoint(load_path)
        ckpt = self._read(path)
        self._apply_restored(ckpt, weights_only=weights_only, strict=strict)
        self.print(f"loaded {'weights' if weights_only else 'full state'} from {path} "
                   f"(step {ckpt['step']})")

    def _new_hc_ema(self, params: dict) -> HostComputeEMA:
        return HostComputeEMA(params, self.ema_cfg["smoothing"],
                              offload=self.device.type == "cuda")

    def _drop_hc_ema(self) -> None:
        if self._hc_ema is not None:
            self._hc_ema.block()
            self._hc_ema = None

    def _host_ema(self, step: int) -> None:
        """The host placements' EMA after the optimizer update of (pre-increment)
        ``step``, at every ``update_interval``-th step (JAX trainer.py:352-381)."""
        cfg = self.ema_cfg
        if cfg is None or self.ema_placement == "in_state" or step % cfg["update_interval"]:
            return
        with span("trainer.ema"):
            if self.ema_placement == "host_cadence":
                if step < cfg["ema_start"]:
                    self._mirror_ema()
                else:
                    self.state = self._ema_step(self.state)
            elif step >= cfg["ema_start"]:  # hostcompute: made by the first update
                if self._hc_ema is None:
                    self._hc_ema = self._new_hc_ema(self.state.params)
                else:
                    self._hc_ema.update(self.state.params)

    @torch.no_grad()
    def _mirror_ema(self) -> None:
        if self.state.ema_params is not None:
            for k, e in self.state.ema_params.items():
                e.copy_(self.state.params[k])

    @torch.no_grad()
    def _apply_restored(self, ckpt: dict, weights_only: bool, strict: bool) -> None:
        params = self.state.params
        loaded = ckpt["params"]
        if strict and set(loaded) != set(params):
            raise ValueError(f"checkpoint parameters differ from the model's: missing "
                             f"{sorted(set(params) - set(loaded))[:5]}, unexpected "
                             f"{sorted(set(loaded) - set(params))[:5]}")
        def part(t, k, state=False):  # this rank's slice of a whole tensor
            if self.zero is None:
                return t
            return self.zero.state_local(t, k) if state else self.zero.param_local(t, k)

        for k in params.keys() & loaded.keys():
            params[k].copy_(part(loaded[k], k))
        self._drop_hc_ema()
        if weights_only:
            self._mirror_ema()  # the step and optimizer start afresh; a hostcompute
            return              # EMA restarts at ema_start
        opt = ckpt["opt_state"]
        for k in params:
            self.state.opt_state.mu[k].copy_(part(opt["mu"][k], k, state=True))
            self.state.opt_state.nu[k].copy_(part(opt["nu"][k], k, state=True))
        ema = self.state.ema_params
        if ema is not None:
            if "ema_params" in ckpt:
                for k, e in ema.items():
                    e.copy_(part(ckpt["ema_params"][k], k))
            else:  # a stage without EMA chained into one with: mirror the loaded params
                self._mirror_ema()
        elif self.ema_placement == "hostcompute" and "ema_params" in ckpt:
            # the chunks rebuilt from the saved EMA, through the placement's bf16 copy
            # (JAX :553-568); a checkpoint without one leaves them to ema_start
            saved = ckpt["ema_params"]
            self._hc_ema = self._new_hc_ema(
                {k: part(saved[k], k).to(self.device) for k in params})
        self.state = dataclasses.replace(
            self.state, step=int(ckpt["step"]),
            opt_state=AdamState(count=int(opt["count"]), mu=self.state.opt_state.mu,
                                nu=self.state.opt_state.nu))

    # ------------------------------------------------------------------ data

    def _stage_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Start moving a numpy batch to the device: on the card through pinned host
        memory on the copy stream (``_take`` makes the step wait for it)."""
        host = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        if self._copy_stream is None:
            return {k: t.to(self.device) for k, t in host.items()}
        with torch.cuda.stream(self._copy_stream):
            return {k: t.pin_memory().to(self.device, non_blocking=True)
                    for k, t in host.items()}

    def _take(self, staged: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A staged batch, ready for use on the current stream."""
        if self._copy_stream is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_stream(self._copy_stream)
            for t in staged.values():
                t.record_stream(stream)
        return staged

    def _timed_batches(self):
        """The train loader's batches, each pull a ``data.wait`` span whose host time
        is added to ``data_wait_s``."""
        it = iter(self.train_loader)
        try:
            while True:
                with span("data.wait") as wait:
                    batch = next(it, None)
                self.data_wait_s += wait.seconds
                if batch is None:
                    return
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _stage_next(self, batches):
        """Pull and stage the next batch, or None when the loader is exhausted. The
        loader position is recorded before the pull: a checkpoint written after
        this step must not count the staged, untrained batch."""
        self._save_loader_state = (self.train_loader.state_dict()
                                   if hasattr(self.train_loader, "state_dict") else None)
        try:
            batch = next(batches)
        except StopIteration:
            return None
        with span("trainer.stage"):
            return self._stage_batch(batch)

    # ------------------------------------------------------------------ eval

    @staticmethod
    def _one_eval_epoch(loader):
        if not hasattr(loader, "state_dict"):
            yield from loader
            return
        # a LatentsDataLoader: exactly one epoch from its start, its position kept
        saved = loader.state_dict()
        old_epochs = loader.num_epochs
        loader.load_state_dict({"epoch": 0, "step_in_epoch": 0})
        loader.num_epochs = 1
        try:
            yield from loader
        finally:
            loader.num_epochs = old_epochs
            loader.load_state_dict(saved)

    def evaluate(self) -> Optional[float]:
        """Mean eval loss over one epoch of the eval loader (mask ratio 0), one
        host fetch at the end."""
        if self.eval_loader is None:
            return None
        losses = []
        rank = self.mesh.index("batch") if self.mesh is not None else 0
        with self.eval_weights():
            for i, batch in enumerate(self._one_eval_epoch(self.eval_loader)):
                gen = torch.Generator(device=self.device).manual_seed(
                    step_seed(self.seed + 1, i, rank))
                losses.append(self._eval_fn(self._take(self._stage_batch(batch)), gen))
        if self.mesh is not None:  # the mean over every rank's batches
            total = torch.stack([torch.stack(losses).sum() if losses else
                                 torch.zeros((), device=self.device),
                                 torch.tensor(float(len(losses)), device=self.device)])
            dist.all_reduce(total, group=self.mesh.group("batch"))
            if total[1] == 0:
                return None
            eval_loss = float(total[0] / total[1])
        elif not losses:
            return None
        else:
            eval_loss = float(torch.stack(losses).mean())
        self.log({"metrics/eval/loss": eval_loss})
        for cb in self.callbacks:
            cb.eval_end(self, eval_loss)
        return eval_loss

    # ------------------------------------------------------------------ fit

    def _make_step(self):
        """The train step of the trainer's settings: its microbatch, accumulator and
        flow dtypes, ZeRO-2 under a mesh, and the EMA inside the step only for the
        in_state placement."""
        in_step = (self.ema_cfg or {}) if self.ema_placement == "in_state" else {}
        return make_train_step(
            self.model, self.tx, self.lr_schedule, microbatch_size=self.microbatch_size,
            ema_smoothing=in_step.get("smoothing"), ema_start=in_step.get("ema_start", 0),
            ema_update_interval=in_step.get("update_interval", 1),
            accum_dtype=self.accum_dtype, param_flow_dtype=self.param_flow_dtype,
            grad_shardings=self.zero)

    def _train_one_batch(self, batch: Dict[str, torch.Tensor], step: int):
        with span("train.step", device=self.device, unit=step):
            gen = torch.Generator(device=self.device).manual_seed(step_seed(self.seed, step))
            return self._step_fn(self.state, batch, gen)

    def fit(self) -> None:
        for cb in self.callbacks:
            cb.fit_start(self)
        t_start = time.perf_counter()
        self.data_wait_s = 0.0
        last_wait, last_wait_step = 0.0, self.global_step
        self.print(f"training to {self.max_steps}ba from step {self.global_step} on "
                   f"{self.device}, batch {self.global_batch_size}, microbatch "
                   f"{self.microbatch_size}")
        while self.global_step < self.max_steps:
            made_progress = False
            batches = self._timed_batches()
            try:
                staged = self._stage_next(batches)
                while staged is not None:
                    made_progress = True
                    step = self.global_step
                    self.state, metrics = self._train_one_batch(self._take(staged), step)
                    self._host_ema(step)
                    next_step = step + 1
                    # stage the next batch while this step runs; none past the end
                    staged = None
                    if next_step < self.max_steps:
                        staged = self._stage_next(batches)
                    else:
                        self._save_loader_state = None
                    if next_step % self.metric_window == 0 or next_step >= self.max_steps:
                        with span("trainer.metrics"):
                            host = {k: float(v) for k, v in metrics.items()}
                            wait_ms = ((self.data_wait_s - last_wait) * 1e3
                                       / max(1, next_step - last_wait_step))
                            last_wait, last_wait_step = self.data_wait_s, next_step
                            self.log({"loss/train/total": host["loss"],
                                      "trainer/data_wait_ms_per_step": wait_ms,
                                      **{f"trainer/{k}": v for k, v in host.items()
                                         if k != "loss"}})
                            for cb in self.callbacks:
                                cb.step_end(self, host)
                    if self.eval_interval and next_step % self.eval_interval == 0:
                        with span("trainer.eval"):
                            self.evaluate()
                    if self.save_interval and next_step % self.save_interval == 0:
                        with span("trainer.save"):
                            self.save()
            finally:
                batches.close()
            if not made_progress:
                self.print(f"train loader exhausted at step {self.global_step} (before "
                           f"max_duration {self.max_steps}ba); stopping")
                break
        with span("trainer.save"):
            self.save()
        for cb in self.callbacks:
            cb.fit_end(self)
        self.print(f"fit complete: {self.global_step} steps in "
                   f"{(time.perf_counter() - t_start) / 60:.1f} min")
