"""The training loop of the port: counterpart of micro_diffusion_tpu/train/trainer.py
(``Trainer`` :57-772) for one device.

  * one step per batch through ``make_train_step`` (microbatch accumulation, AdamW
    with clipping, EMA in the state: the ``in_state`` placement);
  * the next batch is staged while the step runs: copied into pinned host memory
    and to the card on a side stream, which the step's stream waits for before
    use; never past ``max_duration``;
  * metrics stay on the card and are fetched every ``metric_window`` steps;
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

Not ported, and raising ValueError: the TPU-memory workarounds (``accum_mode:
dispatch``, ``param_flow_dtype``, the ``host_cadence``/``hostcompute`` EMA
placements: README.md, 'Not ported'), a mesh of more than one device (ROADMAP queue
A, parallelism) and loading an orbax (JAX) checkpoint directory.
"""

import contextlib
import dataclasses
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.interop import load_torch_checkpoint
from .callbacks import Callback, Logger
from .optim import AdamState, build_optimizer, build_schedule
from .train_step import create_train_state, make_eval_step, make_train_step

CKPT_FILE = "checkpoint.pt"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def parse_duration(v: Any) -> int:
    """'250000ba' -> 250000 (batches are the only unit, as in the recipes)."""
    if isinstance(v, int):
        return v
    s = str(v)
    if not s.endswith("ba"):
        raise ValueError(f"only 'ba' durations are supported, got {v!r}")
    return int(s[:-2])


def _dtype(name: Optional[str], what: str) -> Optional[torch.dtype]:
    if name is None:
        return None
    if name not in _DTYPES:
        raise ValueError(f"{what} {name!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a function of (seed, step) only."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _step_dirs(folder: str) -> List[int]:
    """Steps with a port checkpoint under ``folder``, ascending."""
    if not os.path.isdir(folder):
        return []
    return sorted(int(d) for d in os.listdir(folder)
                  if d.isdigit() and os.path.exists(os.path.join(folder, d, CKPT_FILE)))


def find_checkpoint(path: str) -> str:
    """The checkpoint file for ``path``: a step directory, or a folder of them
    (the latest step). Raises for an orbax (JAX) checkpoint directory."""
    if os.path.isfile(os.path.join(path, CKPT_FILE)):
        return os.path.join(path, CKPT_FILE)
    steps = _step_dirs(path)
    if steps:
        return os.path.join(path, str(steps[-1]), CKPT_FILE)
    if os.path.isdir(path) and any(d.isdigit() for d in os.listdir(path)):
        raise ValueError(f"{path} looks like an orbax (JAX) checkpoint directory; the port "
                         "loads its own checkpoints and reference .pt files, not orbax")
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
        if accum_mode != "scan":
            raise ValueError(f"accum_mode {accum_mode!r} is a TPU-memory workaround that is "
                             "not ported; 'scan' is (README.md, 'Not ported'; ROADMAP queue A)")
        if param_flow_dtype is not None:
            raise ValueError("param_flow_dtype is a TPU-memory workaround that is not "
                             "ported (README.md, 'Not ported'; ROADMAP queue A)")
        if mesh_shape and any(v not in (None, 1) for v in mesh_shape.values()):
            raise ValueError(f"mesh_shape {mesh_shape}: the port's trainer runs on one "
                             "device (ROADMAP queue A, parallelism)")
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
        self.num_chips = 1
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
            if placement != "in_state":
                raise ValueError(f"EMA placement {placement!r} is a TPU-memory workaround "
                                 "that is not ported; 'in_state' is "
                                 "(README.md, 'Not ported'; ROADMAP queue A)")
            self.ema_cfg = {
                "smoothing": float(ema.get("smoothing", 0.9999)),
                "ema_start": parse_duration(ema.get("ema_start", 0)),
                "update_interval": max(1, parse_duration(ema.get("update_interval", 1))),
                "dtype": _dtype(ema.get("dtype"), "EMA dtype"),
            }

        self.lr_schedule = build_schedule(schedulers, float(optimizer["lr"]), self.max_steps)
        self.tx = build_optimizer(
            dict(model.dit.named_parameters()), self.lr_schedule,
            weight_decay=float(optimizer.get("weight_decay", 0.1)),
            betas=tuple(optimizer.get("betas", (0.9, 0.999))),
            eps=float(optimizer.get("eps", 1e-8)), clip_norm=clip_norm,
            low_precision_moments=bool(optimizer.get("low_precision_moments", False)),
            mu_dtype=_dtype(optimizer.get("mu_dtype"), "mu_dtype"))
        self.state = create_train_state(model.dit, self.tx, use_ema=self.ema_cfg is not None,
                                        ema_dtype=self.ema_cfg["dtype"] if self.ema_cfg else None)
        ema_cfg = self.ema_cfg or {}
        self._step_fn = make_train_step(
            model, self.tx, self.lr_schedule, microbatch_size=self.microbatch_size,
            ema_smoothing=ema_cfg.get("smoothing"), ema_start=ema_cfg.get("ema_start", 0),
            ema_update_interval=ema_cfg.get("update_interval", 1),
            accum_dtype=_dtype(grad_accum_dtype, "grad_accum_dtype"))
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
        print(f"[trainer:{self.run_name}] {msg}", flush=True)

    def log(self, scalars: Dict[str, float]) -> None:
        for logger in self.loggers:
            logger.log_scalars(scalars, self.global_step)

    def close(self) -> None:
        for logger in self.loggers:
            logger.close()

    @contextlib.contextmanager
    def eval_weights(self):
        """Run the model with the EMA weights inside the block, when there is an
        EMA (JAX ``eval_params``); the trained weights are put back after it."""
        ema = self.state.ema_params
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
        if self.save_dir is None:
            return
        step = self.global_step
        path = os.path.join(self.save_dir, str(step), CKPT_FILE)
        if os.path.exists(path):
            return  # already saved at this step (an interval save == the final save)
        loader_state = self._save_loader_state
        if loader_state is None and hasattr(self.train_loader, "state_dict"):
            loader_state = self.train_loader.state_dict()
        opt = self.state.opt_state
        payload = {"step": step, "params": self.state.params,
                   "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu},
                   "loader": loader_state or {}}
        if self.state.ema_params is not None:
            payload["ema_params"] = self.state.ema_params
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in _step_dirs(self.save_dir)[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.save_dir, str(old)))
        self.print(f"saved checkpoint at step {step}")

    def _read(self, path: str) -> dict:
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
            load_torch_checkpoint(load_path, self.model.dit, strict=strict)
            self._mirror_ema()
            self.print(f"loaded torch weights from {load_path}")
            return
        path = find_checkpoint(load_path)
        ckpt = self._read(path)
        self._apply_restored(ckpt, weights_only=weights_only, strict=strict)
        self.print(f"loaded {'weights' if weights_only else 'full state'} from {path} "
                   f"(step {ckpt['step']})")

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
        for k in params.keys() & loaded.keys():
            params[k].copy_(loaded[k])
        if weights_only:
            self._mirror_ema()  # the step and optimizer start afresh
            return
        opt = ckpt["opt_state"]
        for k in params:
            self.state.opt_state.mu[k].copy_(opt["mu"][k])
            self.state.opt_state.nu[k].copy_(opt["nu"][k])
        ema = self.state.ema_params
        if ema is not None:
            if "ema_params" in ckpt:
                for k, e in ema.items():
                    e.copy_(ckpt["ema_params"][k])
            else:  # a stage without EMA chained into one with: mirror the loaded params
                self._mirror_ema()
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
        """The train loader's batches, adding the host time spent waiting on it to
        ``data_wait_s``."""
        it = iter(self.train_loader)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.data_wait_s += time.perf_counter() - t0
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
        with self.eval_weights():
            for i, batch in enumerate(self._one_eval_epoch(self.eval_loader)):
                gen = torch.Generator(device=self.device).manual_seed(step_seed(self.seed + 1, i))
                losses.append(self._eval_fn(self._take(self._stage_batch(batch)), gen))
        if not losses:
            return None
        eval_loss = float(torch.stack(losses).mean())
        self.log({"metrics/eval/loss": eval_loss})
        for cb in self.callbacks:
            cb.eval_end(self, eval_loss)
        return eval_loss

    # ------------------------------------------------------------------ fit

    def _train_one_batch(self, batch: Dict[str, torch.Tensor], step: int):
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
                    next_step = step + 1
                    # stage the next batch while this step runs; none past the end
                    staged = None
                    if next_step < self.max_steps:
                        staged = self._stage_next(batches)
                    else:
                        self._save_loader_state = None
                    if next_step % self.metric_window == 0 or next_step >= self.max_steps:
                        host = {k: float(v) for k, v in metrics.items()}
                        wait_ms = ((self.data_wait_s - last_wait) * 1e3
                                   / max(1, next_step - last_wait_step))
                        last_wait, last_wait_step = self.data_wait_s, next_step
                        self.log({"loss/train/total": host["loss"],
                                  "trainer/data_wait_ms_per_step": wait_ms,
                                  **{f"trainer/{k}": v for k, v in host.items() if k != "loss"}})
                        for cb in self.callbacks:
                            cb.step_end(self, host)
                    if self.eval_interval and next_step % self.eval_interval == 0:
                        self.evaluate()
                    if self.save_interval and next_step % self.save_interval == 0:
                        self.save()
            finally:
                batches.close()
            if not made_progress:
                self.print(f"train loader exhausted at step {self.global_step} (before "
                           f"max_duration {self.max_steps}ba); stopping")
                break
        self.save()
        for cb in self.callbacks:
            cb.fit_end(self)
        self.print(f"fit complete: {self.global_step} steps in "
                   f"{(time.perf_counter() - t_start) / 60:.1f} min")
