"""Training driver (port of ``repro.train.train_loop``): checkpoint and
restart, straggler detection, failure handling, the parts that live above
the step function.

  * a checkpoint every ``ckpt_every`` steps, non-blocking, atomic,
    cataloged in a Honeycomb store (restore = floor lookup, the paper's
    SCAN semantics);
  * on restart, ``TrainLoop.restore_latest`` loads the newest checkpoint
    onto the card and seeks the data pipeline to its step;
  * straggler mitigation: each step's time is tracked against an EMA
    watermark; a step slower than ``straggler_factor`` x the EMA raises a
    callback and does not move the watermark; the first step (kernel
    builds, allocator warm-up) never seeds it;
  * data-pipeline starvation is counted apart (input against compute).

Step times are on the host clock (``core.telemetry.CLOCK``) around the
step, ending in a synchronisation on the loss's device.
"""
from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path
from typing import Callable

import torch

from ..core.telemetry import CLOCK
from ..data.pipeline import DataPipeline, SyntheticSource
from ..launch import steps
from ..models import schema as sc
from ..models import transformer as tf
from . import optimizer as opt
from .checkpoint import CheckpointManager


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    ema_alpha: float = 0.2


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class TrainLoop:
    def __init__(self, step_fn: Callable, params, opt_state,
                 pipeline: DataPipeline, ckpt: CheckpointManager,
                 cfg: LoopConfig = LoopConfig(),
                 on_straggler: Callable[[int, float], None] | None = None):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.step = int(opt_state.step) if hasattr(opt_state, "step") else 0
        self.metrics_log: list[dict] = []
        self.straggler_events: list[tuple[int, float]] = []
        self._ema: float | None = None
        self._timed_steps = 0

    # ------------------------------------------------------------ restore
    def restore_latest(self, device=None) -> bool:
        """Load the newest cataloged checkpoint onto ``device`` (the
        device of the loop's parameters when None) and seek the pipeline
        to its step.  False when the catalog is empty."""
        s = self.ckpt.latest_step()
        if s is None:
            return False
        device = device or sc.flatten(self.params)[0].device
        (self.params, self.opt_state), _ = self.ckpt.restore(
            s, (self.params, self.opt_state), device=device)
        self.step = s
        self.pipeline.seek(s)       # deterministic data resume
        return True

    # --------------------------------------------------------------- run
    def run(self, steps: int | None = None) -> dict:
        target = self.step + (steps or self.cfg.total_steps)
        while self.step < target:
            batch = next(self.pipeline)
            t0 = CLOCK()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            _sync(metrics["loss"])
            dt = CLOCK() - t0
            self.step += 1

            self._timed_steps += 1
            if self._timed_steps == 1:
                pass          # the first step builds and warms: never seeds
            elif self._ema is None:
                self._ema = dt
            elif dt > self.cfg.straggler_factor * self._ema:
                self.straggler_events.append((self.step, dt))
                if self.on_straggler:
                    self.on_straggler(self.step, dt)
                # slow steps do not poison the watermark
            else:
                a = self.cfg.ema_alpha
                self._ema = (1 - a) * self._ema + a * dt

            if self.step % self.cfg.log_every == 0 or self.step == target:
                self.metrics_log.append(
                    {"step": self.step,
                     "loss": float(metrics["loss"]),
                     "gnorm": float(metrics["gnorm"]),
                     "step_time_s": dt,
                     "starvations": self.pipeline.starvations})
            if self.step % self.cfg.ckpt_every == 0:
                self.ckpt.save(self.step,
                               (self.params, self.opt_state),
                               blocking=False)
        self.ckpt.wait()
        return {"final_step": self.step,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None,
                "stragglers": len(self.straggler_events)}


def build_smoke_loop(cfg, *, batch: int = 8, seq: int = 64,
                     ckpt_dir: str | Path | None = None,
                     opt_cfg: opt.AdamWConfig | None = None,
                     loop_cfg: LoopConfig = LoopConfig(),
                     device: str | torch.device = "cuda", seed: int = 0):
    """One-device training loop for a reduced config (examples, tests).

    Parameters are drawn on the host from ``torch.Generator()`` seeded
    with ``seed`` and moved to ``device``, so a CPU loop and a card loop
    start from the same bits.  Each step is ``steps.train_step`` with one
    microbatch: the loss and its gradients, then AdamW.  Checkpoints go
    to ``ckpt_dir`` (a directory under the system's temporary directory
    when None), keeping 2."""
    ckpt_dir = ckpt_dir or Path(tempfile.gettempdir()) / "repro_torch_ckpt"
    ckpt = CheckpointManager(ckpt_dir, keep=2, device=device)  # checks it
    params = sc.map_tree(lambda t: t.to(ckpt.device), sc.init(
        tf.schema(cfg), torch.Generator().manual_seed(seed), "cpu"))
    opt_cfg = opt_cfg or opt.AdamWConfig(lr=1e-3, warmup_steps=10,
                                         total_steps=loop_cfg.total_steps)

    def step_fn(params, opt_state, batch):
        return steps.train_step(params, opt_state, batch, cfg, opt_cfg,
                                accum=1)

    pipe = DataPipeline(SyntheticSource(cfg.vocab), global_batch=batch,
                        seq_len=seq)
    return TrainLoop(step_fn, params, opt.init(params), pipe, ckpt,
                     loop_cfg)
