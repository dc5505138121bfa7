"""Training loop with energy / carbon metering (the port of
``repro.training.train``; paper §4 "sustainable LLM training": training
has no latency SLO, so its carbon can be scheduled). Each step is
``Model.train_loss`` -> ``.backward()`` -> ``adamw_update``, eager; the
meter attributes each step's energy analytically on a hardware profile
and region, with the reference's counts, so J and gCO2 equal the JAX
``Trainer``'s on the same profile and region.

On the card the attention and RMSNorm kernels run inside autograd
Functions (``kernels/autograd.py``); the CPU runs only when asked for
(``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.core.energy import StepCounts, step_energy
from repro_torch.core.hardware import get_profile
from repro_torch.core.meter import CarbonMeter
from repro_torch.device import resolve_device
from repro_torch.models.costing import model_flops, workload_of
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optim import (AdamWConfig, adamw_init, adamw_update,
                                        cosine_schedule, tree_map,
                                        unique_leaves, wsd_schedule)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0                  # 0 = no checkpoints
    ckpt_dir: str = "/tmp/repro_ckpt"
    schedule: str = "wsd"                # "wsd" | "cosine"
    warmup: int = 10
    decay_frac: float = 0.2              # WSD decay tail fraction
    optim: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    remat: bool = False
    # carbon metering target
    profile: str = "tpu_v5e"
    region: str = "CISO"
    n_devices: int = 1


def make_schedule(cfg: TrainConfig):
    if cfg.schedule == "wsd":
        decay = max(1, int(cfg.steps * cfg.decay_frac))
        stable = max(0, cfg.steps - cfg.warmup - decay)
        return wsd_schedule(cfg.warmup, stable, decay)
    return cosine_schedule(cfg.warmup, cfg.steps)


class Trainer:
    """Trains ``model`` from random parameters (``model.init(generator)``,
    or ``params`` when given) on ``model``'s device, which must be
    ``device``. ``fit`` returns the logged history: every metric of
    ``train_loss`` and ``adamw_update`` as floats, with ``step`` and
    ``wall_s``, at step 1 and every ``log_every`` steps."""

    def __init__(self, model: Model, tcfg: TrainConfig,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device] = "cuda",
                 params: Optional[Dict] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the trainer "
                             f"on {self.device}")
        self.model = model
        self.tcfg = tcfg
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            params = model.init(generator)
        self.params = params
        self._track()
        self.opt_state = adamw_init(self.params, tcfg.optim)
        self.schedule = make_schedule(tcfg)
        self.step = 0
        self.meter = CarbonMeter(get_profile(tcfg.profile), tcfg.region,
                                 n_devices=tcfg.n_devices)
        self.workload = workload_of(model.cfg)
        self.history: list = []

    def _track(self) -> None:
        for _, p in unique_leaves(self.params):
            p.requires_grad_(p.is_floating_point())

    def device_batch(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        """A numpy batch (``lm_batches``) as tensors on the device."""
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """One step on a batch of device tensors: the loss, its gradient,
        the AdamW update in place. Returns the metrics (tensors, and
        ``lr``)."""
        loss, metrics = self.model.train_loss(self.params, batch,
                                              remat=self.tcfg.remat)
        loss.backward()
        grads = tree_map(lambda p: p.grad, self.params)
        _, self.opt_state, om = adamw_update(
            self.params, grads, self.opt_state, self.tcfg.optim,
            self.schedule(self.step))
        for _, p in unique_leaves(self.params):
            p.grad = None
        return {**{k: v.detach() for k, v in metrics.items()}, **om}

    def _meter_step(self, batch_tokens: int):
        """Attribute the step's energy on the target profile (analytic)."""
        flops = model_flops(self.model.cfg, batch_tokens, training=True)
        w = self.workload
        bytes_ = w.params_bytes * 4.0 + batch_tokens * w.d_model * 24.0
        counts = StepCounts(flops=flops, hbm_bytes=bytes_,
                            working_set_bytes=w.params_bytes * 8,
                            tokens=float(batch_tokens),
                            compute_tokens=float(batch_tokens))
        rep = step_energy(self.meter.profile, counts)
        self.meter.record("train", rep.tokens, rep.t_total, rep.energy_j)

    def fit(self, batches: Iterator[Dict[str, np.ndarray]],
            verbose: bool = True) -> list:
        t0 = time.time()
        maybe = (ckpt.latest(self.tcfg.ckpt_dir) if self.tcfg.ckpt_every
                 else None)
        if maybe:
            state, step = ckpt.restore(maybe, (self.params, self.opt_state))
            self.params, self.opt_state = state
            self._track()
            self.step = step or 0
        while self.step < self.tcfg.steps:
            batch = self.device_batch(next(batches))
            metrics = self.train_step(batch)
            self._meter_step(int(batch["tokens"].numel()))
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == 1:
                row = {k: float(v) for k, v in metrics.items()}
                row["step"] = self.step
                row["wall_s"] = time.time() - t0
                self.history.append(row)
                if verbose:
                    print(f"step {self.step:>5} loss {row['loss']:.4f} "
                          f"lr {row['lr']:.2e} gnorm {row['grad_norm']:.3f}")
            if (self.tcfg.ckpt_every
                    and self.step % self.tcfg.ckpt_every == 0):
                os.makedirs(self.tcfg.ckpt_dir, exist_ok=True)
                ckpt.save(os.path.join(self.tcfg.ckpt_dir,
                                       f"ckpt_{self.step}{ckpt.SUFFIX}"),
                          (self.params, self.opt_state), step=self.step)
        return self.history
