"""Federated server: the FairEnergy training loop on the controller API.

Round r (paper Sec. II-A + Algorithm 1), all on the trainer's device:
  1. Rayleigh fading for the round and every client's minibatches, both
     pure in (seed, round) (``repro_torch.random``, the JAX package's
     streams);
  2. every client runs its local steps — all clients at once through the
     ``torch.func`` batched client step — giving stacked flat updates
     [N, D] and their norms ||u_i|| (score-norm kernel);
  3. the controller maps the round's ``RoundObservation`` to a
     ``RoundDecision`` (x, gamma, B) (dual-solve kernel in the FairEnergy
     solver), hard-masked by the battery, which is debited;
  4. the updates are block-top-k sparsified to their gamma_i (top-k
     kernel), combined by the masked |D_i|-weighted mean and applied.

This is the port of ``repro.fl.server`` for the legacy configuration: no
device profile, async rounds, faults, link model, hierarchy, quantization
or mesh (ROADMAP A-11 .. A-18). PyTorch runs eagerly, so ``run_scanned``
is a loop over rounds that materializes its logs on the host once per
chunk; the dual ascent inside the solver still reads its exit residual
on the host every iteration.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from .. import random as prng
from ..core.channel import WirelessNetwork, round_gains
from ..core.controllers import (Controller, ControllerContext,
                                RoundObservation, make_controller)
from ..core.streams import CTRL_STREAM, SAMPLE_STREAM
from ..data.pipeline import (client_sample_keys, sample_client_batches,
                             stack_client_datasets)
from . import compression
from .client import make_batched_client_step
from .updates import tree_spec, unflatten_update

UNLIMITED_J = float("inf")


def resolve_device(device=None) -> torch.device:
    """The trainer's device: ``None`` means the GPU. The port never
    falls back to the CPU silently — pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the GPU; pass "
                "device='cpu' to run it on the CPU")
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass
class RoundLog:
    round: int
    selected: np.ndarray
    gamma: np.ndarray
    bandwidth: np.ndarray
    energy: np.ndarray          # J per client — total (comm + comp)
    accuracy: float             # NaN on rounds skipped by eval_every
    loss: float
    n_selected: int
    battery: Optional[np.ndarray] = None  # J per client after the round
    wall_s: Optional[float] = None        # host seconds for the round,
    #                                       device work included

    @property
    def total_energy(self) -> float:
        return float(self.energy.sum())


class FederatedTrainer:
    """Drives FL rounds for a given controller.

    ``model_loss(params, batch) -> (loss, aux)`` is a function of a params
    dict (e.g. ``repro_torch.models.cnn_loss(model)``); ``model_params``
    maps dotted names to tensors in the JAX package's layout (e.g.
    ``dict(model.named_parameters())`` or
    ``repro_torch.convert.params_from_numpy``); ``eval_fn(params)`` returns
    the accuracy as a scalar tensor. ``client_datasets`` are
    ``ClientDataset``s or dicts of numpy arrays.

    ``device=None`` runs on the GPU and raises when none is visible;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.
    """

    def __init__(self, *, model_loss: Callable, model_params: dict,
                 client_datasets, eval_fn: Callable, fl_cfg, fe_cfg, ch_cfg,
                 controller: Union[str, Controller] = "fairenergy",
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        dev = self.device
        self.loss_fn = model_loss
        self.params = {k: torch.as_tensor(v).detach().to(dev, copy=True)
                       for k, v in model_params.items()}
        self.eval_fn = eval_fn
        self.fl_cfg, self.fe_cfg, self.ch_cfg = fl_cfg, fe_cfg, ch_cfg
        self.n_clients = len(client_datasets)
        if ch_cfg.n_clients != self.n_clients:
            raise ValueError(f"ch_cfg.n_clients={ch_cfg.n_clients} but "
                             f"{self.n_clients} client datasets")
        self.network = WirelessNetwork(ch_cfg, seed=seed)
        self.spec = tree_spec(self.params)
        self.n_params = int(sum(self.spec.sizes))
        self.s_bits = 32.0 * self.n_params
        self.i_bits = float(self.n_params)            # 1-bit/coeff kept-mask
        ctx = ControllerContext(
            n_clients=self.n_clients, b_tot=ch_cfg.bandwidth_total,
            s_bits=self.s_bits, i_bits=self.i_bits, n0=ch_cfg.noise_density,
            fe_cfg=fe_cfg, device=dev)
        self.controller = make_controller(controller, ctx)
        self.controller_name = (controller if isinstance(controller, str)
                                else getattr(controller, "name",
                                             type(controller).__name__.lower()))
        self.ctrl_state = self.controller.init(self.n_clients)

        self.seed = seed
        # independent streams off one per-seed base key (fading uses the
        # base itself, folded by round); keys stay on the host, where the
        # [N]-sized hashes are cheapest
        base = prng.PRNGKey(seed)
        self.key = prng.fold_in(base, CTRL_STREAM)            # controller
        self.sample_key = prng.fold_in(base, SAMPLE_STREAM)
        self._client_step = make_batched_client_step(model_loss, fl_cfg.lr)
        self._P = torch.as_tensor(self.network.power, dtype=torch.float32,
                                  device=dev)
        self._pathloss = torch.as_tensor(self.network.pathloss,
                                         dtype=torch.float32)
        self._data = stack_client_datasets(client_datasets, dev)
        lengths = self._data.lengths.cpu().numpy().astype(np.float64)
        self.weights = lengths / lengths.sum()
        self._weights = torch.as_tensor(self.weights, dtype=torch.float32,
                                        device=dev)
        # battery charge carried across rounds; unlimited without a device
        # profile (profiles arrive with ROADMAP A-11)
        self._battery = torch.full((self.n_clients,), UNLIMITED_J,
                                   dtype=torch.float32, device=dev)
        self._calibrated = False
        self.history: list[RoundLog] = []

    # ------------------------------------------------------------------
    @property
    def battery(self) -> np.ndarray:
        """[N] current per-client battery charge (J; inf = unlimited)."""
        return self._battery.cpu().numpy()

    def _round_batches(self, r: int) -> dict:
        """Round-r minibatches [N, steps, batch, ...] on the device."""
        ckeys = client_sample_keys(self.sample_key, r, self.n_clients)
        return sample_client_batches(self._data.arrays, self._data.lengths,
                                     ckeys, self.fl_cfg.local_steps,
                                     self.fl_cfg.local_batch)

    def _maybe_calibrate(self, r: int):
        """One-shot eta_auto calibration from round-r observations, then a
        fresh controller state so the calibrated eta reaches the solver."""
        if self._calibrated:
            return
        if not getattr(self.controller, "needs_calibration", False):
            return
        with torch.no_grad():
            _, u_norms, _ = self._client_step(self.params,
                                              self._round_batches(r))
        self.controller.calibrate(u_norms.cpu().numpy(),
                                  self.network.gains(r), self.network.power)
        self.ctrl_state = self.controller.init(self.n_clients)
        self._calibrated = True

    @torch.no_grad()
    def _round(self, r: int, evaluate: bool) -> dict:
        """One round of the legacy core: observe, decide, hard mask,
        battery debit, sparsify, weighted mean, apply, eval. Returns the
        round's outputs as device tensors."""
        h = round_gains(self.network.fade_key, self._pathloss, r,
                        self.ch_cfg.rayleigh).to(self.device)
        updates, u_norms, losses = self._client_step(self.params,
                                                     self._round_batches(r))
        alive = self._battery > 0.0
        obs = RoundObservation(u_norms=u_norms, h=h, P=self._P, round=r,
                               key=prng.fold_in(self.key, r), alive=alive)
        dec, self.ctrl_state = self.controller.decide(obs, self.ctrl_state)
        # hard mask, whatever the controller decided: a depleted client
        # transmits nothing and is charged nothing
        x = dec.x & alive
        mf = x.to(torch.float32)
        dec = dec._replace(x=x, gamma=dec.gamma * mf,
                           bandwidth=dec.bandwidth * mf,
                           energy=dec.energy * mf,
                           bw_used=torch.sum(dec.bandwidth * mf))
        self._battery = torch.clamp(self._battery - dec.energy, min=0.0)
        # unselected rows carry zero weight; gamma=1 lets them copy through
        gamma = torch.where(dec.x, torch.clamp(dec.gamma, 1e-6, 1.0), 1.0)
        sparse = compression.batch_block_topk(updates, gamma)
        w = dec.x.to(torch.float32) * self._weights
        partial, wsum = w @ sparse, torch.sum(w)
        agg = partial / torch.clamp(wsum, min=1e-12) * self.fl_cfg.server_lr
        agg = torch.where(wsum > 0.0, agg, 0.0)
        delta = unflatten_update(agg, self.spec)
        self.params = {k: p + delta[k].to(p.dtype)
                       for k, p in self.params.items()}
        acc = (self.eval_fn(self.params).to(torch.float32) if evaluate
               else torch.tensor(float("nan"), device=self.device))
        return dict(x=dec.x, gamma=dec.gamma, bandwidth=dec.bandwidth,
                    energy=dec.energy, accuracy=acc,
                    loss=torch.mean(losses), battery=self._battery)

    def _append_logs(self, start: int, outs: list, walls: list) -> None:
        """Materialize one chunk of round outputs (one host copy)."""
        host = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
                for k in outs[0]}
        for i in range(len(outs)):
            x = host["x"][i]
            self.history.append(RoundLog(
                round=start + i, selected=x, gamma=host["gamma"][i],
                bandwidth=host["bandwidth"][i], energy=host["energy"][i],
                accuracy=float(host["accuracy"][i]),
                loss=float(host["loss"][i]), n_selected=int(x.sum()),
                battery=host["battery"][i], wall_s=walls[i]))

    def run_round(self, r: int) -> RoundLog:
        """One round with its log — the debug path; it runs the same
        round body as ``run_scanned``."""
        self._maybe_calibrate(r)
        t0 = time.perf_counter()
        out = self._round(r, evaluate=True)
        self._append_logs(r, [out], [self._wall(t0)])
        return self.history[-1]

    def _wall(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def run_scanned(self, rounds: Optional[int] = None, *,
                    chunk: Optional[int] = None, eval_every: int = 1,
                    verbose: bool = True):
        """Run ``rounds`` FL rounds from round 0; append to ``history``
        and return it.

        ``chunk`` bounds the rounds whose logs are gathered to the host
        together (default: all); ``eval_every`` strides the accuracy
        evaluation (skipped rounds log ``accuracy=NaN``; the final round
        is always evaluated). All randomness is pure in (seed, round), so
        a second call replays the same batches and channels."""
        rounds = rounds or self.fl_cfg.rounds
        chunk = min(chunk or rounds, rounds)
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every} "
                             "(it strides the eval; use a large value to "
                             "evaluate only the final round)")
        self._maybe_calibrate(0)
        for s in range(0, rounds, chunk):
            n = min(chunk, rounds - s)
            outs, walls = [], []
            for r in range(s, s + n):
                t0 = time.perf_counter()
                outs.append(self._round(
                    r, evaluate=(r % eval_every == 0) or r == rounds - 1))
                walls.append(self._wall(t0))
            self._append_logs(s, outs, walls)
            if verbose:
                lg = self.history[-1]
                print(f"[{self.controller_name}] rounds {s:4d}..{s + n - 1:4d} "
                      f"acc={lg.accuracy:.4f} sel={lg.n_selected:2d} "
                      f"E={lg.total_energy*1e3:.3f} mJ")
        return self.history

    # -------------------------------------------------------- statistics ----
    def participation_counts(self) -> np.ndarray:
        return np.sum([lg.selected for lg in self.history], axis=0)

    def energy_per_round(self) -> np.ndarray:
        return np.array([lg.total_energy for lg in self.history])

    def accuracy_curve(self) -> np.ndarray:
        return np.array([lg.accuracy for lg in self.history])

    def energy_to_accuracy(self, target: float) -> float | None:
        cum = 0.0
        for lg in self.history:
            cum += lg.total_energy
            if lg.accuracy >= target:
                return cum
        return None

    def mean_gamma_selected(self) -> float:
        vals = [g for lg in self.history for g in lg.gamma[lg.selected]]
        return float(np.mean(vals)) if vals else 1.0

    def min_bandwidth_selected(self) -> float:
        vals = [b for lg in self.history for b in lg.bandwidth[lg.selected] if b > 0]
        return float(np.min(vals)) if vals else self.ch_cfg.bandwidth_total
