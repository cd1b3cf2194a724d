"""Episode-level online learning (counterpart of
``gpmpc_tpu/learning/online_learner.py``): the episode lifecycle, the
end-of-episode GP refit on a diverse subset, safe-set expansion on success,
hyperparameter retuning every ``retrain_every`` episodes, the GP activation
gate, statistics, ``.npz`` persistence and the closed-loop
``IterativeLearningRunner`` with its optional safety filter.

Episodes fly as a host loop over the lanes-first controller protocol (one
lane per episode, the JAX runner's unbatched episode); the bookkeeping
between episodes runs on the host over the learner's tensors, on the
learner's device. Random draws come from the learner's ``torch.Generator``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import torch

from .._device import DeviceLike, as_f32, resolve_device
from ..gp.sparse_gp import refit_sparse_multi
from ..gp.structured_gp import Simple3DoFGP, StructuredGPConfig
from ..terminal.safe_set import SafeSet
from .data_manager import DataManager
from .hyperparameter_tuner import HyperparameterConfig, HyperparameterTuner
from .novelty_selector import NoveltyConfig, NoveltySelector, select_diverse

Tensor = torch.Tensor


@dataclass
class OnlineLearningConfig:
    """Field names and defaults are those of the JAX ``OnlineLearningConfig``."""

    buffer_capacity: int = 1024
    batch_refit_points: int = 256
    update_interval: int = 10  # in-episode incremental update cadence
    retrain_every: int = 5  # hyperparameter retune cadence (episodes)
    min_episodes_before_gp: int = 1  # GP activation gate
    residual_mode: str = "velocity"
    dt: float = 0.1
    novelty: NoveltyConfig = field(default_factory=NoveltyConfig)
    hyper: HyperparameterConfig = field(default_factory=HyperparameterConfig)
    gp: StructuredGPConfig = field(default_factory=StructuredGPConfig)


@dataclass
class LearningStatistics:
    episodes: int = 0
    successes: int = 0
    episode_costs: list = field(default_factory=list)
    episode_outcomes: list = field(default_factory=list)
    gp_refits: int = 0
    hyper_retunes: int = 0

    @property
    def success_rate(self) -> float:
        return self.successes / max(self.episodes, 1)


class OnlineLearner:
    """Host-side orchestrator of the learning loop, its tensors on ``device``."""

    def __init__(self, step_fn: Callable[[Tensor, Tensor], Tensor],
                 config: Optional[OnlineLearningConfig] = None,
                 safe_set: Optional[SafeSet] = None, n_x: int = 7, n_u: int = 3,
                 device: DeviceLike = "cuda"):
        self.config = config or OnlineLearningConfig()
        self.device = resolve_device(device)
        self.step_fn = step_fn
        self.n_x, self.n_u = n_x, n_u
        self.data = DataManager.create(self.config.buffer_capacity, n_x, n_u,
                                       dt=self.config.dt, residual_mode=self.config.residual_mode,
                                       device=self.device)
        self.gp = Simple3DoFGP.create(self.config.gp, device=self.device) if n_x == 7 else None
        self.safe_set = safe_set
        self.novelty = NoveltySelector(self.config.novelty)
        self.tuner = HyperparameterTuner(self.config.hyper)
        self.stats = LearningStatistics()
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    # -- episode lifecycle ---------------------------------------------------

    def add_transition(self, x: Tensor, u: Tensor, x_next: Tensor) -> None:
        """Record one transition (unbatched vectors) of the current episode."""
        self.data = self.data.add_transition(self.step_fn, x, u, x_next, self.stats.episodes)

    def gp_active(self) -> bool:
        """The activation gate: a fitted GP after ``min_episodes_before_gp``."""
        return (self.gp is not None and self.gp.is_fitted
                and self.stats.episodes >= self.config.min_episodes_before_gp)

    def predict_residual(self, x: Tensor, u: Tensor):
        """(lifted residual mean (..., n_x), variance (..., 3)); zero while
        the GP is gated off."""
        if not self.gp_active():
            return x.new_zeros(*x.shape[:-1], self.n_x), x.new_zeros(*x.shape[:-1], 3)
        mean, var = self.gp.predict(x, u)
        return Simple3DoFGP.lift_residual(mean, self.n_x), var

    def end_episode(self, succeeded: bool, episode_cost: float,
                    trajectory: Optional[tuple] = None) -> None:
        """Close the episode: resolve its success flag, count it, add a
        successful ``trajectory`` (X, U, stage costs) to the safe set, refit
        the GP on a diverse subset and retune on the cadence."""
        ep = self.stats.episodes
        self.data = self.data.end_episode(ep, bool(succeeded))
        self.stats.episodes += 1
        self.stats.successes += int(succeeded)
        self.stats.episode_costs.append(float(episode_cost))
        self.stats.episode_outcomes.append(bool(succeeded))
        if succeeded and self.safe_set is not None and trajectory is not None:
            X, U, costs = trajectory
            self.safe_set = self.safe_set.add_trajectory(X, U, costs)
        self._batch_gp_update()
        if self.gp_active() and self.tuner.should_retrain(self.stats.episodes):
            self._retrain_hyperparameters()

    # -- GP updates ----------------------------------------------------------

    def _batch_gp_update(self) -> None:
        store = self.data.store
        n = int(store.count)
        if n < 8 or self.gp is None:
            return
        k_sel = min(self.config.batch_refit_points, self.config.gp.max_data_points)
        idx = select_diverse(self.generator, store.X, min(k_sel, n),
                             mask=self.data.training_mask())
        gp = Simple3DoFGP.create(self.config.gp, device=self.device)
        gp = gp.add_data_batch(store.X[idx], store.U[idx], store.R[idx])
        self.gp = gp.fit(self.generator)
        self.stats.gp_refits += 1

    def _retrain_hyperparameters(self) -> None:
        """Retune the velocity GP's kernels (every output on its own
        objective) against the sparse objective, then refit the factors."""
        g, buf = self.gp.gp, self.gp.buffer
        YT = buf.Y.transpose(-1, -2)
        kernels, log_noise, _ = self.tuner.tune(g.kernels, g.Z, buf.X, YT, buf.mask,
                                                g.log_noise, method=g.method)
        self.gp = replace(self.gp, gp=refit_sparse_multi(kernels, g.Z, buf.X, YT, buf.mask,
                                                         log_noise, g.method))
        self.stats.hyper_retunes += 1

    # -- statistics and persistence -----------------------------------------

    def get_statistics(self) -> dict:
        return {
            "episodes": self.stats.episodes,
            "successes": self.stats.successes,
            "success_rate": self.stats.success_rate,
            "gp_refits": self.stats.gp_refits,
            "hyper_retunes": self.stats.hyper_retunes,
            "buffer_count": int(self.data.store.count),
            "episode_costs": list(self.stats.episode_costs),
        }

    def save(self, directory: str) -> None:
        """The transition store, the fitted GP and the safe set as ``.npz``."""
        os.makedirs(directory, exist_ok=True)
        self.data.save(os.path.join(directory, "data.npz"))
        if self.gp is not None and self.gp.is_fitted:
            self.gp.save(os.path.join(directory, "gp.npz"))
        if self.safe_set is not None:
            self.safe_set.save(os.path.join(directory, "safe_set.npz"))

    def load(self, directory: str) -> None:
        """Read back what :meth:`save` wrote (the GP into a fitted learner's
        structure, as the JAX package does)."""
        self.data = self.data.load(os.path.join(directory, "data.npz"))
        gp_path = os.path.join(directory, "gp.npz")
        if self.gp is not None and os.path.exists(gp_path) and self.gp.is_fitted:
            self.gp = self.gp.load(gp_path)
        ss_path = os.path.join(directory, "safe_set.npz")
        if self.safe_set is not None and os.path.exists(ss_path):
            self.safe_set = self.safe_set.load(ss_path)


class IterativeLearningRunner:
    """The closed loop: controller → (optional safety filter) → plant →
    record → episode end. ``controller_factory(learner) → (cinit, cstep)``
    (the Monte-Carlo protocol) lets each episode's controller see the
    freshest GP; ``safety_filter(x, u) → u`` acts on (B, n_x), (B, n_u)."""

    def __init__(self, learner: OnlineLearner, plant_step: Callable[[Tensor, Tensor], Tensor],
                 controller_factory: Callable,
                 safety_filter: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
                 landing_altitude: float = 0.1, max_steps: int = 150,
                 success_speed: float = 2.0):
        self.learner = learner
        self.plant_step = plant_step
        self.controller_factory = controller_factory
        self.safety_filter = safety_filter
        self.landing_altitude = landing_altitude
        self.max_steps = max_steps
        self.success_speed = success_speed

    def run_episode(self, x0: Tensor) -> dict:
        """Fly one episode from x0 (n_x,) for ``max_steps`` steps, a landed
        lane frozen; record its real transitions and close the episode."""
        cinit, cstep = self.controller_factory(self.learner)
        x = as_f32(x0, self.learner.device)[None]
        cstate = cinit(x)
        landed = torch.zeros(1, dtype=torch.bool, device=x.device)
        X, U, X_next = [], [], []
        for k in range(self.max_steps):
            u, cstate = cstep(cstate, x, k)
            if self.safety_filter is not None:
                u = self.safety_filter(x, u)
            x_next = self.plant_step(x, u)
            x_out = torch.where(landed[:, None], x, x_next)
            landed = landed | (x_next[:, 1] < self.landing_altitude)
            X.append(x[0])
            U.append(u[0])
            X_next.append(x_out[0])
            x = x_out
        X, U, X_next = torch.stack(X), torch.stack(U), torch.stack(X_next)
        # record the real (pre-touchdown) transitions
        moved = ((X_next - X).abs() > 1e-12).any(dim=1).tolist()
        for i, m in enumerate(moved):
            if m:
                self.learner.add_transition(X[i], U[i], X_next[i])
        speed = float(torch.linalg.vector_norm(x[0, 4:7]))
        success = bool(landed[0]) and speed < self.success_speed
        cost = float(torch.linalg.vector_norm(U, dim=1).sum())
        self.learner.end_episode(success, cost)
        return {"x_final": x[0], "landed": bool(landed[0]), "success": success,
                "touchdown_speed": speed, "cost": cost}

    def run(self, x0s: Tensor) -> list:
        return [self.run_episode(x0s[i]) for i in range(x0s.shape[0])]
