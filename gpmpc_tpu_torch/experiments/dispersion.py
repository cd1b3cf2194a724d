"""Dispersion models and fault injection, lanes first (counterpart of
``gpmpc_tpu/experiments/dispersion.py``): the wind models NONE / CONSTANT /
GUST / DRYDEN, thrust dispersion (a per-episode scale and misalignment, a
per-step fluctuation), the preset levels nominal / low / medium / high, and
the dispersed plant that injects all of it into the plant step.

Randomness comes from an explicit ``torch.Generator``. Each random quantity
is drawn as a standard-normal block apart from the deterministic map that
uses it (:func:`init_dispersed_state`, :func:`dispersed_step`), so the same
draws can be fed to both packages. The JAX package splits a key per lane
and per step; the port draws a (B,) or (B, 3) block a step from one
generator, so lanes differ from the JAX package's by construction and
campaigns are compared by their statistics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import torch

from .._device import DeviceLike, resolve_device

Tensor = torch.Tensor

WIND_NONE = 0
WIND_CONSTANT = 1
WIND_GUST = 2
WIND_DRYDEN = 3
DRYDEN_DT = 0.1  # the Dryden filter's step (the JAX package's)


@dataclass(frozen=True)
class WindConfig:
    model: int = WIND_NONE
    speed: tuple = (0.0, 0.0, 0.0)
    gust_amplitude: float = 0.5
    gust_period: float = 3.0
    # Dryden-like first-order colored noise
    dryden_sigma: float = 0.3
    dryden_tau: float = 2.0


def wind_velocity(cfg: WindConfig, xi: Optional[Tensor], t, wind_state: Tensor):
    """Wind velocity (…, 3) at time t (a number or (…,)) and the carried
    filter state (…, 3); ``xi`` (…, 3) is the Dryden model's standard-normal
    draw (unused by the other models)."""
    speed = wind_state.new_tensor(cfg.speed)
    if cfg.model == WIND_NONE:
        return torch.zeros_like(wind_state), wind_state
    if cfg.model == WIND_CONSTANT:
        return speed.expand_as(wind_state), wind_state
    if cfg.model == WIND_GUST:
        t = torch.as_tensor(t, dtype=wind_state.dtype, device=wind_state.device)
        phase = 2.0 * math.pi * t / cfg.gust_period
        return (speed + cfg.gust_amplitude * torch.sin(phase)[..., None]
                * wind_state.new_tensor([0.0, 1.0, 0.5])), wind_state
    if cfg.model == WIND_DRYDEN:
        # first-order Gauss-Markov: w⁺ = (1−dt/τ) w + σ√(2dt/τ) ξ
        a = 1.0 - DRYDEN_DT / cfg.dryden_tau
        w_new = a * wind_state + cfg.dryden_sigma * math.sqrt(2 * DRYDEN_DT / cfg.dryden_tau) * xi
        return speed + w_new, w_new
    raise ValueError(f"unknown wind model {cfg.model}")


@dataclass(frozen=True)
class DispersionConfig:
    """The full dispersion set, with the JAX package's presets."""

    wind: WindConfig = field(default_factory=WindConfig)
    cd_scale_std: float = 0.0  # aero (acts when the plant has drag enabled)
    thrust_scale_std: float = 0.0  # multiplicative scale sampled per episode
    thrust_misalign_deg: float = 0.0  # fixed misalignment sampled per episode
    thrust_fluctuation_std: float = 0.0  # per-step multiplicative noise
    wind_drag_coeff: float = 0.05  # acceleration per unit wind speed

    def replace(self, **kw) -> "DispersionConfig":
        return replace(self, **kw)

    @classmethod
    def nominal(cls):
        return cls()

    @classmethod
    def low(cls):
        return cls(wind=WindConfig(model=WIND_CONSTANT, speed=(0.0, 0.1, 0.0)),
                   thrust_scale_std=0.01, thrust_fluctuation_std=0.005)

    @classmethod
    def medium(cls):
        return cls(wind=WindConfig(model=WIND_GUST, speed=(0.0, 0.2, 0.1), gust_amplitude=0.3),
                   thrust_scale_std=0.03, thrust_misalign_deg=1.0, thrust_fluctuation_std=0.01)

    @classmethod
    def high(cls):
        return cls(wind=WindConfig(model=WIND_DRYDEN, speed=(0.0, 0.4, 0.2), dryden_sigma=0.5),
                   thrust_scale_std=0.05, thrust_misalign_deg=2.0, thrust_fluctuation_std=0.03)

    @classmethod
    def preset(cls, name: str):
        return {"nominal": cls.nominal, "low": cls.low, "medium": cls.medium,
                "high": cls.high}[name]()


@dataclass
class DispersedState:
    """Per-lane dispersion carry: the wind filter state, the per-episode
    multipliers, and the step count."""

    wind_state: Tensor  # (B, 3)
    thrust_scale: Tensor  # (B,) per-episode multiplicative factor
    misalign: Tensor  # (B, 3, 3) per-episode rotation
    step: Tensor  # (B,) int32

    def replace(self, **kw) -> "DispersedState":
        return replace(self, **kw)


def _small_rotation(angle_std_rad: float, xi: Tensor) -> Tensor:
    """First-order small rotation I + [w]× with w = angle_std_rad·ξ; ξ (…, 3)."""
    w = angle_std_rad * xi
    z = torch.zeros_like(w[..., 0])
    W = torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                     torch.stack([w[..., 2], z, -w[..., 0]], -1),
                     torch.stack([-w[..., 1], w[..., 0], z], -1)], dim=-2)
    return torch.eye(3, dtype=w.dtype, device=w.device) + W


def init_dispersed_state(config: DispersionConfig, z_scale: Tensor, z_misalign: Tensor
                         ) -> DispersedState:
    """The episode's dispersion from its standard-normal draws: z_scale (B,)
    for the thrust scale, z_misalign (B, 3) for the misalignment."""
    return DispersedState(
        wind_state=z_misalign.new_zeros(z_misalign.shape),
        thrust_scale=1.0 + config.thrust_scale_std * z_scale,
        misalign=_small_rotation(math.radians(config.thrust_misalign_deg), z_misalign),
        step=torch.zeros(z_scale.shape, dtype=torch.int32, device=z_scale.device),
    )


def dispersed_step(step_fn: Callable, config: DispersionConfig, d: DispersedState, x: Tensor,
                   u: Tensor, z_fluct: Tensor, xi: Optional[Tensor], dt: float = 0.1):
    """One dispersed plant step from this step's draws (z_fluct (B,) for the
    thrust fluctuation, ξ (B, 3) for the Dryden wind): thrust scale ·
    fluctuation · misalignment applied to u, the plant step, then the
    wind's drag acceleration over the step. Returns (x⁺, d⁺)."""
    fluct = 1.0 + config.thrust_fluctuation_std * z_fluct
    u_eff = (d.thrust_scale * fluct)[:, None] * (d.misalign @ u[..., None])[..., 0]
    x_next = step_fn(x, u_eff)
    t = d.step.to(x.dtype) * dt
    w, wind_state = wind_velocity(config.wind, xi, t, d.wind_state)
    dv = config.wind_drag_coeff * w * dt
    x_next = torch.cat([x_next[:, :4], x_next[:, 4:7] + dv, x_next[:, 7:]], dim=1)
    return x_next, d.replace(wind_state=wind_state, step=d.step + 1)


def make_dispersed_plant(step_fn: Callable[[Tensor, Tensor], Tensor], config: DispersionConfig,
                         generator: torch.Generator, dt: float = 0.1):
    """(plant_init(x0s) → DispersedState, pstep(d, x, u) → (x⁺, d)), the
    stateful plant pair ``run_episode`` takes. ``plant_init`` draws each
    lane's thrust scale and misalignment, ``pstep`` each step's fluctuation
    (B,) and, under the Dryden model, the wind's ξ (B, 3), from
    ``generator`` on its device."""
    gdev = generator.device

    def draw(*shape, dev):
        return torch.randn(*shape, generator=generator, device=gdev).to(dev)

    def plant_init(x0s: Tensor) -> DispersedState:
        B, dev = x0s.shape[0], x0s.device
        z_scale = draw(B, dev=dev)
        return init_dispersed_state(config, z_scale, draw(B, 3, dev=dev))

    def pstep(d: DispersedState, x: Tensor, u: Tensor):
        B, dev = x.shape[0], x.device
        z_fluct = draw(B, dev=dev)
        xi = draw(B, 3, dev=dev) if config.wind.model == WIND_DRYDEN else None
        return dispersed_step(step_fn, config, d, x, u, z_fluct, xi, dt)

    return plant_init, pstep


class DispersedDynamics:
    """Object facade over :func:`make_dispersed_plant` for ``batch`` lanes."""

    def __init__(self, step_fn, config: DispersionConfig, generator: torch.Generator,
                 batch: int = 1, dt: float = 0.1, device: DeviceLike = "cuda"):
        self._init, self._step = make_dispersed_plant(step_fn, config, generator, dt)
        self._state = self._init(torch.zeros(batch, 1, device=resolve_device(device)))

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        x_next, self._state = self._step(self._state, x, u)
        return x_next


class WindModel:
    """Object facade over :func:`wind_velocity` for ``batch`` lanes; the
    Dryden model draws its ξ from ``generator`` unless one is given."""

    def __init__(self, config: WindConfig, generator: Optional[torch.Generator] = None,
                 batch: int = 1, device: DeviceLike = "cuda"):
        self.config = config
        self.generator = generator
        self.state = torch.zeros(batch, 3, device=resolve_device(device))

    def velocity(self, t, xi: Optional[Tensor] = None) -> Tensor:
        if xi is None and self.config.model == WIND_DRYDEN:
            xi = torch.randn(self.state.shape, generator=self.generator,
                             device=self.generator.device).to(self.state.device)
        w, self.state = wind_velocity(self.config, xi, t, self.state)
        return w


def run_dispersion_sweep(run_level: Callable[[DispersionConfig], dict],
                         levels=("nominal", "low", "medium", "high")) -> dict:
    """``run_level(config) → stats`` at each preset level."""
    return {name: run_level(DispersionConfig.preset(name)) for name in levels}


def dispersion_ellipse(landing_points: Tensor) -> dict:
    """3σ dispersion-ellipse statistics of landing points (n, 2)."""
    mu = landing_points.mean(0)
    d = landing_points - mu[None]
    cov = d.T @ d / max(landing_points.shape[0] - 1, 1)
    evals, evecs = torch.linalg.eigh(cov)
    return {
        "center": mu,
        "cov": cov,
        "semi_axes_3sigma": 3.0 * torch.sqrt(evals.clamp_min(0.0)),
        "axes": evecs,
        "cep_50": 1.1774 * torch.sqrt(torch.diagonal(cov).mean()),  # circular error probable
    }
