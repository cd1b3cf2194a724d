"""Monte-Carlo landing campaigns, the part the port's paths use (counterpart
of ``gpmpc_tpu/experiments/monte_carlo.py``): outcome codes, landing
criteria, the campaign scenario, the Gaussian initial-condition sampler, the
touchdown classifier and the Wilson score interval. The fleet is the batch
axis; the episode loop and the campaign statistics are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from .._device import DeviceLike, resolve_device

Tensor = torch.Tensor

# outcome codes of a lane
RUNNING = -1
SUCCESS = 0
CRASH = 1
FUEL_EXHAUSTED = 2
CONSTRAINT_VIOLATION = 3
TIMEOUT = 4
DIVERGENCE = 5

OUTCOME_NAMES = {
    SUCCESS: "success",
    CRASH: "crash",
    FUEL_EXHAUSTED: "fuel_exhausted",
    CONSTRAINT_VIOLATION: "constraint_violation",
    TIMEOUT: "timeout",
    DIVERGENCE: "divergence",
}


@dataclass(frozen=True)
class LandingCriteria:
    """Success thresholds at touchdown."""

    landing_altitude: float = 0.1
    max_landing_speed: float = 2.0
    max_position_error: float = 1.0
    max_tilt: float = math.radians(20.0)  # used for 14-state only
    max_angular_rate: float = math.radians(10.0)


@dataclass(frozen=True)
class SimulationConfig:
    """Campaign scenario parameters; field names and defaults are those of
    the JAX ``SimulationConfig``."""

    dt: float = 0.1
    max_steps: int = 200
    # initial condition distribution (gravity along −x ⇒ x[1] is altitude)
    mass_mean: float = 2.0
    mass_std: float = 0.05
    altitude_mean: float = 30.0
    altitude_std: float = 2.0
    horizontal_std: float = 1.0
    vertical_velocity_mean: float = -3.0
    vertical_velocity_std: float = 0.3
    horizontal_velocity_std: float = 0.2
    m_dry: float = 1.0
    divergence_bound: float = 1e4


def sample_initial_conditions(generator: torch.Generator, config: SimulationConfig, n: int,
                              n_x: int = 7, device: DeviceLike = None) -> Tensor:
    """Gaussian initial states (n, n_x) with physical clipping: mass at least
    m_dry + 0.1, altitude at least 1. For n_x = 14 the attitude starts at
    identity with zero rates. The numbers are drawn from ``generator`` on its
    device, in the order mass, altitude, horizontal offsets, vertical
    velocity, horizontal velocities, and returned on ``device`` (default: the
    generator's)."""
    gdev = generator.device
    dev = gdev if device is None else resolve_device(device)
    randn = lambda *shape: torch.randn(*shape, generator=generator, device=gdev)
    m = (config.mass_mean + config.mass_std * randn(n)).clamp_min(config.m_dry + 0.1)
    alt = (config.altitude_mean + config.altitude_std * randn(n)).clamp_min(1.0)
    horiz = config.horizontal_std * randn(n, 2)
    v_vert = config.vertical_velocity_mean + config.vertical_velocity_std * randn(n)
    v_horiz = config.horizontal_velocity_std * randn(n, 2)
    parts = [m[:, None], alt[:, None], horiz, v_vert[:, None], v_horiz]
    if n_x != 7:
        quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=gdev).expand(n, 4)
        parts += [quat, torch.zeros(n, 3, device=gdev)]
    return torch.cat(parts, dim=1).to(dev)


def classify_touchdown(x: Tensor, criteria: LandingCriteria) -> Tensor:
    """SUCCESS or CRASH (int64 codes) for states (…, n_x) at the moment the
    altitude crosses the landing threshold."""
    speed = torch.linalg.vector_norm(x[..., 4:7], dim=-1)
    pos_err = torch.linalg.vector_norm(x[..., 2:4], dim=-1)
    ok = (speed <= criteria.max_landing_speed) & (pos_err <= criteria.max_position_error)
    if x.shape[-1] >= 14:
        cos_t = 1.0 - 2.0 * (x[..., 9] ** 2 + x[..., 10] ** 2)
        tilt = torch.arccos(cos_t.clamp(-1.0, 1.0))
        w = torch.linalg.vector_norm(x[..., 11:14], dim=-1)
        ok = ok & (tilt <= criteria.max_tilt) & (w <= criteria.max_angular_rate)
    return torch.where(ok, SUCCESS, CRASH)


def wilson_interval(successes, n, z: float = 1.96) -> Tuple[Tensor, Tensor]:
    """Wilson score interval (lower, upper) of a binomial proportion; tensors
    or numbers, broadcast together."""
    successes = torch.as_tensor(successes, dtype=torch.float32)
    n = torch.as_tensor(n, dtype=torch.float32, device=successes.device).clamp_min(1.0)
    p = successes / n
    denom = 1.0 + z**2 / n
    center = (p + z**2 / (2 * n)) / denom
    half = (z / denom) * torch.sqrt(p * (1 - p) / n + z**2 / (4 * n**2))
    return (center - half).clamp(0.0, 1.0), (center + half).clamp(0.0, 1.0)
