"""Inputs made from the seed: initial states, the exploration GP's draws and
the sample of answers that the check compares. The same seed gives the
same inputs; inputs are drawn on the run's device in a few large calls."""

from __future__ import annotations

import torch

_CHECK_STREAM = 0x5DEECE66D  # the check's sample is drawn apart from the inputs


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def check_generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed((int(seed) ^ _CHECK_STREAM) % (1 << 63))


def states(gen: torch.Generator, dist: dict, n: int) -> torch.Tensor:
    """(n, 7) initial states [m, altitude, horizontal (2), vertical velocity,
    horizontal velocity (2)], Gaussian with the mass and altitude floored."""
    z = torch.randn(n, 7, generator=gen, device=gen.device)
    m = (dist["mass"][0] + dist["mass"][1] * z[:, 0]).clamp_min(dist["mass_floor"])
    h = (dist["altitude"][0] + dist["altitude"][1] * z[:, 1]).clamp_min(dist["altitude_floor"])
    r = dist["horizontal"] * z[:, 2:4]
    vv = dist["vertical_velocity"][0] + dist["vertical_velocity"][1] * z[:, 4]
    vh = dist["horizontal_velocity"] * z[:, 5:7]
    return torch.cat([m[:, None], h[:, None], r, vv[:, None], vh], 1)


def exploration(gen: torch.Generator, points: int, inducing: int):
    """The exploration GP's excitation (points, 3) and its k-means start
    (inducing distinct indices)."""
    excitation = torch.randn(points, 3, generator=gen, device=gen.device)
    init_idx = torch.randperm(points, generator=gen, device=gen.device)[:inducing]
    return excitation, init_idx


def sample(gen: torch.Generator, k: int, lo: int, hi: int) -> list:
    """k distinct sorted integers of [lo, hi)."""
    return sorted(int(i) + lo for i in torch.randperm(hi - lo, generator=gen)[:k])
