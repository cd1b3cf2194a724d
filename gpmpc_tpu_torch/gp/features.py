"""Physics-informed features for the 3-DoF residual GP (counterpart of
``gpmpc_tpu/gp/features.py``; the 6-DoF extractors come with that slice)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

SIMPLE3DOF_DIM = 11


@dataclass(frozen=True)
class AtmosphereModel:
    """ρ(h) = ρ₀ e^(−h/H)."""

    rho0: float = 1.0
    scale_height: float = 10.0

    def density(self, h: torch.Tensor) -> torch.Tensor:
        return self.rho0 * torch.exp(-h.clamp_min(0.0) / self.scale_height)


def simple_3dof_features(x, u, atmosphere: AtmosphereModel) -> torch.Tensor:
    """[v(3), |v|, T(3), |T|, h, ρ, m] — 11 features, any leading dims."""
    v = x[..., 4:7]
    vmag = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    T_mag = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    h = x[..., 1:2]
    rho = atmosphere.density(h)
    return torch.cat([v, vmag, u, T_mag, h, rho, x[..., 0:1]], dim=-1)


@dataclass(frozen=True)
class Simple3DoFFeatureExtractor:
    atmosphere: AtmosphereModel = AtmosphereModel()
    n_features: int = SIMPLE3DOF_DIM

    def extract(self, x, u) -> torch.Tensor:
        return simple_3dof_features(x, u, self.atmosphere)
