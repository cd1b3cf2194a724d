"""Physics-informed features for the residual GPs (counterpart of
``gpmpc_tpu/gp/features.py``): the exponential atmosphere, the 13-dim
translational and 12-dim rotational features of the 6-DoF model, their
concatenation, and the 11-dim 3-DoF features. Every function takes states
and controls with any leading dims."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..dynamics.rocket6dof import dcm_from_quaternion

TRANSLATIONAL_DIM = 13
ROTATIONAL_DIM = 12
SIMPLE3DOF_DIM = 11


@dataclass(frozen=True)
class AtmosphereModel:
    """ρ(h) = ρ₀ e^(−h/H)."""

    rho0: float = 1.0
    scale_height: float = 10.0

    def density(self, h: torch.Tensor) -> torch.Tensor:
        return self.rho0 * torch.exp(-h.clamp_min(0.0) / self.scale_height)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _body_velocity(x: torch.Tensor) -> torch.Tensor:
    """v_B = C_IB(q)ᵀ v_I."""
    return (dcm_from_quaternion(x[..., 7:11]).transpose(-1, -2) @ x[..., 4:7, None])[..., 0]


def translational_features(x, u, atmosphere: AtmosphereModel) -> torch.Tensor:
    """[v_I(3), |v|, q_dyn, α, β, T_B(3), |T|, h, ρ] — 13 features. The angle
    of attack α about body x (long axis) comes from v_B's z over x, the
    sideslip β from its y over |v|."""
    h = x[..., 1:2]
    v_I = x[..., 4:7]
    vmag = _norm(v_I)
    rho = atmosphere.density(h)
    q_dyn = 0.5 * rho * vmag**2
    v_B = _body_velocity(x)
    vx = v_B[..., 0:1]
    alpha = torch.atan2(v_B[..., 2:3], vx.abs().clamp_min(1e-8) * torch.sign(vx + 1e-12))
    beta = torch.arcsin((v_B[..., 1:2] / vmag.clamp_min(1e-8)).clamp(-1.0, 1.0))
    return torch.cat([v_I, vmag, q_dyn, alpha, beta, u, _norm(u), h, rho], dim=-1)


def rotational_features(x, u, atmosphere: AtmosphereModel) -> torch.Tensor:
    """[ω_B(3), |ω|, T_B(3), v_B(3), |v|, q_dyn] — 12 features."""
    omega = x[..., 11:14]
    vmag = _norm(x[..., 4:7])
    q_dyn = 0.5 * atmosphere.density(x[..., 1:2]) * vmag**2
    return torch.cat([omega, _norm(omega), u, _body_velocity(x), vmag, q_dyn], dim=-1)


def simple_3dof_features(x, u, atmosphere: AtmosphereModel) -> torch.Tensor:
    """[v(3), |v|, T(3), |T|, h, ρ, m] — 11 features."""
    v = x[..., 4:7]
    h = x[..., 1:2]
    return torch.cat([v, _norm(v), u, _norm(u), h, atmosphere.density(h), x[..., 0:1]], dim=-1)


def combined_features(x, u, atmosphere: AtmosphereModel) -> torch.Tensor:
    """Translational then rotational features — 25."""
    return torch.cat([translational_features(x, u, atmosphere),
                      rotational_features(x, u, atmosphere)], dim=-1)


@dataclass(frozen=True)
class TranslationalFeatureExtractor:
    atmosphere: AtmosphereModel = AtmosphereModel()
    n_features: int = TRANSLATIONAL_DIM

    def extract(self, x, u) -> torch.Tensor:
        return translational_features(x, u, self.atmosphere)


@dataclass(frozen=True)
class RotationalFeatureExtractor:
    atmosphere: AtmosphereModel = AtmosphereModel()
    n_features: int = ROTATIONAL_DIM

    def extract(self, x, u) -> torch.Tensor:
        return rotational_features(x, u, self.atmosphere)


@dataclass(frozen=True)
class Simple3DoFFeatureExtractor:
    atmosphere: AtmosphereModel = AtmosphereModel()
    n_features: int = SIMPLE3DOF_DIM

    def extract(self, x, u) -> torch.Tensor:
        return simple_3dof_features(x, u, self.atmosphere)


@dataclass(frozen=True)
class CombinedFeatureExtractor:
    atmosphere: AtmosphereModel = AtmosphereModel()
    n_features: int = TRANSLATIONAL_DIM + ROTATIONAL_DIM

    def extract(self, x, u) -> torch.Tensor:
        return combined_features(x, u, self.atmosphere)
