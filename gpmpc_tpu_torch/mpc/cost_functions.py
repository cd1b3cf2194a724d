"""Cost weights, stage costs and the LQR terminal cost (counterpart of
``gpmpc_tpu/mpc/cost_functions.py``). Every cost takes states and controls
with any leading axes (lanes first) and returns one value per leading
index; the discrete ARE is ``ops.linalg.dlqr``'s doubling recursion."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from ..ops.linalg import dlqr

Tensor = torch.Tensor


@dataclass(frozen=True)
class CostWeights:
    """Diagonal weights. For 14 states: position 10, velocity 1, attitude on
    the tilt components q_y, q_z only (body +x long axis), rate 0.5; R =
    0.01; the terminal weight is 10·Q. The builders return CPU tensors (the
    ``RTIConfig`` they go into moves them to its device)."""

    w_mass: float = 0.0
    w_pos: float = 10.0
    w_vel: float = 1.0
    w_att: float = 5.0
    w_omega: float = 0.5
    w_ctrl: float = 0.01
    w_fuel: float = 0.0
    terminal_scale: float = 10.0

    def Q_6dof(self) -> torch.Tensor:
        """14×14 state weight."""
        return torch.diag(torch.tensor(
            [self.w_mass] + [self.w_pos] * 3 + [self.w_vel] * 3
            + [0.0, 0.0, self.w_att, self.w_att] + [self.w_omega] * 3))

    def Q_3dof(self) -> torch.Tensor:
        """7×7 state weight (mass unweighted)."""
        return torch.diag(torch.tensor([self.w_mass] + [self.w_pos] * 3 + [self.w_vel] * 3))

    def R(self, n_u: int = 3) -> torch.Tensor:
        return torch.eye(n_u) * self.w_ctrl

    def P_6dof(self) -> torch.Tensor:
        return self.Q_6dof() * self.terminal_scale

    def P_3dof(self) -> torch.Tensor:
        return self.Q_3dof() * self.terminal_scale


def _quad(e: Tensor, M: Tensor) -> Tensor:
    return torch.einsum("...i,ij,...j->...", e, M, e)


def quadratic_stage_cost(x: Tensor, u: Tensor, x_ref: Tensor, Q: Tensor, R: Tensor) -> Tensor:
    """l(x, u) = (x−x_ref)ᵀQ(x−x_ref) + uᵀRu."""
    return _quad(x - x_ref, Q) + _quad(u, R)


def fuel_optimal_stage_cost(x: Tensor, u: Tensor, x_ref: Tensor, Q: Tensor, R: Tensor,
                            w_fuel) -> Tensor:
    """Quadratic plus the fuel term w·‖T‖."""
    return quadratic_stage_cost(x, u, x_ref, Q, R) + w_fuel * torch.linalg.vector_norm(u, dim=-1)


def tracking_stage_cost(x: Tensor, u: Tensor, x_ref: Tensor, u_ref: Tensor, Q: Tensor,
                        R: Tensor) -> Tensor:
    """Track both the state and the control reference."""
    return _quad(x - x_ref, Q) + _quad(u - u_ref, R)


def terminal_cost(x: Tensor, x_ref: Tensor, P: Tensor) -> Tensor:
    return _quad(x - x_ref, P)


def trajectory_cost(X: Tensor, U: Tensor, x_ref: Tensor, Q: Tensor, R: Tensor,
                    P: Tensor) -> Tensor:
    """Total cost of rollouts X (..., T+1, n_x), U (..., T, n_u): the stage
    costs of the first T states and the controls plus the terminal cost."""
    E = X[..., :-1, :] - x_ref[..., None, :]
    stage = (torch.einsum("...ki,ij,...kj->...", E, Q, E)
             + torch.einsum("...ki,ij,...kj->...", U, R, U))
    return stage + terminal_cost(X[..., -1, :], x_ref, P)


def compute_lqr_gain(A: Tensor, B: Tensor, Q: Tensor, R: Tensor) -> Tuple[Tensor, Tensor]:
    """Discrete LQR (K, P) by Riccati doubling."""
    return dlqr(A, B, Q, R)


@dataclass(frozen=True)
class LQRTerminalCost:
    """V(x) = (x−x_eq)ᵀP(x−x_eq) from the LQR of the model linearized at an
    equilibrium. Build it once with :meth:`create`."""

    P: Tensor
    K: Tensor
    x_eq: Tensor

    @classmethod
    def create(cls, linearize_fn: Callable, x_eq: Tensor, u_eq: Tensor, Q: Tensor, R: Tensor,
               dt: Optional[float] = None) -> "LQRTerminalCost":
        """``linearize_fn(x, u) → (A_d, B_d[, c])``, the discrete Jacobians at
        (x_eq, u_eq)."""
        out = linearize_fn(x_eq, u_eq)
        K, P = dlqr(out[0], out[1], Q, R)
        return cls(P=P, K=K, x_eq=x_eq)

    def value(self, x: Tensor) -> Tensor:
        return _quad(x - self.x_eq, self.P)

    def gradient(self, x: Tensor) -> Tensor:
        return 2.0 * (x - self.x_eq) @ self.P.T

    def control(self, x: Tensor, u_eq: Tensor) -> Tensor:
        return u_eq - (x - self.x_eq) @ self.K.T
