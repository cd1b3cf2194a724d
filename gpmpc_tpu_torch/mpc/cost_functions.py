"""Cost weights (counterpart of ``CostWeights`` in
``gpmpc_tpu/mpc/cost_functions.py``; the stage costs and the LQR terminal
cost are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
