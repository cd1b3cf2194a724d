"""Nominal (GP-free) MPC, lanes first (counterpart of
``gpmpc_tpu/mpc/nominal.py``): the SCP loop of ``gp_mpc.gp_mpc_solve`` with
the GP identically zero (linearize, trust-region QP, repeat), the result
type with its ``u0``, a receding-horizon facade with its warm-start carry,
its closed loop, and the Monte-Carlo adapter."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .._device import DeviceLike, as_f32, resolve_device
from .cycle_replay import declare_frozen
from .gp_mpc import GPMPCConfig, GPMPCState, gp_mpc_init, gp_mpc_solve, make_gp_mpc_controller
from .rti import RTIConfig

Tensor = torch.Tensor


class MPCSolution(NamedTuple):
    success: Tensor  # (B,)
    X_opt: Tensor  # (B, N+1, n_x)
    U_opt: Tensor  # (B, N, n_u)
    cost: Tensor  # (B,)
    iterations: int

    @property
    def u0(self) -> Tensor:
        return self.U_opt[:, 0]


# an MPCConfig is the RTI base plus the SCP settings
MPCConfig = GPMPCConfig


def _zero_gp(n_x: int):
    """The mean and variance functions of a GP that is identically zero."""
    n_gp = 6 if n_x >= 14 else 3
    mean = lambda x, u: x.new_zeros(*x.shape[:-1], n_x)
    var = lambda x, u: x.new_zeros(*x.shape[:-1], n_gp)
    declare_frozen(mean, var)  # they read no posterior at all
    return mean, var


class NominalMPC:
    """SCP MPC for 7- and 14-state models (pass the matching config, e.g.
    ``rti_config_6dof`` as the base for the quaternion model). The default
    config is ``GPMPCConfig(tighten=False)`` on ``device``."""

    def __init__(self, step_fn: Callable[[Tensor, Tensor], Tensor],
                 config: Optional[GPMPCConfig] = None, device: DeviceLike = "cuda"):
        self.step_fn = step_fn
        self.config = config or GPMPCConfig(base=RTIConfig(device=resolve_device(device)),
                                            tighten=False)
        self.device = self.config.base.device
        self._zero_mean, self._zero_var = _zero_gp(self.config.base.n_x)
        self._state: Optional[GPMPCState] = None

    def _solve(self, state: GPMPCState, x: Tensor):
        return gp_mpc_solve(self.step_fn, self._zero_mean, self._zero_var, self.config,
                            state, x)

    def setup(self, x0: Tensor, x_target: Tensor) -> None:
        self._state = gp_mpc_init(self.config, x0, x_target, device=self.device,
                                  step_fn=self.step_fn if self.config.warm_kkt else None)

    def solve(self, x0: Tensor, x_target: Optional[Tensor] = None) -> MPCSolution:
        """Receding-horizon solve of every lane of x0 (B, n_x), warm started
        from the previous call's shifted plan."""
        x0 = as_f32(x0, self.device)
        if self._state is None:
            if x_target is None:
                raise ValueError("call setup() or pass x_target on first solve")
            self.setup(x0, x_target)
        if x_target is not None:
            xT = as_f32(x_target, self.device)
            self._state = self._state.replace(x_ref=xT.expand_as(self._state.x_ref).clone())
        sol, self._state = self._solve(self._state, x0)
        return MPCSolution(success=sol.success, X_opt=sol.X_opt, U_opt=sol.U_opt,
                           cost=sol.cost, iterations=sol.scp_iters)

    def simulate_closed_loop(self, x0: Tensor, x_target: Tensor, n_steps: int,
                             landing_altitude: float = 0.1,
                             plant_step: Optional[Callable] = None) -> dict:
        """Closed loop of every lane, a landed lane frozen (its solver state
        still steps, as in the JAX scan). Returns X (B, n_steps+1, n_x),
        U (B, n_steps, n_u), x_final and landed (B,)."""
        plant = plant_step or self.step_fn
        x = as_f32(x0, self.device)
        self.setup(x, x_target)
        st = self._state
        landed = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        Xs, Us = [x], []
        for _ in range(n_steps):
            sol, st = self._solve(st, x)
            x = torch.where(landed[:, None], x, plant(x, sol.u0))
            landed = landed | (x[:, 1] < landing_altitude)
            Xs.append(x)
            Us.append(sol.u0)
        self._state = st
        return {"X": torch.stack(Xs, dim=1), "U": torch.stack(Us, dim=1), "x_final": x,
                "landed": landed}


class NominalMPC3DoF(NominalMPC):
    """Name-parity 3-DoF variant: the default config already carries the
    3-DoF cost and bounds."""


def make_nominal_mpc_controller(step_fn, config: GPMPCConfig, x_target,
                                reference_fn: Optional[Callable[[Tensor], Tensor]] = None,
                                ref_horizon: int = 100):
    """(cinit, cstep) of the nominal MPC, the Monte-Carlo protocol of
    ``make_gp_mpc_controller``."""
    mean, var = _zero_gp(config.base.n_x)
    return make_gp_mpc_controller(step_fn, mean, var, config, x_target,
                                  reference_fn=reference_fn, ref_horizon=ref_horizon)
