"""The main path's configuration, in one place: the 3-DoF GP-MPC real-time
cycle that ``bench.py`` times as its primary metric (``bench.py:78-132``),
with the chunk kernel selected (``use_pallas="auto"``).

``chip_smoke.py`` and ``gpmpc_tpu_torch/profile_cycle.py`` drive it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ._device import DeviceLike, resolve_device
from .dynamics import Rocket3DoFParams, rocket3dof as r3
from .gp import Simple3DoFGP
from .mpc import GPMPCConfig, RTIConfig
from .ops.qp import ADMMConfig

N = 20
BATCH = 512
ADMM_ITERS = 50
DT = 0.1


class MainPath(NamedTuple):
    params: Rocket3DoFParams  # the controller's nominal model
    F: Callable  # nominal step
    F_true: Callable  # dispersed plant (drag on)
    config: GPMPCConfig
    x_target: torch.Tensor


def main_path(device: DeviceLike = "cuda") -> MainPath:
    """Nominal model, dispersed plant (``bench.py:79``) and the bench's
    GP-MPC configuration (``bench.py:116-125``)."""
    dev = resolve_device(device)
    p = Rocket3DoFParams(device=dev)
    p_true = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    cfg = GPMPCConfig(
        base=RTIConfig(
            N=N, accept_pri_tol=1e-2, condensed=True, x_bound_mask=(False,) * 7,
            admm=ADMMConfig(max_iter=ADMM_ITERS, check_interval=ADMM_ITERS,
                            polish=False, adaptive_rho=False, scaling=2,
                            use_pallas="auto", infeas_certs=False),
            device=dev,
        ),
        scp_iterations=1, tighten=True, rollout_gp_tape=True,
    )
    xT = torch.zeros(7, device=dev)
    xT[0] = 2.0
    return MainPath(
        params=p,
        F=lambda x, u: r3.step(p, x, u, DT),
        F_true=lambda x, u: r3.step(p_true, x, u, DT),
        config=cfg,
        x_target=xT,
    )


def fleet_x0(batch: int = BATCH, device: DeviceLike = "cuda") -> torch.Tensor:
    """Initial states of the fleet (``bench.py:131-132``)."""
    dev = resolve_device(device)
    x0s = torch.tensor([2.0, 30.0, 0.0, 0.0, -3.0, 0.0, 0.0], device=dev).repeat(batch, 1)
    x0s[:, 1] += torch.linspace(0.0, 5.0, batch, device=dev)
    return x0s


def gp_fns(gp: Simple3DoFGP):
    """(mean_fn, var_fn) in the form ``gp_mpc_solve`` takes: the
    variance-gated residual mean lifted to the state, and the variances."""
    mean_fn = lambda x, u: Simple3DoFGP.lift_residual(gp.predict_gated(x, u)[0], 7)
    var_fn = lambda x, u: gp.predict(x, u)[1]
    return mean_fn, var_fn
