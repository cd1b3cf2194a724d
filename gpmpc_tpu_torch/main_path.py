"""The configurations of the port's paths, in one place, each with the chunk
kernel selected (``use_pallas="auto"``):

- :func:`main_path` — the 3-DoF GP-MPC real-time cycle that ``bench.py``
  times as its primary metric (``bench.py:78-132``);
- :func:`rti_path` — the GP-free RTI cycle on the nominal plant, its
  secondary metric (``bench.py:110-115``, ``:186-201``);
- :func:`pretrain_path` — the production GP fit, ``pretrain_gp_3dof`` under
  the dispersed plant, whose GP then serves the GP-MPC cycle.

``chip_smoke.py`` and ``gpmpc_tpu_torch/profile_cycle.py`` drive them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ._device import DeviceLike, resolve_device
from .dynamics import Rocket3DoFParams, rocket3dof as r3
from .learning.pretrain import gp_fns, pretrain_gp_3dof  # noqa: F401  (gp_fns: re-exported for chip_smoke.py)
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


class RTIPath(NamedTuple):
    params: Rocket3DoFParams
    F: Callable  # nominal step: the controller's model and the plant
    config: RTIConfig
    x_target: torch.Tensor


def rti_path(device: DeviceLike = "cuda") -> RTIPath:
    """The bench's RTI configuration (``bench.py:110-115``): condensed, every
    state-bound row elided (n = m = 60, the rows declared ``("diag", 60)``),
    50 iterations in two chunks of 25 with the certificates on, and the
    nominal model as the plant (``bench.py:195``)."""
    dev = resolve_device(device)
    p = Rocket3DoFParams(device=dev)
    cfg = RTIConfig(
        N=N, accept_pri_tol=5e-3, condensed=True, x_bound_mask=(False,) * 7,
        admm=ADMMConfig(max_iter=ADMM_ITERS, polish=False, adaptive_rho=False, scaling=2,
                        use_pallas="auto"),
        device=dev,
    )
    xT = torch.zeros(7, device=dev)
    xT[0] = 2.0
    return RTIPath(params=p, F=lambda x, u: r3.step(p, x, u, DT), config=cfg, x_target=xT)


def pretrain_path(generator: torch.Generator, device: DeviceLike = "cuda", **kw):
    """The production GP for the main path: ``pretrain_gp_3dof`` with the
    main path's nominal model and dispersed plant (four 64-step episodes of
    the default sparse-form ``RTIConfig(N=20)``, FITC fit, 150 Adam steps).
    Returns (gp, mean_fn, var_fn); ``kw`` goes to ``pretrain_gp_3dof``."""
    mp = main_path(device)
    return pretrain_gp_3dof(generator, mp.params, mp.F_true, dt=DT,
                            device=resolve_device(device), **kw)


def fleet_x0(batch: int = BATCH, device: DeviceLike = "cuda") -> torch.Tensor:
    """Initial states of the fleet (``bench.py:131-132``)."""
    dev = resolve_device(device)
    x0s = torch.tensor([2.0, 30.0, 0.0, 0.0, -3.0, 0.0, 0.0], device=dev).repeat(batch, 1)
    x0s[:, 1] += torch.linspace(0.0, 5.0, batch, device=dev)
    return x0s
