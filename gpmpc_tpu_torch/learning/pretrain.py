"""GP pretraining for the 3-DoF slice (counterpart of
``gpmpc_tpu/learning/pretrain.py::explore_gp_3dof``)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..dynamics import rocket3dof as r3
from ..gp import ResidualCollector, Simple3DoFGP, StructuredGPConfig

_X_START = (2.0, 30.0, 1.0, -1.0, -3.0, 0.5, 0.2)
_X_RESET = (2.0, 25.0, -1.0, 2.0, -4.0, -0.5, 0.1)


def explore_gp_3dof(
    gen_explore: torch.Generator, gen_fit: torch.Generator, p_nom,
    true_step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float = 0.1, n_points: int = 128, n_inducing: int = 48,
    device: DeviceLike = "cuda", excitation: Optional[torch.Tensor] = None,
    init_idx: Optional[torch.Tensor] = None,
) -> Tuple[Simple3DoFGP, Callable, Callable]:
    """Cheap exploration GP fit — the bench setup. Randomized hover-thrust
    excitation on the true plant (reset when the altitude drops below 0.5),
    residuals against the nominal model, one sparse-GP fit with no
    hyperparameter tuning.

    ``gen_explore`` draws the (n_points, 3) excitation noise and ``gen_fit``
    the k-means start; ``excitation`` / ``init_idx`` pass them in instead
    (the parity tests hand both packages the same numbers). Returns
    ``(gp, mean_fn, var_fn)`` shaped for ``gp_mpc_solve``: ``mean_fn(X, U)``
    is the variance-gated residual mean lifted to the 7-state, ``var_fn(X,
    U)`` the (…, 3) posterior variances."""
    dev = resolve_device(device)
    F_nom = lambda x, u: r3.step(p_nom, x, u, dt)
    if excitation is None:
        excitation = torch.randn(n_points, 3, generator=gen_explore,
                                 device=gen_explore.device)
    noise = excitation.to(device=dev, dtype=torch.float32)
    x_reset = torch.tensor(_X_RESET, device=dev)
    x = torch.tensor(_X_START, device=dev)
    Xs, Us, Xns = [], [], []
    for k in range(n_points):
        u = r3.clamp_thrust(p_nom, r3.hover_thrust(p_nom, x) + 0.3 * noise[k])
        xn = true_step_fn(x, u)
        Xs.append(x)
        Us.append(u)
        Xns.append(xn)
        x = torch.where(xn[1] > 0.5, xn, x_reset)
    X, U, Xn = torch.stack(Xs), torch.stack(Us), torch.stack(Xns)
    res = ResidualCollector(dt=dt).collect_batch(F_nom, X, U, Xn)
    gp = Simple3DoFGP.create(
        StructuredGPConfig(max_data_points=n_points, n_inducing=n_inducing),
        device=dev)
    gp = gp.add_data_batch(X, U, res).fit(gen_fit, init_idx=init_idx)
    mean_fn = lambda x, u: Simple3DoFGP.lift_residual(gp.predict_gated(x, u)[0], 7)
    var_fn = lambda x, u: gp.predict(x, u)[1]
    return gp, mean_fn, var_fn
