"""Offline GP pretraining (counterpart of ``gpmpc_tpu/learning/pretrain.py``).

- :func:`pretrain_gp_3dof` and :func:`pretrain_gp_6dof` — the production
  path: a nominal-model RTI controller flies descent episodes on the TRUE
  plant from several initial conditions, with small control excitation for
  identifiability; residuals d = (x⁺_true − F_nom(x,u))/dt on the learned
  slices (velocity; and rate for 6-DoF) are collected, a sparse residual GP
  is fitted and its ARD hyperparameters are tuned by maximum likelihood.
  Episodes are the batch axis.
- :func:`explore_gp_3dof` — the cheap hover-excitation fit the benches use.

All return ``(gp, mean_fn, var_fn)`` in the form ``gp_mpc_solve`` takes.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..dynamics import rocket3dof as r3, rocket6dof as r6
from ..gp import ResidualCollector, Simple3DoFGP, StructuredGPConfig, StructuredRocketGP
from ..gp.sparse_gp import MultiOutputSparseGPState, refit_sparse_multi
from ..mpc.cycle_replay import declare_frozen

_X_START = (2.0, 30.0, 1.0, -1.0, -3.0, 0.5, 0.2)
_X_RESET = (2.0, 25.0, -1.0, 2.0, -4.0, -0.5, 0.1)


def gp_fns(gp, gated: bool = True):
    """(mean_fn, var_fn) for ``gp_mpc_solve`` from a fitted
    :class:`Simple3DoFGP` or :class:`StructuredRocketGP`: the (variance-gated)
    residual mean lifted to the model's state (7 or 14), and the posterior
    variances (…, 3) or (…, 6). Both declare a frozen posterior
    (``mpc/cycle_replay.py``): the GP is not refitted in place."""
    predict = gp.predict_gated if gated else gp.predict
    mean_fn = lambda x, u: gp.lift_residual(predict(x, u)[0])
    var_fn = lambda x, u: gp.predict(x, u)[1]
    declare_frozen(mean_fn, var_fn)
    return mean_fn, var_fn


def _tune_multi(gp_state: MultiOutputSparseGPState, tune_steps: int
                ) -> MultiOutputSparseGPState:
    """MLE-retune each output's kernel hyperparameters on the fitted sparse
    state, then refit the factors. ARD lengthscale optimization is what makes
    the residual GP robust off the training trajectory: the moment-matched
    init over-trusts low-variance feature dimensions."""
    from .hyperparameter_tuner import HyperparameterConfig, tune_mle

    g = gp_state
    kernels, log_noise, _ = tune_mle(
        HyperparameterConfig(steps=tune_steps), g.kernels, g.Z, g.X, g.Y, g.mask,
        g.log_noise, method=g.method)
    return refit_sparse_multi(kernels, g.Z, g.X, g.Y, g.mask, log_noise, g.method)


def _refit_float64(g: MultiOutputSparseGPState) -> MultiOutputSparseGPState:
    """The sparse GP with its data, hyperparameters and factors in float64."""
    d = lambda t: t.double()
    return refit_sparse_multi(g.kernels.map_params(d), d(g.Z), d(g.X), d(g.Y), g.mask,
                              d(g.log_noise), g.method)


def _on_policy_episodes(controller_init, controller_step, plant_step, clamp_fn,
                        x0s: torch.Tensor, episode_len: int, excitation: float,
                        noise: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fly one episode per initial condition (the batch axis) with excited
    controls on the true plant; ``noise`` is (n_episodes, episode_len, 3).
    Returns (X, U, X_next), each (n_episodes, episode_len, ·)."""
    x = x0s
    cstate = controller_init(x0s)
    Xs, Us, Xns = [], [], []
    for k in range(episode_len):
        u, cstate = controller_step(cstate, x, k)
        u = clamp_fn(u + excitation * noise[:, k])
        # freeze at touchdown: an episode long enough to cover the flare
        # must not stream sub-ground dynamics into the residual set
        xn = torch.where((x[:, 1] <= 0.1)[:, None], x, plant_step(x, u))
        Xs.append(x)
        Us.append(u)
        Xns.append(xn)
        x = xn
    return torch.stack(Xs, dim=1), torch.stack(Us, dim=1), torch.stack(Xns, dim=1)


def _draws(generator, x0s, noise, sampler, dev):
    """``sampler`` (``torch.randn``/``torch.rand``) drawing from
    ``generator`` on its device, the result moved to ``dev``."""
    if generator is None and (x0s is None or noise is None):
        raise ValueError("pass a torch.Generator, or both x0s and noise")
    return lambda *shape: sampler(*shape, generator=generator, device=generator.device).to(dev)


_X0_BASE = (2.0, 27.0, 0.0, 0.0, -3.0, 0.0, 0.0)
_X0_SPREAD = (0.0, 2.0, 1.0, 1.0, 0.4, 0.25, 0.25)


def collect_residuals_3dof(
    generator: Optional[torch.Generator], p_nom,
    true_step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float = 0.1, n_episodes: int = 4, episode_len: int = 64,
    excitation: float = 0.05, x0s: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None, device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(X, U, residuals) from nominal-RTI descent episodes on the true plant.

    ``generator`` draws the initial conditions and the (n_episodes,
    episode_len, 3) excitation noise; ``x0s`` / ``noise`` pass them in
    instead."""
    from ..mpc import RTIConfig, make_rti_controller
    from ..reference import cubic_descent_reference

    dev = resolve_device(device)
    F_nom = lambda x, u: r3.step(p_nom, x, u, dt)
    xT = torch.zeros(7, device=dev)
    xT[0] = 2.0
    ci, cs = make_rti_controller(
        F_nom, RTIConfig(N=20, dt=dt, device=dev), xT, reference_fn=lambda x0: cubic_descent_reference(x0, xT, 80, dt),
        ref_horizon=100)
    randn = _draws(generator, x0s, noise, torch.randn, dev)
    if x0s is None:
        x0s = (torch.tensor(_X0_BASE, device=dev)
               + randn(n_episodes, 7) * torch.tensor(_X0_SPREAD, device=dev))
    x0s = x0s.to(device=dev, dtype=torch.float32)
    if noise is None:
        noise = randn(x0s.shape[0], episode_len, 3)
    X, U, Xn = _on_policy_episodes(
        ci, cs, true_step_fn, lambda u: r3.clamp_thrust(p_nom, u), x0s, episode_len,
        excitation, noise.to(device=dev, dtype=torch.float32))
    X, U, Xn = X.reshape(-1, 7), U.reshape(-1, 3), Xn.reshape(-1, 7)
    # drop frozen post-touchdown rows (x == xn is not a flown transition)
    moved = (X != Xn).any(dim=1)
    X, U, Xn = X[moved], U[moved], Xn[moved]
    return X, U, ResidualCollector(dt=dt).collect_batch(F_nom, X, U, Xn)


def pretrain_gp_3dof(
    generator: Optional[torch.Generator], p_nom,
    true_step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float = 0.1, n_episodes: int = 4, episode_len: int = 64,
    n_inducing: int = 48, gated: bool = True, tune_steps: int = 150,
    device: DeviceLike = "cuda", x0s: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None, init_idx: Optional[torch.Tensor] = None,
) -> Tuple[Simple3DoFGP, Callable, Callable]:
    """Fitted and tuned :class:`Simple3DoFGP` + (mean_fn, var_fn) for
    ``gp_mpc_solve``: ``mean_fn(X, U) → (…, 7)`` is the (optionally
    variance-gated) velocity-residual mean lifted into the state,
    ``var_fn(X, U) → (…, 3)`` the posterior variances.

    ``generator`` draws the episodes' initial conditions, the excitation
    noise and the k-means start; ``x0s``, ``noise`` and ``init_idx`` pass
    them in instead (see :func:`collect_residuals_3dof`)."""
    dev = resolve_device(device)
    X, U, res = collect_residuals_3dof(
        generator, p_nom, true_step_fn, dt, n_episodes, episode_len, x0s=x0s,
        noise=noise, device=dev)
    n = X.shape[0]
    gp = Simple3DoFGP.create(
        StructuredGPConfig(max_data_points=n, n_inducing=min(n_inducing, n)), device=dev)
    gp = gp.add_data_batch(X, U, res).fit(generator, init_idx=init_idx)
    if tune_steps > 0:
        gp = replace(gp, gp=_tune_multi(gp.gp, tune_steps))
    return (gp, *gp_fns(gp, gated))


def explore_gp_3dof(
    gen_explore: torch.Generator, gen_fit: torch.Generator, p_nom,
    true_step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float = 0.1, n_points: int = 128, n_inducing: int = 48,
    device: DeviceLike = "cuda", excitation: Optional[torch.Tensor] = None,
    init_idx: Optional[torch.Tensor] = None,
) -> Tuple[Simple3DoFGP, Callable, Callable]:
    """Cheap exploration GP fit — the bench setup; prediction quality does
    not matter there beyond capturing the residual trend, and
    :func:`pretrain_gp_3dof` is the production path. Randomized hover-thrust
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
    return (gp, *gp_fns(gp))


def collect_residuals_6dof(
    generator: Optional[torch.Generator], p_nom,
    true_step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float = 0.1, n_episodes: int = 4, episode_len: int = 64,
    excitation: float = 0.03, x0s: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None, device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(X, U, residuals (n, 6)) from nominal 6-DoF RTI descent episodes on the
    true plant: ``rti_config_6dof(N=15)`` (sparse form) tracking a cubic
    descent reference. Unlike the 3-DoF collector, the frozen rows after
    touchdown stay in the set, as in the JAX package.

    ``generator`` draws the initial conditions (altitudes U(17, 23),
    velocities (−3.5 + 1.5·U, 0.6·N, 0.6·N), horizontal offsets N(0, 1)) and
    the (n_episodes, episode_len, 3) excitation noise; ``x0s`` / ``noise``
    pass them in instead."""
    from ..mpc import make_rti_controller, rti_config_6dof
    from ..reference import cubic_descent_reference

    dev = resolve_device(device)
    F_nom = lambda x, u: r6.step(p_nom, x, u, dt)
    xT = r6.create_initial_state(p_nom, altitude=0.0, device=dev)
    # fly the profile the downstream campaigns fly (cubic descent reference):
    # constant-target episodes leave the GP at its prior along real descents
    ci, cs = make_rti_controller(
        F_nom, rti_config_6dof(p_nom, N=15, dt=dt, device=dev), xT,
        reference_fn=lambda x0: cubic_descent_reference(x0, xT, 80, dt),
        ref_horizon=episode_len + 1)
    if x0s is None:
        rand = _draws(generator, x0s, noise, torch.rand, dev)
        randn = _draws(generator, x0s, noise, torch.randn, dev)
        alts = 17.0 + 6.0 * rand(n_episodes)
        vels = torch.stack([-3.5 + 1.5 * rand(n_episodes), 0.6 * randn(n_episodes),
                            0.6 * randn(n_episodes)], dim=1)
        horiz = randn(n_episodes, 2)
        x0s = xT.repeat(n_episodes, 1)
        x0s = torch.cat([x0s[:, :1], alts[:, None], horiz, vels, x0s[:, 7:]], dim=1)
    x0s = x0s.to(device=dev, dtype=torch.float32)
    if noise is None:
        noise = _draws(generator, x0s, noise, torch.randn, dev)(x0s.shape[0], episode_len, 3)
    X, U, Xn = _on_policy_episodes(
        ci, cs, true_step_fn, lambda u: r6.clamp_thrust(p_nom, u), x0s, episode_len,
        excitation, noise.to(device=dev, dtype=torch.float32))
    X, U, Xn = X.reshape(-1, 14), U.reshape(-1, 3), Xn.reshape(-1, 14)
    return X, U, ResidualCollector(dt=dt).collect_batch(F_nom, X, U, Xn)


def pretrain_gp_6dof(
    generator: Optional[torch.Generator], p_nom,
    true_step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float = 0.1, n_episodes: int = 4, episode_len: int = 64,
    n_inducing: int = 48, gated: bool = True, tune_steps: int = 150,
    device: DeviceLike = "cuda", x0s: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    init_idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[StructuredRocketGP, Callable, Callable]:
    """Fitted and tuned :class:`StructuredRocketGP` + (mean_fn, var_fn) for
    ``gp_mpc_solve``: ``mean_fn(X, U) → (…, 14)`` is the (optionally
    variance-gated) [d_v, d_ω] residual mean lifted into the state,
    ``var_fn(X, U) → (…, 6)`` the posterior variances.

    ``generator`` draws the episodes' initial conditions, the excitation
    noise and the two k-means starts; ``x0s``, ``noise`` and ``init_idx`` (a
    pair) pass them in instead (see :func:`collect_residuals_6dof`)."""
    dev = resolve_device(device)
    X, U, res = collect_residuals_6dof(
        generator, p_nom, true_step_fn, dt, n_episodes, episode_len, x0s=x0s, noise=noise,
        device=dev)
    n = X.shape[0]
    gp = StructuredRocketGP.create(
        StructuredGPConfig(max_data_points=n, n_inducing=min(n_inducing, n)), device=dev)
    gp = gp.add_data_batch(X, U, res).fit(generator, init_idx=init_idx)
    if tune_steps > 0:
        gp = replace(gp, trans_gp=_tune_multi(gp.trans_gp, tune_steps),
                     rot_gp=_tune_multi(gp.rot_gp, tune_steps))
    # the tuned K_uu is near singular (noise at its floor, lengthscales at
    # their cap: condition 1e8-1e12), and float32 factors moved the posterior
    # variance by up to O(1) of σ² on the card: the factors and the posterior
    # are float64, the GP's answers the query's dtype (StructuredRocketGP)
    gp = replace(gp, trans_gp=_refit_float64(gp.trans_gp), rot_gp=_refit_float64(gp.rot_gp))
    return (gp, *gp_fns(gp, gated))
