"""Online learning inside the GP-MPC control loop (counterpart of
``gpmpc_tpu/learning/online_gp_mpc.py``): one controller whose state carries
a GP per lane, so that in a campaign every lane observes its own residuals
each cycle and refits its own sparse-GP factors on a lockstep cadence.

- Each lane's GP starts with an empty store, inducing points along the
  lane's planned cubic descent and ARD lengthscales from the moments of those
  envelope features; with no data its posterior is the prior, and the
  activation gate (``min_points``) keeps the correction off.
- Every cycle the flown transition's residual enters the lane's ring buffer
  through a novelty gate (``min_distance``), if the transition is real: a
  stopped lane, frozen on its touchdown state, does not feed junk.
- Every ``refit_every`` cycles the factors are recomputed with Z re-centred on
  the lane's most recent points; every ``refresh_every`` cycles the
  hyperparameters are first refreshed by empirical Bayes (data moments), for
  the lanes with at least ``min_points_hypers`` points.

PyTorch form: the lane axis is the first axis of every tensor of the GP (the
JAX package ``vmap``s one GP per lane); the cadence is a host ``if`` on the
Python cycle index k (the JAX package's ``lax.cond`` on the scalar counter),
so the refit costs only on its cycles and no device value decides it; the
refit is one batched call over lanes and outputs, in which each of the
lanes × outputs Cholesky factorizations keeps its own jitter level.

The controller follows the (controller_init, controller_step) protocol of
``experiments.run_campaign``; ``online_controller_info`` exports the
per-lane prediction-error trace that shows the learning during a flight.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Union

import torch

from .._device import as_f32
from ..gp import Simple3DoFGP, StructuredGPConfig, StructuredRocketGP
from ..gp.sparse_gp import MultiOutputSparseGPState, refit_sparse_multi
from ..gp.structured_gp import RingBuffer, _data_lengthscales, _stacked_kernels
from ..mpc import GPMPCConfig
from ..mpc.gp_mpc import GPMPCState, gp_mpc_init, gp_mpc_solve
from ..reference import cubic_descent_reference
from ..utils.profiler import span

Tensor = torch.Tensor
OnlineGP = Union[Simple3DoFGP, StructuredRocketGP]


@dataclass(frozen=True)
class OnlineGPMPCConfig:
    """Field names and defaults are those of the JAX ``OnlineGPMPCConfig``."""

    mpc: GPMPCConfig
    gp: StructuredGPConfig = field(
        default_factory=lambda: StructuredGPConfig(max_data_points=160, n_inducing=32))
    refit_every: int = 10  # factor refit (with Z re-centred) cadence, in cycles
    refresh_every: int = 20  # empirical-Bayes hyperparameter refresh cadence; 0: off
    min_points_hypers: int = 24  # a lane's refresh waits for this many points
    min_points: int = 12  # activation gate of a lane's GP
    min_distance: float = 0.01  # novelty admission
    dt: float = 0.1


@dataclass
class OnlineGPMPCState:
    """Per-lane carry: the MPC warm starts and the lane's own live GP. Every
    tensor has the lane axis B first (``run_campaign`` freezes stopped lanes
    through it)."""

    mpc: GPMPCState
    Xr: Tensor  # (B, ref_horizon + N + 1, n_x) padded reference
    gp: OnlineGP  # a GP per lane: Simple3DoFGP (7 states), StructuredRocketGP (14)
    x_prev: Tensor  # (B, n_x)
    u_prev: Tensor  # (B, n_u)
    have_prev: Tensor  # (B,) bool: (x_prev, u_prev) is a real flown transition
    n_accepted: Tensor  # (B,) novelty-admitted points
    n_refits: Tensor  # (B,)
    err_hist: Tensor  # (B, err_len) one-step model |error| per cycle (nan: none)


def _envelope_block(gcfg: StructuredGPConfig, Fe: Tensor, n_out: int, buf: RingBuffer
                    ) -> MultiOutputSparseGPState:
    """One GP block per lane from its envelope features Fe (B, T, d): Z the
    T rows subsampled evenly (rounded half to even, as ``jnp.round``),
    lengthscales from their moments, factors on the (empty) store."""
    M, T = gcfg.n_inducing, Fe.shape[-2]
    idx = torch.linspace(0, T - 1, M, device=Fe.device).round().long()
    mask_all = torch.ones(Fe.shape[:-1], dtype=torch.bool, device=Fe.device)
    kernels = _stacked_kernels(gcfg.kernel, Fe.shape[-1], n_out,
                               _data_lengthscales(Fe, mask_all), device=Fe.device)
    log_noise = torch.full((*Fe.shape[:-2], n_out), math.log(gcfg.noise), dtype=Fe.dtype,
                           device=Fe.device)
    return refit_sparse_multi(kernels, Fe[..., idx, :], buf.X, buf.Y.transpose(-1, -2),
                              buf.mask, log_noise, gcfg.method)


def init_online_gp(cfg: OnlineGPMPCConfig, x0: Tensor, x_target: Tensor,
                   ref_horizon: int) -> OnlineGP:
    """A GP per lane of x0 (B, n_x) with an empty store and envelope-derived
    inducing points and priors: the features along each lane's cubic descent
    of ``ref_horizon`` steps, with the thrust column set to the mass (the JAX
    package's "hover-ish thrust"). 14-state lanes get the six-output
    structured model."""
    gcfg = cfg.gp
    Xr = cubic_descent_reference(x0, x_target, ref_horizon, cfg.dt)
    Ur = torch.cat([Xr[..., :1], torch.zeros_like(Xr[..., :2])], dim=-1)
    lanes = x0.shape[0]
    if x0.shape[-1] >= 14:
        gp = StructuredRocketGP.create(gcfg, device=x0.device, lanes=lanes)
        return replace(
            gp,
            trans_gp=_envelope_block(gcfg, gp.trans_extractor.extract(Xr, Ur), 3,
                                     gp.trans_buffer),
            rot_gp=_envelope_block(gcfg, gp.rot_extractor.extract(Xr, Ur), 3, gp.rot_buffer),
            is_fitted=True)
    gp = Simple3DoFGP.create(gcfg, device=x0.device, lanes=lanes)
    return replace(gp, gp=_envelope_block(gcfg, gp.extractor.extract(Xr, Ur), 3, gp.buffer),
                   is_fitted=True)


def _recent_Z(buf: RingBuffer, Z_fallback: Tensor) -> Tensor:
    """Each lane's most recent M admitted feature rows, newest first; slots
    beyond its count keep the fallback (envelope) rows."""
    M = Z_fallback.shape[-2]
    j = torch.arange(M, device=buf.X.device)
    idx = (buf.head[..., None] - 1 - j) % buf.capacity  # floor-mod, as in JAX
    have = (j < buf.count[..., None])[..., None]
    return torch.where(have, torch.take_along_dim(buf.X, idx[..., None], dim=-2), Z_fallback)


def _refit_block(g: MultiOutputSparseGPState, buf: RingBuffer) -> MultiOutputSparseGPState:
    """Re-centre one block's Z on the latest points and recompute factors."""
    return refit_sparse_multi(g.kernels, _recent_Z(buf, g.Z), buf.X, buf.Y.transpose(-1, -2),
                              buf.mask, g.log_noise, g.method)


def _refresh_block(g: MultiOutputSparseGPState, buf: RingBuffer, min_pts: int
                   ) -> MultiOutputSparseGPState:
    """Empirical-Bayes hyperparameter refresh of one block, then the refit.
    A lane below ``min_pts`` points keeps its hyperparameters."""
    take = buf.count >= min_pts  # (B,)
    k = g.kernels
    log_ls = torch.log(_data_lengthscales(buf.X, buf.mask))[..., None, :].expand_as(
        k.log_lengthscales)
    mf = buf.mask.to(buf.Y.dtype)[..., None]
    n = mf.sum(-2).clamp_min(1.0)
    mu = (buf.Y * mf).sum(-2) / n
    var = (((buf.Y - mu[..., None, :]) ** 2) * mf).sum(-2) / n
    lv = 0.5 * torch.log((var * 2.0).clamp_min(1e-4))
    kernels = replace(
        k,
        log_lengthscales=torch.where(take[:, None, None], log_ls, k.log_lengthscales),
        log_variance=torch.where(take[:, None], lv, k.log_variance))
    return refit_sparse_multi(kernels, _recent_Z(buf, g.Z), buf.X, buf.Y.transpose(-1, -2),
                              buf.mask, g.log_noise, g.method)


def _refit_recent(gp: OnlineGP) -> OnlineGP:
    """The cadenced update: Z re-centred on the latest points, factors
    recomputed on the full masked store."""
    if isinstance(gp, StructuredRocketGP):
        return replace(gp, trans_gp=_refit_block(gp.trans_gp, gp.trans_buffer),
                       rot_gp=_refit_block(gp.rot_gp, gp.rot_buffer))
    return replace(gp, gp=_refit_block(gp.gp, gp.buffer))


def _refresh_hypers(gp: OnlineGP, min_pts: int) -> OnlineGP:
    if isinstance(gp, StructuredRocketGP):
        return replace(gp, trans_gp=_refresh_block(gp.trans_gp, gp.trans_buffer, min_pts),
                       rot_gp=_refresh_block(gp.rot_gp, gp.rot_buffer, min_pts))
    return replace(gp, gp=_refresh_block(gp.gp, gp.buffer, min_pts))


def _observe(gp: OnlineGP, x_prev: Tensor, u_prev: Tensor, r: Tensor, accept: Tensor,
             min_distance: float):
    """Novelty-gated insert of each lane's residual r (B, 3 or 6) at the
    features of (x_prev, u_prev). The structured model gates on the
    translational features and admits the rotational row with it, so both
    stores fill in lockstep. Returns (gp, accepted (B,))."""
    if isinstance(gp, StructuredRocketGP):
        tbuf, ok = gp.trans_buffer.add_if_novel(gp.trans_extractor.extract(x_prev, u_prev),
                                                r[:, :3], min_distance, accept=accept)
        rbuf, _ = gp.rot_buffer.add_if_novel(gp.rot_extractor.extract(x_prev, u_prev),
                                             r[:, 3:6], -1.0, accept=ok)
        return replace(gp, trans_buffer=tbuf, rot_buffer=rbuf), ok
    buf, ok = gp.buffer.add_if_novel(gp.extractor.extract(x_prev, u_prev), r, min_distance,
                                     accept=accept)
    return replace(gp, buffer=buf), ok


def make_online_gp_mpc_controller(step_fn: Callable[[Tensor, Tensor], Tensor],
                                  cfg: OnlineGPMPCConfig, x_target,
                                  reference_fn: Callable[[Tensor], Tensor],
                                  ref_horizon: int, err_len: int):
    """(controller_init, controller_step) with in-loop learning:
    ``cinit(x0s (B, n_x)) → cstate`` and ``cstep(cstate, x (B, n_x), k) →
    (u0 (B, n_u), cstate)``, k the cycle index (a Python int).

    ``step_fn`` is the nominal model; the plant is whatever the caller flies,
    and each lane's GP learns the gap. ``reference_fn(x0s) → (B, T, n_x)``
    gives each lane's reference, tracked at step min(k, ref_horizon − 1);
    ``err_hist`` keeps the one-step model error of the first ``err_len``
    cycles. Within a cycle: measure the error of the current GP on the
    transition just flown, observe it, refresh (or else refit) on the
    cadence, then solve with the updated GP."""
    mcfg = cfg.mpc
    N = mcfg.base.N
    dt = cfg.dt
    dev = mcfg.base.device
    xT = as_f32(x_target, dev)
    n_x = xT.shape[-1]

    def _mean_var(gp: OnlineGP):
        """The GP-MPC mean and variance functions of the lanes' GPs, zero on
        the lanes below ``min_points`` points."""
        use = gp.buffer_count >= cfg.min_points
        gate = lambda t: torch.where(use.reshape(-1, *([1] * (t.dim() - 1))), t,
                                     torch.zeros_like(t))
        mean_fn = lambda x, u: gp.lift_residual(gate(gp.predict_gated(x, u)[0]), n_x)
        var_fn = lambda x, u: gate(gp.predict(x, u)[1])
        return mean_fn, var_fn

    def cinit(x0s) -> OnlineGPMPCState:
        x0s = as_f32(x0s, dev)
        B = x0s.shape[0]
        Xr = reference_fn(x0s)
        need = ref_horizon + N + 1
        pad = Xr[:, -1:].repeat(1, max(need - Xr.shape[1], 1), 1)
        return OnlineGPMPCState(
            mpc=gp_mpc_init(mcfg, x0s, xT, device=dev),
            Xr=torch.cat([Xr, pad], dim=1)[:, :need],
            gp=init_online_gp(cfg, x0s, xT, ref_horizon),
            x_prev=x0s, u_prev=torch.zeros(B, 3, device=dev),
            have_prev=torch.zeros(B, dtype=torch.bool, device=dev),
            n_accepted=torch.zeros(B, dtype=torch.int32, device=dev),
            n_refits=torch.zeros(B, dtype=torch.int32, device=dev),
            err_hist=torch.full((B, err_len), float("nan"), device=dev),
        )

    def cstep(st: OnlineGPMPCState, x: Tensor, k: int):
        k = int(k)
        gp = st.gp
        with span("online.observe"):
            # a real flown transition: a stopped lane repeats its frozen
            # state, and observing that non-transition would write a large
            # fake residual into its buffer
            real = st.have_prev & (x != st.x_prev).any(-1)
            # the one-step error of the current model on the transition just
            # flown, before it enters the buffer
            mean_fn, _ = _mean_var(gp)
            x_nom = step_fn(st.x_prev, st.u_prev)
            pred = x_nom + dt * mean_fn(st.x_prev, st.u_prev)
            err = torch.linalg.vector_norm(x[:, 4:7] - pred[:, 4:7], dim=-1)
            err_hist = st.err_hist
            if k < err_len:
                err_hist = err_hist.clone()
                err_hist[:, k] = torch.where(real, err, torch.full_like(err, float("nan")))
            err_full = (x - x_nom) / dt
            r = (torch.cat([err_full[:, 4:7], err_full[:, 11:14]], dim=-1) if n_x >= 14
                 else err_full[:, 4:7])
            gp, accepted = _observe(gp, st.x_prev, st.u_prev, r, real, cfg.min_distance)
        # a refresh already refits on the re-centred Z: on a cycle where both
        # cadences fall, only the refresh runs
        did_refresh = cfg.refresh_every > 0 and k % cfg.refresh_every == cfg.refresh_every - 1
        do_refit = k % cfg.refit_every == cfg.refit_every - 1 and not did_refresh
        if did_refresh or do_refit:
            with span("online.refit"):
                gp = (_refresh_hypers(gp, cfg.min_points_hypers) if did_refresh
                      else _refit_recent(gp))
        mean_fn, var_fn = _mean_var(gp)
        kk = min(k, ref_horizon - 1)
        mpc = st.mpc.replace(x_ref=st.Xr[:, kk:kk + N + 1])
        sol, mpc = gp_mpc_solve(step_fn, mean_fn, var_fn, mcfg, mpc, x)
        new = replace(
            st, mpc=mpc, gp=gp, x_prev=x, u_prev=sol.u0,
            have_prev=torch.ones_like(st.have_prev),
            n_accepted=st.n_accepted + accepted.to(torch.int32),
            n_refits=st.n_refits + int(did_refresh or do_refit),
            err_hist=err_hist)
        return sol.u0, new

    return cinit, cstep


def carry_gp_between_episodes(cinit: Callable[[Tensor], OnlineGPMPCState],
                              st_final: OnlineGPMPCState, x0_next) -> OnlineGPMPCState:
    """A fresh episode's state at ``x0_next`` with the learned GPs carried
    over: warm starts, reference and error trace start anew, the models and
    their counters persist (the recency refit re-centres Z as new data
    arrives)."""
    return replace(cinit(x0_next), gp=st_final.gp, n_accepted=st_final.n_accepted,
                   n_refits=st_final.n_refits)


def online_controller_info(st: OnlineGPMPCState) -> dict:
    """``cstate_info`` hook for ``run_episode``/``run_campaign``: the
    learning trace, per lane."""
    return {
        "err_hist": st.err_hist,
        "gp_points": st.gp.buffer_count,
        "n_accepted": st.n_accepted,
        "n_refits": st.n_refits,
    }
