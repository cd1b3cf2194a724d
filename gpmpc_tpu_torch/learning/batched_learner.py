"""Campaign-scale online learning: a fleet of lanes learns concurrently
(counterpart of ``gpmpc_tpu/learning/batched_learner.py``).

Every lane flies closed-loop GP-MPC episodes with its OWN sparse GP (round 0
flies the nominal model), then refits on its own buffer at the round
barrier, and on a cadence retunes its hyperparameters by Adam. The JAX
package runs the whole loop as one jitted ``lax.scan``; here it is a host
loop over rounds and steps with every tensor lane-first:

- per-lane residual ring buffers (masked writes; frozen rows after
  touchdown drop out),
- per-lane sparse-GP state (kernels, inducing points and factors carry the
  lane axis; ``fit`` is one batched k-means and FITC/VFE fit over lanes),
- GP-MPC controllers whose mean and variance read each lane's own GP
  through the activation gate (zero until the lane's buffer holds
  ``min_points_for_gp`` points),
- the refit barrier at round end and the cadenced per-lane retune.

The state dimension of ``x0s`` picks the model family: 7 → the 3-DoF point
mass with the 3-output velocity GP, 14 → the 6-DoF quaternion model with the
6-output structured [d_v, d_ω] GP.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional

import torch

from .._device import DeviceLike, as_f32, resolve_device
from ..dynamics import rocket3dof as r3, rocket6dof as r6
from ..gp import ResidualCollector, Simple3DoFGP, StructuredGPConfig, StructuredRocketGP
from ..gp.structured_gp import broadcast_lanes
from ..mpc import GPMPCConfig, RTIConfig
from ..mpc.gp_mpc import GPMPCState, gp_mpc_init, gp_mpc_solve
from ..mpc.rti import freeze_lanes
from ..reference import cubic_descent_reference, pad_reference
from ..utils.profiler import span
from .pretrain import _tune_multi

Tensor = torch.Tensor


@dataclass(frozen=True)
class BatchedLearningConfig:
    """Field names and defaults are those of the JAX ``BatchedLearningConfig``."""

    n_rounds: int = 3
    max_steps: int = 110
    dt: float = 0.1
    landing_altitude: float = 0.1
    success_speed: float = 2.0
    min_points_for_gp: int = 16  # the activation gate
    gp: StructuredGPConfig = field(
        default_factory=lambda: StructuredGPConfig(max_data_points=128, n_inducing=32))
    # per-lane Adam MLE retune cadence in rounds; 0 disables it and the
    # refit barrier keeps the data-moment lengthscale heuristic
    tune_every: int = 0
    tune_steps: int = 60


def _template_gp(config: StructuredGPConfig, generator: Optional[torch.Generator], n_x: int,
                 lanes: int, device: torch.device):
    """B copies of a GP fitted on one dummy point, so that the per-lane state
    has its full structure from round 0; the activation gate keeps its
    predictions out of every controller."""
    if n_x >= 14:
        gp = StructuredRocketGP.create(config, device=device)
        x = torch.zeros(14, device=device)
        x[0], x[1], x[7] = 2.0, 10.0, 1.0
        r = torch.zeros(6, device=device)
    else:
        gp = Simple3DoFGP.create(config, device=device)
        x = torch.zeros(7, device=device)
        x[0], x[1] = 2.0, 10.0
        r = torch.zeros(3, device=device)
    u = torch.zeros(3, device=device)
    u[0] = 2.0
    return broadcast_lanes(gp.add_data(x, u, r).fit(generator), lanes)


def _tune_lane(gp, steps: int):
    """Per-lane Adam MLE retune of every output's kernel hyperparameters on
    the lane's own buffer, then a factor refit, for all lanes in one batch."""
    if isinstance(gp, StructuredRocketGP):
        return replace(gp, trans_gp=_tune_multi(gp.trans_gp, steps),
                       rot_gp=_tune_multi(gp.rot_gp, steps))
    return replace(gp, gp=_tune_multi(gp.gp, steps))


def _gated_fns(gp, use_gp: Tensor, n_x: int):
    """(mean_fn, var_fn) for ``gp_mpc_solve``: each lane's posterior, zero on
    a lane whose GP is not active yet (no GP is evaluated while none is)."""
    live = bool(use_gp.any())

    def gate(t):
        return torch.where(use_gp.reshape(-1, *([1] * (t.dim() - 1))), t, torch.zeros_like(t))

    def mean_fn(x, u):
        if not live:
            return torch.zeros_like(x[..., :n_x])
        return gp.lift_residual(gate(gp.predict_gated(x, u)[0]), n_x)

    def var_fn(x, u):
        if not live:
            n_gp = 6 if n_x >= 14 else 3
            return x.new_zeros(*x.shape[:-1], n_gp)
        return gate(gp.predict(x, u)[1])

    return mean_fn, var_fn


def fleet_reference(x0s: Tensor, x_target: Tensor, config: BatchedLearningConfig,
                    N: int) -> Tensor:
    """Every lane's cubic descent reference (``max_steps − 10`` steps), padded
    so that each of the episode's ``max_steps`` cycles has its N + 1 window."""
    need = config.max_steps + N + 1
    Xr = cubic_descent_reference(x0s, x_target, config.max_steps - 10, config.dt)
    return pad_reference(Xr, max(need - Xr.shape[1], 0))[:, :need]


def fleet_cycle(F_nom: Callable, plant_step: Callable, mpc: GPMPCConfig, mean_fn: Callable,
                var_fn: Callable, Xr: Tensor) -> Callable:
    """``cycle(state, x, k) → (sol, state⁺, x⁺)``: the episode's k-th
    cycle, the GP-MPC solve on the k-th window of ``Xr`` and the plant's
    step under its u0 (no lane frozen)."""
    N = mpc.base.N

    def cycle(st: GPMPCState, x: Tensor, k: int):
        sol, st = gp_mpc_solve(F_nom, mean_fn, var_fn, mpc,
                               st.replace(x_ref=Xr[:, k:k + N + 1]), x)
        return sol, st, plant_step(x, sol.u0)

    return cycle


def fleet_episode(F_nom: Callable, plant_step: Callable, mpc: GPMPCConfig, gp, use_gp: Tensor,
                  x0s: Tensor, x_target: Tensor, config: BatchedLearningConfig) -> Dict:
    """One closed-loop episode of every lane flying with its own (gated) GP:
    each lane tracks its cubic descent reference (``max_steps − 10`` steps)
    and freezes at touchdown. Returns x_final, landed, speed (B,), the flown
    transitions X, U (the applied u0), Xn (B, T, ·) with T ≤ max_steps (the
    loop ends once every lane has landed: later rows are frozen and carry no
    data), ``valid`` (B, T) — live rows that moved — and ``model_err`` (B,),
    the mean one-step error of the controller's model over live steps."""
    cfg = config
    N, dt = mpc.base.N, cfg.dt
    Bsz, n_x = x0s.shape
    mean_fn, var_fn = _gated_fns(gp, use_gp, n_x)
    cycle = fleet_cycle(F_nom, plant_step, mpc, mean_fn, var_fn,
                        fleet_reference(x0s, x_target, cfg, N))
    st = gp_mpc_init(mpc, x0s, x_target, device=x0s.device)
    x = x0s
    landed = torch.zeros(Bsz, dtype=torch.bool, device=x0s.device)
    X, U, Xn, live, errs = [], [], [], [], []
    for k in range(cfg.max_steps):
        with span("fleet.cycle"):
            sol, st_new, x_next = cycle(st, x, k)
            x_out = torch.where(landed[:, None], x, x_next)
            st = freeze_lanes(landed, st, st_new)
            # the controller model's one-step prediction error on live steps
            pred = F_nom(x, sol.u0) + dt * mean_fn(x, sol.u0)
            err = torch.linalg.vector_norm(x_next - pred, dim=-1)
            X.append(x)
            U.append(sol.u0)
            Xn.append(x_out)
            live.append(~landed)
            errs.append(torch.where(landed, torch.zeros_like(err), err))
            landed = landed | (x_next[:, 1] < cfg.landing_altitude)
            x = x_out
        if bool(landed.all()):
            break
    X, U, Xn = torch.stack(X, 1), torch.stack(U, 1), torch.stack(Xn, 1)
    live = torch.stack(live, 1)
    n_live = live.to(x.dtype).sum(1).clamp_min(1.0)
    return {
        "x_final": x, "landed": landed, "speed": torch.linalg.vector_norm(x[:, 4:7], dim=-1),
        "X": X, "U": U, "Xn": Xn,
        # a frozen lane repeats x: those rows are no training data
        "valid": live & ((Xn - X).abs() > 1e-12).any(-1),
        "model_err": torch.stack(errs, 1).sum(1) / n_live,
    }


def default_mpc(p_nom, n_x: int, dt: float, device: torch.device) -> GPMPCConfig:
    """The fleet's controller when none is given. 3-DoF: the sparse-form
    ``RTIConfig()`` (N = 15, 100 ADMM iterations with polish) in two SCP
    iterations without tightening. 6-DoF: the campaign-certified condensed
    ``rti_config_6dof(N=15)`` with 100 fixed-ρ iterations and tightening,
    which keeps the rough GP between retunes from walking the descent off
    its braking profile."""
    from ..mpc.rti6dof import rti_config_6dof
    from ..ops.qp import ADMMConfig

    if n_x >= 14:
        # the JAX package sets use_pallas="off" here; "auto" runs the same
        # chunk arithmetic in the hand-written kernel on the card (its plain
        # version on the CPU)
        base = rti_config_6dof(p_nom, N=15, dt=dt, admm=ADMMConfig(
            max_iter=100, polish=False, adaptive_rho=False, scaling=3, use_pallas="auto"),
            device=device).replace(accept_pri_tol=1e-2, condensed=True)
        return GPMPCConfig(base=base, scp_iterations=2, tighten=True)
    return GPMPCConfig(base=RTIConfig(dt=dt, device=device), scp_iterations=2, tighten=False)


def run_batched_learning(
    generator: Optional[torch.Generator],
    p_nom,
    plant_step: Callable[[Tensor, Tensor], Tensor],
    x0s,
    config: Optional[BatchedLearningConfig] = None,
    mpc: Optional[GPMPCConfig] = None,
    x_target: Optional[Tensor] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """Run ``n_rounds`` of fleet learning on x0s (B, n_x): every lane flies
    each round with its own GP (round 0 flies nominal), then refits on its
    own buffer. ``generator`` draws the k-means starts (the template's, then
    every round's); ``plant_step(x (B, n_x), u (B, 3))`` is the true plant.

    Returns per-round, per-lane metrics — ``landed``, ``touchdown_speed``,
    ``model_err`` (the mean one-step prediction error of each lane's
    controller model along its flown trajectory), ``success`` (R, B) — plus
    ``gp_fitted`` (B,) and ``gps``, the lane-batched GP, and the GP and the
    activation gate each round flew with, ``gps_by_round`` (R) and
    ``use_gp_by_round`` (R, B)."""
    cfg = config or BatchedLearningConfig()
    dev = resolve_device(device)
    x0s = as_f32(x0s, dev)
    Bsz, n_x = x0s.shape
    dt = cfg.dt
    mpc = mpc or default_mpc(p_nom, n_x, dt, dev)
    if n_x >= 14:
        xT = r6.create_initial_state(p_nom, altitude=0.0) if x_target is None else x_target
        F_nom = lambda x, u: r6.step(p_nom, x, u, dt)
    else:
        if x_target is None:
            xT = torch.zeros(7, device=dev)
            xT[0] = 2.0
        else:
            xT = x_target
        F_nom = lambda x, u: r3.step(p_nom, x, u, dt)
    xT = as_f32(xT, dev)
    collector = ResidualCollector(dt=dt)

    gps = _template_gp(cfg.gp, generator, n_x, Bsz, dev)
    fitted = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    keys = ("landed", "touchdown_speed", "model_err", "success")
    metrics = {k: [] for k in keys}
    flown, gates = [], []
    for r in range(cfg.n_rounds):
        flown.append(gps)
        gates.append(fitted)
        ep = fleet_episode(F_nom, plant_step, mpc, gps, fitted, x0s, xT, cfg)
        with span("fleet.refit"):
            res = collector.collect_batch(F_nom, ep["X"], ep["U"], ep["Xn"])
            gps = gps.add_data_batch_masked(ep["X"], ep["U"], res, ep["valid"])
            # the refit barrier: every lane refits on its own buffer (k-means + FITC)
            gps = gps.fit(generator)
        if cfg.tune_every > 0 and r % cfg.tune_every == cfg.tune_every - 1:
            with span("fleet.tune"):
                gps = _tune_lane(gps, cfg.tune_steps)
        fitted = fitted | (gps.buffer_count >= cfg.min_points_for_gp)
        for k, v in zip(keys, (ep["landed"], ep["speed"], ep["model_err"],
                               ep["landed"] & (ep["speed"] < cfg.success_speed))):
            metrics[k].append(v)
    out = {k: torch.stack(v) for k, v in metrics.items()}
    out.update(gp_fitted=fitted, gps=gps, gps_by_round=flown, use_gp_by_round=torch.stack(gates))
    return out
