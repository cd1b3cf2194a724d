"""The configurations of the port's paths, in one place, each with the chunk
kernel selected (``use_pallas="auto"``):

- :func:`main_path` — the 3-DoF GP-MPC real-time cycle that ``bench.py``
  times as its primary metric (``bench.py:78-132``);
- :func:`rti_path` — the GP-free RTI cycle on the nominal plant, its
  secondary metric (``bench.py:110-115``, ``:186-201``); :func:`rti_warm_path`
  — the sparse-form RTI cycle with the KKT inverse carried across cycles
  (``scripts/bench_variants.py``'s ``"sparse_warm"``);
- :func:`pretrain_path` — the production GP fit, ``pretrain_gp_3dof`` under
  the dispersed plant, whose GP then serves the GP-MPC cycle;
- :func:`calibration_path` — the bound-riding GP-MPC cycle of the
  chance-constraint calibration campaign (``scripts/run_calibration_tpu.py``):
  the state bounds stay in the condensed QP (n = 60, m = 200), a fleet rides
  the tightened descent-speed bound under a gust of known σ, and
  :func:`fly_calibration` returns the campaign's observables;
- :func:`sixdof_path` — Path D, the 6-DoF quaternion GP-MPC cycle the bench
  times as ``gp_mpc_6dof_*`` (``bench.py:324-381``), and the 6-DoF landing
  campaign ``scripts/run_campaign_tpu.py --model 6dof --controller gp_mpc
  --rt`` flies with it (:func:`fly_sixdof`); :func:`sixdof_pretrain_path`
  fits its GP;
- :func:`online_path` — Path E, the online-learning GP-MPC cycle that the
  bench times as ``online_gpmpc_*`` (``bench.py:277-322``): every lane
  carries its own GP, learning inside the loop; :func:`online_flight_path`
  and :func:`fly_online` fly it as ``scripts/run_campaign_tpu.py
  --controller online_gp_mpc --elide`` does, for the 3-DoF and the 6-DoF
  model;
- :func:`fleet_learning_path` — Path F, fleet GP learning
  (``scripts/run_fleet_learning_tpu.py``): ``run_batched_learning`` over
  128 (3-DoF) or 64 (6-DoF) lanes, each flying closed-loop GP-MPC episodes
  with its own sparse GP, refitting at the round barrier and retuning on a
  cadence; :func:`fly_fleet` flies it and returns the artifact's fields;
- :func:`lmpc_fleet_path` — Path G, fleet LMPC (``scripts/run_fleet_lmpc_tpu.py``):
  256 lanes fly closed-loop LMPC episodes against one shared sampled safe
  set, the interior-point solver on the condensed convex-hull QP, the
  successful trajectories joining the set between rounds, for the 3-DoF
  and the 6-DoF model; :func:`fly_lmpc_fleet` flies it and returns the
  script's result dictionary, checkpointing each round and resuming after
  the last one completed (the script's ``--checkpoint``);
- :func:`sharded_campaign_path` — the 2048-lane 3-DoF GP-MPC campaign with
  the lanes sharded over the process group (``scripts/run_campaign_tpu.py
  --controller gp_mpc --rt --sharded``), flown by :func:`fly_sharded_campaign`;
- the safety-filtered campaigns: :func:`safety_rescue_path` (the RTI
  controller flying into a low-altitude downdraft behind the funnel
  filter) and :func:`safety_gpmpc_path` (the GP-MPC campaign behind the
  velocity-ellipsoid filter), each flown with and without its filter by
  :func:`fly_safety`; :func:`online_safety_path` (the online GP-MPC
  learner behind a filter that reads each lane's own GP), flown across
  episodes by :func:`fly_online_safety`;
- :func:`experiment_suite_path` — the experiment suite,
  ``scripts/run_experiments.py`` (a GP pretrained on a plant with an
  unmodelled downdraft; GP-MPC, the GP-free RTI ablation and four
  baselines; the dispersion sweep; the exports and the z-test), flown by
  :func:`fly_experiments`; :func:`scvx_library_path` — the SCVX free-time
  trajectory library, flown by :func:`fly_scvx_library`.

``chip_smoke.py`` and ``gpmpc_tpu_torch/profile_cycle.py`` drive them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ._device import DeviceLike, resolve_device
from .dynamics import Rocket3DoFParams, Rocket6DoFParams, rocket3dof as r3, rocket6dof as r6
from .dynamics.rocket3dof import as_vertical, gust_accel
from .gp import StructuredGPConfig
from .learning.batched_learner import BatchedLearningConfig, default_mpc, run_batched_learning
from .lmpc import LMPCConfig, default_stage_cost, fly_episode, lmpc_config_6dof, lmpc_plan_value
from .learning.online_gp_mpc import (OnlineGPMPCConfig, carry_gp_between_episodes,
                                     make_online_gp_mpc_controller, online_controller_info)
from .learning.pretrain import gp_fns, pretrain_gp_3dof, pretrain_gp_6dof  # noqa: F401  (gp_fns: re-exported for chip_smoke.py)
from .experiments import (SimulationConfig, campaign_statistics, run_campaign,
                          sample_initial_conditions, wilson_interval)
from .mpc import (GPMPCConfig, RTIConfig, gp_mpc_solve, make_gp_mpc_controller,
                  make_rti_controller, rti_closed_loop, rti_config_6dof)
from .mpc.constraints import normal_quantile
from .mpc.cycle_replay import declare_frozen, is_frozen
from .ops.qp import ADMMConfig
from .parallel import run_sharded_campaign
from .reference import cubic_descent_reference, pad_reference
from .safety import (DescentFunnelSet, EllipsoidalInvariantSet, EmergencyBrakingController,
                     SafetyFilterConfig, filtered_controller_info, make_filtered_controller)
from .terminal import SafeSet, knn_bucket, trim
from .terminal import prune as prune_safe_set
from .utils import CampaignCheckpointer

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
        F=r3.Rocket3DoFStep(p, DT),
        F_true=r3.Rocket3DoFStep(p_true, DT),
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


RTI_WARM_ITERS = 50  # bench_variants.py's "sparse_warm": 50 iterations, two chunks of 25


def rti_warm_path(device: DeviceLike = "cuda", warm_kkt: bool = True) -> RTIPath:
    """``scripts/bench_variants.py``'s ``"sparse_warm"`` (``:29-32``), the
    configuration ``scripts/profile_cycle.py`` profiles: the sparse-form QP
    (n = 207, m = 354), 50 fixed-ρ iterations in chunks of 25 without polish,
    three Ruiz passes, ``accept_pri_tol`` 5e-3, and the KKT inverse carried
    across cycles (``warm_kkt``; False gives the same cycle factoring by
    Cholesky every cycle). The plant is the nominal model; the fleet is
    :func:`fleet_x0`, ``scripts/profile_cycle.py``'s states (``:39-40``)."""
    dev = resolve_device(device)
    p = Rocket3DoFParams(device=dev)
    cfg = RTIConfig(
        N=N, accept_pri_tol=5e-3, warm_kkt=warm_kkt,
        admm=ADMMConfig(max_iter=RTI_WARM_ITERS, polish=False, adaptive_rho=False, scaling=3,
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


V_LIM = -2.2  # the descent-speed floor on x[4] that the calibration fleet rides
GUST_SIGMA = 0.35  # std of the injected per-step velocity gust (v += dt·N(0, σ²))
CALIBRATION_STEPS = 90


class CalibrationPath(NamedTuple):
    params: Rocket3DoFParams
    F: Callable  # nominal step
    F_true: Callable  # drag plant (the gust rides on top of it)
    config: GPMPCConfig
    x_target: torch.Tensor
    reference_fn: Callable  # x0s (B, 7) → each lane's fast descent reference
    v_lim: float
    gust_sigma: float


def calibration_path(device: DeviceLike = "cuda", confidence: float = 0.95) -> CalibrationPath:
    """The configuration the chance constraints are certified on
    (``scripts/run_calibration_tpu.py:90-132``): condensed, every state bound
    kept, x[4] ≥ -2.2 the bound under test, 50 iterations in one chunk. The
    QP is n = 60, m = 200, declared ``("blt", 5, 28, 12), ("diag", 60)``. The
    reference descends 16 m in 4.2 s, faster than the bound allows, so the
    plan rides the tightened bound."""
    dev = resolve_device(device)
    mp = main_path(dev)
    cfg = GPMPCConfig(
        base=RTIConfig(
            N=N, dt=DT, accept_pri_tol=1e-2, condensed=True,
            x_min=torch.tensor([-1e20, -100.0, -100.0, -100.0, V_LIM, -50.0, -50.0]),
            admm=ADMMConfig(max_iter=ADMM_ITERS, check_interval=ADMM_ITERS, scaling=2,
                            polish=False, adaptive_rho=False, infeas_certs=False,
                            use_pallas="auto"),
            device=dev,
        ),
        scp_iterations=1, tighten=True, confidence=confidence, rollout_gp_tape=True,
    )
    xT = mp.x_target
    return CalibrationPath(
        params=mp.params, F=mp.F, F_true=mp.F_true, config=cfg, x_target=xT,
        reference_fn=lambda x0: cubic_descent_reference(x0, xT, 42, DT),
        v_lim=V_LIM, gust_sigma=GUST_SIGMA)


def calibration_x0(generator: torch.Generator, batch: int = BATCH,
                   device: DeviceLike = "cuda") -> torch.Tensor:
    """Initial states of the calibration fleet: Gaussian around 16 m, every
    lane at least 1 m/s above the bound (a lane sampled past it would spend
    its transient in violation through no fault of the tightening)."""
    x0s = sample_initial_conditions(
        generator, SimulationConfig(max_steps=CALIBRATION_STEPS, altitude_mean=16.0,
                                    altitude_std=1.0), batch, n_x=7, device=device)
    x0s[:, 4] = x0s[:, 4].clamp_min(V_LIM + 1.0)
    return x0s


def with_gust_variance(var_fn: Callable, gust_sigma: float = GUST_SIGMA) -> Callable:
    """The total one-step velocity uncertainty: GP posterior variance plus
    the known gust power; frozen where ``var_fn`` is
    (``mpc/cycle_replay.py``)."""
    fn = lambda x, u: var_fn(x, u) + gust_sigma**2
    if is_frozen(var_fn):
        declare_frozen(fn)
    return fn


def calibration_cycle(cp: CalibrationPath, mean_fn: Callable, var_fn: Callable,
                      x0s: torch.Tensor, generator: torch.Generator) -> Callable:
    """``cycle(state, xs) → (sol, state, xs⁺)`` for timing and profiling the
    path: the k-th call tracks the window at step k of each lane's reference
    (held at its last row past its end), solves, and steps the drag plant
    plus a gust drawn from ``generator``."""
    n_win = cp.config.base.N + 1
    ref = pad_reference(cp.reference_fn(x0s), n_win)
    step = [0]

    def cycle(state, xs):
        k = min(step[0], ref.shape[1] - n_win)
        step[0] += 1
        state = state.replace(x_ref=ref[:, k:k + n_win])
        sol, state = gp_mpc_solve(cp.F, mean_fn, var_fn, cp.config, state, xs)
        gust = cp.gust_sigma * torch.randn(xs.shape[0], 3, generator=generator,
                                           device=generator.device).to(xs.device)
        xn = cp.F_true(xs, sol.u0)
        return sol, state, torch.cat([xn[:, :4], xn[:, 4:] + DT * gust], dim=1)

    return cycle


def fly_calibration(cp: CalibrationPath, mean_fn: Callable, var_fn: Callable,
                    x0s: torch.Tensor, generator: torch.Generator,
                    steps: int = CALIBRATION_STEPS) -> Dict[str, float]:
    """Fly the fleet for ``steps`` cycles under the drag plant plus the gust
    (drawn from ``generator``, (B, 3) a step) and return the campaign's
    observables. ``var_fn`` is the total variance (:func:`with_gust_variance`).

    The bound counts as live above 1 m after the first 8 steps; a lane
    freezes at touchdown. ``calibrated`` and ``coverage_calibrated`` are the
    campaign's own gates: the Wilson upper bound of the realized violation
    rate of v ≥ v_lim within 0.01 of 1 − confidence, and the one-step
    coverage |v⁺ − v_pred| ≤ κ·dt·σ within 0.05 of the two-sided Gaussian
    target 2·confidence − 1."""
    cfg = cp.config
    dev = x0s.device
    conf = cfg.confidence
    kappa = float(normal_quantile(torch.tensor(conf)))
    cinit, cstep = make_gp_mpc_controller(
        cp.F, mean_fn, var_fn, cfg, cp.x_target, reference_fn=cp.reference_fn,
        ref_horizon=steps)
    x = x0s
    cs = cinit(x0s)
    n_active = n_viol = n_near = n_inside = airborne = 0.0
    finite = True
    for k in range(steps):
        u, cs = cstep(cs, x, k)
        gust = cp.gust_sigma * torch.randn(x.shape[0], 3, generator=generator,
                                           device=generator.device).to(dev)
        x_next = cp.F_true(x, u)
        x_next = torch.cat([x_next[:, :4], x_next[:, 4:7] + DT * gust], dim=1)
        # the one-step prediction the tightening prices: nominal + GP mean,
        # σ² = dt²·(GP variance + gust variance)
        pred = cp.F(x, u)[:, 4:7] + DT * mean_fn(x, u)[:, 4:7]
        inside = (x_next[:, 4:7] - pred).abs() <= kappa * DT * torch.sqrt(var_fn(x, u))
        frozen = x[:, 1] <= 0.1
        live = (x[:, 1] > 1.0) & (k >= 8) & ~frozen
        x_next = torch.where(frozen[:, None], x, x_next)
        finite = finite and bool(torch.isfinite(u).all() & torch.isfinite(x_next).all())
        n_active += float(live.sum())
        n_viol += float((live & (x_next[:, 4] < cp.v_lim)).sum())
        n_near += float((live & (x_next[:, 4] < cp.v_lim + 0.3)).sum())
        n_inside += float((inside & live[:, None]).sum())
        airborne += float((~frozen).sum())
        x = x_next
    rate = n_viol / max(n_active, 1.0)
    upper = float(wilson_interval(n_viol, max(n_active, 1.0))[1])
    cover = n_inside / max(3.0 * n_active, 1.0)
    return {
        "confidence": conf,
        "kappa": kappa,
        "finite": finite,
        "active_steps": int(n_active),
        "realized_violation": rate,
        "realized_upper95": upper,
        "calibrated": upper <= (1.0 - conf) + 0.01,
        "binding_rate": n_near / max(n_active, 1.0),
        "one_step_coverage": cover,
        "coverage_calibrated": abs(cover - (2.0 * conf - 1.0)) < 0.05,
        "landed_rate": float((x[:, 1] <= 0.1).float().mean()),
        "steps_to_land_mean": airborne / x.shape[0],
    }


SIXDOF_ITERS = 60  # the 6-DoF real-time ADMM budget, in chunks of 30 (bench.py:347)
SIXDOF_CHUNK = 30
SIXDOF_STEPS = 150  # the campaign's episode length
SIXDOF_REF_STEPS = 100  # its cubic reference's length (run_campaign_tpu.py --ref-steps)


class SixDoFPath(NamedTuple):
    params: Rocket6DoFParams  # the controller's nominal model
    F: Callable  # nominal step
    F_true: Callable  # dispersed plant: light aero and a steady wind
    config: GPMPCConfig
    x_target: torch.Tensor
    reference_fn: Callable  # x0s (B, 14) → each lane's cubic descent reference


def sixdof_path(device: DeviceLike = "cuda") -> SixDoFPath:
    """Path D: the bench's 6-DoF configuration (``bench.py:337-353``). The
    nominal model is the Szmuk rocket; the plant adds aero (ρ = 0.8, C_A =
    0.05·I) and dt·wind with wind 0.10 on x[5] and 0.06 on x[6]. The QP is
    condensed with the translation bound rows elided: n = 60, m = 200
    (7 × 20 attitude and rate bound rows, then the controls), declared
    ``("blt", 5, 28, 12), ("diag", 60)``; 60 ADMM iterations in two chunks of
    30, no polish, no adaptive ρ, no certificates; one SCP iteration with
    the GP tape and the chance tightening."""
    dev = resolve_device(device)
    p = Rocket6DoFParams(device=dev)
    p_true = p.replace(rho=0.8, C_A=0.05 * torch.eye(3))
    wind = torch.zeros(14, device=dev)
    wind[5], wind[6] = 0.10, 0.06
    base = rti_config_6dof(
        p, N=N, bound_translation=False,
        admm=ADMMConfig(max_iter=SIXDOF_ITERS, check_interval=SIXDOF_CHUNK, polish=False,
                        adaptive_rho=False, scaling=2, infeas_certs=False, use_pallas="auto"),
    ).replace(accept_pri_tol=1e-2, condensed=True)
    xT = r6.create_initial_state(p, altitude=0.0)
    return SixDoFPath(
        params=p,
        F=r6.Rocket6DoFStep(p, DT),
        F_true=lambda x, u: r6.step(p_true, x, u, DT) + DT * wind,
        config=GPMPCConfig(base=base, scp_iterations=1, tighten=True, rollout_gp_tape=True),
        x_target=xT,
        reference_fn=lambda x0: cubic_descent_reference(x0, xT, SIXDOF_REF_STEPS, DT),
    )


def sixdof_pretrain_path(generator: torch.Generator, device: DeviceLike = "cuda", **kw):
    """Path D's GP: ``pretrain_gp_6dof`` with its nominal model and dispersed
    plant (``bench.py:343-344``: four 64-step episodes of the sparse-form
    ``rti_config_6dof(N=15)``, n = 269, m = 493; FITC fits; 150 Adam steps).
    Returns (gp, mean_fn, var_fn); ``kw`` goes to ``pretrain_gp_6dof``."""
    sp = sixdof_path(device)
    return pretrain_gp_6dof(generator, sp.params, sp.F_true, dt=DT,
                            device=resolve_device(device), **kw)


def sixdof_fleet_x0(generator: torch.Generator, batch: int = BATCH,
                    device: DeviceLike = "cuda") -> torch.Tensor:
    """The timed cycle's fleet (``bench.py:357-363``): wet mass, altitude
    15 + 2·N(0, 1) drawn from ``generator``, velocity (−2, 0.1, 0), upright,
    at rest in attitude."""
    dev = resolve_device(device)
    alt = 15.0 + 2.0 * torch.randn(batch, generator=generator, device=generator.device).to(dev)
    x0 = r6.create_initial_state(Rocket6DoFParams(device=dev), altitude=0.0,
                                 velocity=(-2.0, 0.1, 0.0)).repeat(batch, 1)
    return torch.cat([x0[:, :1], alt[:, None], x0[:, 2:]], dim=1)


def sixdof_flight_x0(generator: torch.Generator, batch: int = BATCH,
                     device: DeviceLike = "cuda") -> torch.Tensor:
    """The campaign's initial states (``run_campaign_tpu.py:517-520``):
    ``sample_initial_conditions`` around 20 m (σ 2 m), identity attitude."""
    return sample_initial_conditions(
        generator, SimulationConfig(max_steps=SIXDOF_STEPS, altitude_mean=20.0, altitude_std=2.0),
        batch, n_x=14, device=device)


def fly_sixdof(sp: SixDoFPath, mean_fn: Callable, var_fn: Callable, x0s: torch.Tensor,
               steps: int = SIXDOF_STEPS) -> Dict:
    """The 6-DoF GP-MPC landing campaign: every lane tracks its cubic descent
    reference under the dispersed plant for up to ``steps`` cycles, judged by
    the campaign's outcome state machine. Returns (per-lane results,
    ``campaign_statistics`` of them)."""
    cinit, cstep = make_gp_mpc_controller(sp.F, mean_fn, var_fn, sp.config, sp.x_target,
                                          reference_fn=sp.reference_fn, ref_horizon=steps)
    res = run_campaign(cinit, cstep, sp.F_true, x0s,
                       SimulationConfig(max_steps=steps, altitude_mean=20.0, altitude_std=2.0))
    return res, campaign_statistics(res)


ONLINE_REF_HORIZON = 200  # the timed online cycle's (bench.py:290-295)
ONLINE_ERR_LEN = 8
# the online campaigns' scenarios: episode length and initial altitude
ONLINE_SIM = {"3dof": SimulationConfig(max_steps=130, altitude_mean=30.0, altitude_std=2.0),
              "6dof": SimulationConfig(max_steps=150, altitude_mean=20.0, altitude_std=2.0)}


class OnlinePath(NamedTuple):
    F: Callable  # nominal step: the controller's model
    F_true: Callable  # the plant
    config: OnlineGPMPCConfig
    x_target: torch.Tensor
    reference_fn: Callable  # x0s (B, n_x) → each lane's cubic descent reference
    ref_horizon: int
    err_len: int
    sim: SimulationConfig  # the campaign's scenario (the timed cycle flies no campaign)

    def controller(self):
        """(cinit, cstep) of the online controller, ``run_campaign``'s protocol."""
        return make_online_gp_mpc_controller(self.F, self.config, self.x_target,
                                             self.reference_fn, self.ref_horizon, self.err_len)


def online_path(device: DeviceLike = "cuda") -> OnlinePath:
    """Path E, the timed online cycle (``bench.py:277-322``): the main path's
    GP-MPC configuration (n = m = 60, ``("diag", 60)``, 50 iterations in one
    chunk) inside ``OnlineGPMPCConfig``'s defaults (160 points, 32 inducing,
    refit every 10 cycles, hyperparameter refresh every 20), cubic references
    of 100 steps, ``ref_horizon`` 200, ``err_len`` 8, the drag plant. The
    fleet is :func:`fleet_x0`."""
    mp = main_path(device)
    xT = mp.x_target
    return OnlinePath(F=mp.F, F_true=mp.F_true, config=OnlineGPMPCConfig(mpc=mp.config),
                      x_target=xT,
                      reference_fn=lambda x0: cubic_descent_reference(x0, xT, 100, DT),
                      ref_horizon=ONLINE_REF_HORIZON, err_len=ONLINE_ERR_LEN,
                      sim=SimulationConfig())


def online_flight_path(model: str, device: DeviceLike = "cuda") -> OnlinePath:
    """The online campaigns, ``scripts/run_campaign_tpu.py --controller
    online_gp_mpc --elide`` with its defaults (N = 20, cubic references of 100
    steps, ``ref_horizon`` = ``err_len`` = the episode length):

    - ``"3dof"`` (``:91-110``, ``:112-141``): 130 steps from 30 m (σ 2 m); the
      dispersed plant is the drag plant plus dt·wind, wind 0.4 on x[5] and
      0.25 on x[6]; the QP is the main path's (every state bound elided,
      50 iterations in one chunk, scaling 2, no certificates);
    - ``"6dof"`` (``:228-291``): 150 steps from 20 m (σ 2 m); Path D's plant
      and QP (translation bounds elided: n = 60, m = 200) with 100 iterations
      in chunks of 50.
    """
    dev = resolve_device(device)
    if model == "3dof":
        mp = main_path(dev)
        wind = torch.zeros(7, device=dev)
        wind[5], wind[6] = 0.4, 0.25
        F_true = lambda x, u: mp.F_true(x, u) + DT * wind
        F, cfg, xT = mp.F, mp.config, mp.x_target
    elif model == "6dof":
        sp = sixdof_path(dev)
        base = sp.config.base
        cfg = sp.config.replace(base=base.replace(admm=base.admm.replace(
            max_iter=100, check_interval=50)))
        F, F_true, xT = sp.F, sp.F_true, sp.x_target
    else:
        raise ValueError(f"unknown model {model!r}: use '3dof' or '6dof'")
    sim = ONLINE_SIM[model]
    return OnlinePath(F=F, F_true=F_true, config=OnlineGPMPCConfig(mpc=cfg), x_target=xT,
                      reference_fn=lambda x0: cubic_descent_reference(x0, xT, 100, DT),
                      ref_horizon=sim.max_steps, err_len=sim.max_steps, sim=sim)


def online_flight_x0(model: str, generator: torch.Generator, batch: int = BATCH,
                     device: DeviceLike = "cuda") -> torch.Tensor:
    """The online campaigns' initial states: ``sample_initial_conditions``
    around 30 m (3-DoF) or Path D's campaign fleet around 20 m (6-DoF)."""
    if model == "6dof":
        return sixdof_flight_x0(generator, batch, device)
    return sample_initial_conditions(generator, ONLINE_SIM["3dof"], batch, n_x=7, device=device)


def learning_trace(err_hist: torch.Tensor, steps: int) -> Dict[str, float]:
    """The campaign script's learning trace (``run_campaign_tpu.py:680-700``)
    from the per-lane one-step model errors (B, steps), nan where a lane
    flew no real transition: the mean over cycles 2-11 and over the cycles
    from min(60, steps − 20) on, their ratio, and the curve every 5 cycles."""
    eh = err_hist.double().cpu()
    nanmean = lambda t: float(t.nanmean())
    lo = min(60, steps - 20)
    early, late = nanmean(eh[:, 2:12]), nanmean(eh[:, lo:])
    curve = eh.nanmean(0)[::5].tolist()
    return {"model_err_cycles_2_12": early, f"model_err_cycles_{lo}_plus": late,
            "model_err_reduction_x": early / max(late, 1e-12),
            "err_curve_by5": [None if math.isnan(v) else v for v in curve]}


def fly_online(op: OnlinePath, x0s: torch.Tensor) -> tuple:
    """The online campaign: every lane starts with an empty GP, learns the
    plant gap in flight and is judged by the outcome state machine. Returns
    (per-lane results with the learning trace's fields, ``campaign_statistics``,
    the learning trace with ``gp_points_mean`` and ``n_refits_mean``)."""
    cinit, cstep = op.controller()
    res = run_campaign(cinit, cstep, op.F_true, x0s, op.sim, cstate_info=online_controller_info)
    trace = learning_trace(res["err_hist"], op.sim.max_steps)
    trace["gp_points_mean"] = float(res["gp_points"].float().mean())
    trace["n_refits_mean"] = float(res["n_refits"].float().mean())
    return res, campaign_statistics(res), trace


FLEET_LANES = {"3dof": 128, "6dof": 64}  # the published artifacts' widths


class FleetPath(NamedTuple):
    model: str
    params: object  # the controllers' nominal model
    F: Callable  # nominal step
    plant: Callable  # the true plant
    config: BatchedLearningConfig
    mpc: GPMPCConfig
    x_target: torch.Tensor


def fleet_learning_path(model: str, device: DeviceLike = "cuda") -> FleetPath:
    """Path F, ``scripts/run_fleet_learning_tpu.py`` with its defaults
    (``:57-91``): 3 rounds of 110 steps, 128 points and 24 inducing points a
    lane, an Adam retune of 40 steps every 2 rounds, and
    ``run_batched_learning``'s default controller:

    - ``"3dof"``: the plant adds drag (ρ = 1, C_D = 1, A_ref = 0.1) and dt·wind,
      wind 0.4 on x[5] and 0.25 on x[6]; the controller is the sparse-form
      ``RTIConfig()`` (N = 15: n = 157, m = 269; 100 iterations in chunks of
      25 with adaptive ρ and polish) in two SCP iterations;
    - ``"6dof"``: Path D's plant (ρ = 0.8, C_A = 0.05·I, wind 0.10/0.06);
      the controller is the condensed ``rti_config_6dof(N=15)`` with every
      state bound kept (n = 45, m = 255: 210 rows below the diagonal blocks,
      then the 45 control rows), 100 fixed-ρ iterations in chunks of 25, two
      SCP iterations with tightening.
    """
    dev = resolve_device(device)
    if model == "3dof":
        p = Rocket3DoFParams(device=dev)
        p_true = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
        wind = torch.zeros(7, device=dev)
        wind[5], wind[6] = 0.4, 0.25
        plant = lambda x, u: r3.step(p_true, x, u, DT) + DT * wind
        F = lambda x, u: r3.step(p, x, u, DT)
        xT = torch.zeros(7, device=dev)
        xT[0] = 2.0
    elif model == "6dof":
        p = Rocket6DoFParams(device=dev)
        p_true = p.replace(rho=0.8, C_A=0.05 * torch.eye(3))
        wind = torch.zeros(14, device=dev)
        wind[5], wind[6] = 0.10, 0.06
        plant = lambda x, u: r6.step(p_true, x, u, DT) + DT * wind
        F = lambda x, u: r6.step(p, x, u, DT)
        xT = r6.create_initial_state(p, altitude=0.0)
    else:
        raise ValueError(f"unknown model {model!r}: use '3dof' or '6dof'")
    cfg = BatchedLearningConfig(n_rounds=3, max_steps=110, dt=DT,
                                gp=StructuredGPConfig(max_data_points=128, n_inducing=24),
                                tune_every=2, tune_steps=40)
    return FleetPath(model=model, params=p, F=F, plant=plant, config=cfg,
                     mpc=default_mpc(p, xT.shape[0], DT, dev), x_target=xT)


def fleet_learning_x0(model: str, generator: torch.Generator, batch: Optional[int] = None,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """The fleet's initial states (``run_fleet_learning_tpu.py:64-85``),
    drawn from ``generator``: 3-DoF at (2, 28, 0.5, −0.5, −3, 0, 0) with
    altitude + 2·N(0,1) and horizontal position + 0.5·N(0,1); 6-DoF at
    altitude 16 + 5·U(0,1), velocity (−3, 0.3·N(0,1), −0.1), upright."""
    dev = resolve_device(device)
    B = FLEET_LANES[model] if batch is None else batch
    draw = lambda f, *shape: f(*shape, generator=generator, device=generator.device).to(dev)
    if model == "3dof":
        x0s = torch.tensor([2.0, 28.0, 0.5, -0.5, -3.0, 0.0, 0.0], device=dev).repeat(B, 1)
        x0s[:, 1] += 2.0 * draw(torch.randn, B)
        x0s[:, 2:4] += 0.5 * draw(torch.randn, B, 2)
        return x0s
    alts, vys = 16.0 + 5.0 * draw(torch.rand, B), 0.3 * draw(torch.randn, B)
    x0s = r6.create_initial_state(Rocket6DoFParams(device=dev), altitude=0.0,
                                  velocity=(-3.0, 0.0, -0.1)).repeat(B, 1)
    x0s[:, 1], x0s[:, 5] = alts, vys
    return x0s


def fleet_summary(out: Dict, batch: int) -> Dict:
    """The artifact's fields (``run_fleet_learning_tpu.py:106-133``) from
    ``run_batched_learning``'s output, and its gate: model error final/first
    < 0.5, last-round landed ≥ 0.95·B, every lane's GP fitted."""
    me = out["model_err"].double().cpu()
    landed = out["landed"].sum(1).tolist()
    res = {
        "batch": batch,
        "model_err_by_round": me.mean(1).tolist(),
        "model_err_final_over_first": float(me[-1].mean() / me[0].mean()),
        "lanes_improved": int((me[-1] < me[0]).sum()),
        "gp_fitted_all": bool(out["gp_fitted"].all()),
        "landed_by_round": landed,
        "success_by_round": out["success"].sum(1).tolist(),
        # np.median's definition (the mean of the two middle values at an even count)
        "touchdown_speed_median_by_round": [
            float(v.quantile(0.5)) for v in out["touchdown_speed"].double().cpu()],
    }
    res["gate"] = (res["model_err_final_over_first"] < 0.5
                   and landed[-1] >= int(0.95 * batch) and res["gp_fitted_all"])
    return res


def fly_fleet(fp: FleetPath, x0s: torch.Tensor, generator: torch.Generator) -> tuple:
    """Fly the fleet's rounds; returns (``run_batched_learning``'s output,
    :func:`fleet_summary`)."""
    out = run_batched_learning(generator, fp.params, fp.plant, x0s, fp.config, fp.mpc,
                               fp.x_target, device=x0s.device)
    return out, fleet_summary(out, x0s.shape[0])


LMPC_LANES, LMPC_ROUNDS, LMPC_STEPS = 256, 5, 150  # the fleet-LMPC artifacts' widths
LMPC_SETTLE = 8  # re-solves before the probe's value is read (the script's --settle)


class LMPCFleetPath(NamedTuple):
    model: str
    params: object
    F: Callable  # the controller's model and the plant
    config: LMPCConfig
    x_target: torch.Tensor
    x0_seed: torch.Tensor  # (n_x,) the seed flight's initial state, the probe lane's
    seed: tuple  # (X (T, n_x), U (T, n_u), stage costs (T,)) of the seed flight
    pert_scale: torch.Tensor  # (n_x,) half-widths of the fleet's uniform dispersion


def _seed_descent_3dof(p: Rocket3DoFParams, F: Callable, xT: torch.Tensor, cfg: LMPCConfig,
                       n_steps: int = 200):
    """The 3-DoF bootstrap (``scripts/run_fleet_lmpc_tpu.py:40-69``): a PD
    descent law flown for ``n_steps`` steps, frozen at touchdown (its later
    rows repeat the touchdown state at zero cost), scored with the episodes'
    stage cost."""
    p_clamp = p.replace(T_min=0.3, T_max=5.0)
    dev = xT.device
    x = torch.tensor([[2.0, 20.0, 0.5, 0.0, -2.0, 0.0, 0.0]], device=dev)
    landed = torch.zeros(1, dtype=torch.bool, device=dev)
    X, U, C = [], [], []
    for _ in range(n_steps):
        v_ref = -0.7 * torch.sqrt(x[:, 1].clamp_min(0.0))
        u = r3.hover_thrust(p, x) + torch.stack(
            [2.0 * (v_ref - x[:, 4]), -1.0 * x[:, 5] - 0.4 * x[:, 2],
             -1.0 * x[:, 6] - 0.4 * x[:, 3]], dim=-1)
        u = r3.clamp_thrust(p_clamp, u)
        cost = torch.where(landed, torch.zeros_like(x[:, 0]), default_stage_cost(x, u, xT, cfg))
        X.append(x)
        U.append(u)
        C.append(cost)
        x = torch.where(landed[:, None], x, F(x, u))
        landed = landed | (x[:, 1] < 0.05)
    if not bool(landed.all()):
        raise RuntimeError("the seed descent law must land")
    return X[0][0], torch.cat(X), torch.cat(U), torch.cat(C)


def _seed_rti_6dof(p: Rocket6DoFParams, F: Callable, xT: torch.Tensor, cfg: LMPCConfig,
                   n_steps: int = 150):
    """The 6-DoF bootstrap (``scripts/run_fleet_lmpc_tpu.py:71-98``): one
    RTI-flown landing, condensed ``rti_config_6dof(N=15)`` with 100 fixed-ρ
    iterations (the chunk kernel on the card), tracking a 100-step cubic
    reference; its live rows scored with the episodes' stage cost."""
    rcfg = rti_config_6dof(
        p, N=15, admm=ADMMConfig(max_iter=100, polish=False, adaptive_rho=False, scaling=3),
    ).replace(accept_pri_tol=1e-2, condensed=True)
    x0 = r6.create_initial_state(p, altitude=12.0, horizontal=(0.5, -0.3),
                                 velocity=(-1.5, 0.05, 0.0))[None]
    ref = pad_reference(cubic_descent_reference(x0, xT, 100, rcfg.dt), n_steps + rcfg.N + 1)
    res = rti_closed_loop(F, rcfg, x0, xT, n_steps, X_ref_full=ref)
    if not bool(res["landed"].all()):
        raise RuntimeError("the 6-DoF seed flight must land")
    n_live = int(res["steps"][0])
    X, U = res["X"][0, :n_live], res["U"][0, :n_live]
    return x0[0], X, U, default_stage_cost(X, U, xT, cfg)


def _lmpc_meta(checkpoint: Optional[str]) -> Optional[Dict]:
    """The campaign's ``meta.json`` in ``checkpoint``, if one was written."""
    path = os.path.join(checkpoint, "meta.json") if checkpoint else None
    if path is None or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def lmpc_fleet_path(model: str = "3dof", device: DeviceLike = "cuda", solver: str = "ipm",
                    touchdown_weight: float = 250.0, pool: int = 0,
                    pool_dist_weight: float = 0.0, same_traj: bool = False,
                    vertex_memory: bool = False, elide: bool = False,
                    checkpoint: Optional[str] = None) -> LMPCFleetPath:
    """The fleet-LMPC campaign of ``scripts/run_fleet_lmpc_tpu.py``, its
    configuration and seed flight. The keyword arguments are the script's
    flags (``--solver``, ``--touchdown-weight``, ``--pool``,
    ``--pool-dist-weight``, ``--same-traj``, ``--vertex-memory``,
    ``--elide``), its defaults theirs:

    - ``"3dof"``: ``LMPCConfig`` (N = 15, the condensed hull QP: n = 45 + 10
      + 7 = 62, m = 105 blt + 45 diag + 18 hull rows), seeded by the PD
      descent law from (2, 20, 0.5, 0, −2, 0, 0); the fleet disperses
      altitude ±2, horizontal ±0.5, velocity ±0.3/0.1/0.1;
    - ``"6dof"``: ``lmpc_config_6dof`` (n = 45 + 10 + 14 = 69), seeded by one
      RTI-flown landing from 12 m; the fleet disperses altitude ±1.5,
      horizontal ±0.4, velocity ±0.25/0.05/0.05.

    ``elide`` drops the loose-envelope state-bound rows (3-DoF: all seven;
    6-DoF: the seven translation ones). With ``checkpoint``, a directory
    holding a campaign's ``meta.json`` pins ``solver`` and
    ``touchdown_weight`` to the campaign's before the seed is built: every
    stored cost-to-go is on that scale (``run_fleet_lmpc_tpu.py:174-190``)."""
    dev = resolve_device(device)
    meta = _lmpc_meta(checkpoint)
    if meta is not None:
        pinned = (meta["solver"], meta["touchdown_speed_weight"])
        if pinned != (solver, touchdown_weight):
            print(f"resume: pinning solver {solver} -> {pinned[0]}, touchdown weight "
                  f"{touchdown_weight} -> {pinned[1]} (campaign meta)")
        solver, touchdown_weight = pinned
    knobs = dict(solver=solver, touchdown_speed_weight=touchdown_weight, candidate_pool=pool,
                 candidate_dist_weight=pool_dist_weight, hull_same_trajectory=same_traj,
                 vertex_memory=vertex_memory, device=dev)
    if elide:
        knobs["x_bound_mask"] = (False,) * 7 + (True,) * 7 if model == "6dof" else (False,) * 7
    if model == "6dof":
        p = Rocket6DoFParams(device=dev)
        cfg = lmpc_config_6dof(p, **knobs)
        xT = r6.create_initial_state(p, altitude=0.0)
        F = lambda x, u: r6.step(p, x, u, cfg.dt)
        x0_seed, X, U, C = _seed_rti_6dof(p, F, xT, cfg)
        pert = (0.0, 1.5, 0.4, 0.4, 0.25, 0.05, 0.05) + (0.0,) * 7
    elif model == "3dof":
        p = Rocket3DoFParams(device=dev)
        cfg = LMPCConfig(**knobs)
        xT = torch.zeros(7, device=dev)
        xT[0] = 2.0
        F = lambda x, u: r3.step(p, x, u, cfg.dt)
        x0_seed, X, U, C = _seed_descent_3dof(p, F, xT, cfg)
        pert = (0.0, 2.0, 0.5, 0.5, 0.3, 0.1, 0.1)
    else:
        raise ValueError(f"unknown model {model!r}: use '3dof' or '6dof'")
    return LMPCFleetPath(model=model, params=p, F=F, config=cfg, x_target=xT, x0_seed=x0_seed,
                         seed=(X, U, C), pert_scale=torch.tensor(pert, device=dev))


def lmpc_fleet_x0(lp: LMPCFleetPath, generator: torch.Generator,
                  batch: int = LMPC_LANES) -> torch.Tensor:
    """The dispersed fleet: the seed's initial state plus U(−1, 1)·pert_scale
    drawn from ``generator``; lane 0 (the probe) at the seed's state."""
    dev = lp.x0_seed.device
    n_x = lp.x0_seed.shape[0]
    u = torch.rand(batch, n_x, generator=generator, device=generator.device).to(dev)
    x0s = lp.x0_seed[None] + (2.0 * u - 1.0) * lp.pert_scale
    x0s[0] = lp.x0_seed
    return x0s


def lmpc_capacity(lp: LMPCFleetPath, batch: int, rounds: int, steps: int = LMPC_STEPS) -> int:
    """The safe set's capacity that holds the seed and every round: the
    smallest power of two above their rows (:func:`fly_lmpc_fleet`'s
    default)."""
    return 1 << (batch * (steps + 1) * rounds + lp.seed[0].shape[0]).bit_length()


def _r(v, nd):
    return None if v is None else round(float(v), nd)


def fly_lmpc_fleet(lp: LMPCFleetPath, x0s: torch.Tensor, rounds: int = LMPC_ROUNDS,
                   steps: int = LMPC_STEPS, capacity: int = 0,
                   prune: Optional[str] = None, checkpoint: Optional[str] = None) -> tuple:
    """Fly the campaign (``scripts/run_fleet_lmpc_tpu.py:319-480``): the safe
    set starts from the seed flight; every round reads the probe's value
    estimate V(x0) at the seed's state (``lmpc_plan_value``, LMPC_SETTLE
    re-solves) and flies every lane's episode against the round's frozen set,
    both on the smallest power-of-four prefix that covers every written row
    (``knn_bucket`` of ``written``, ``trim``); the successful trajectories
    then join the set in lane order. ``prune`` ("quality", "fifo",
    "diversity") prunes to 80% of capacity once it is 90% full; capacity 0
    sizes the set to hold every round (pair ``prune`` with a smaller one).

    ``checkpoint`` is the script's ``--checkpoint``: a directory where
    ``meta.json`` (capacity, solver, touchdown weight; the capacity is part
    of the stored shapes, so a resume keeps it whatever ``rounds`` says),
    a checkpoint of the safe set and the probe's hull vertices after every
    round (``utils.CampaignCheckpointer``) and ``rounds.json`` (the rounds'
    summaries) are written. A later call resumes after the last completed
    round without flying it again; build its path with
    ``lmpc_fleet_path(..., checkpoint=)`` so that the solver and the
    shaping are the campaign's (``ValueError`` otherwise).

    Returns (the script's result dictionary with every round's summary and
    the campaign's ``probe_*`` fields, the final safe set). Times are this
    device's wall clock; a round's summary adds ``cycles`` (the solves its
    loop ran: it stops once every lane has landed) and ``ms_per_step``."""
    cfg, F, xT = lp.config, lp.F, lp.x_target
    dev = x0s.device
    batch, n_x = x0s.shape
    Xs, Us, Cs = lp.seed
    seed_cost = float(Cs.sum())
    cap = capacity or lmpc_capacity(lp, batch, rounds, steps)
    meta = _lmpc_meta(checkpoint)
    if meta is not None:
        cap = meta["capacity"]
        if (meta["solver"], meta["touchdown_speed_weight"]) != (cfg.solver,
                                                                cfg.touchdown_speed_weight):
            raise ValueError(
                f"the campaign in {checkpoint} flies solver {meta['solver']!r} and touchdown "
                f"weight {meta['touchdown_speed_weight']}; build the path with "
                f"lmpc_fleet_path(..., checkpoint=) to resume it")
    elif checkpoint is not None:
        os.makedirs(checkpoint, exist_ok=True)
        with open(os.path.join(checkpoint, "meta.json"), "w") as f:
            json.dump({"capacity": cap, "solver": cfg.solver,
                       "touchdown_speed_weight": cfg.touchdown_speed_weight}, f)
    ss = SafeSet.create(cap, n_x, device=dev).add_trajectory(Xs, Us, Cs)
    probe_verts = torch.full((1, cfg.n_terminal_vertices), -1, dtype=torch.int32, device=dev)
    rounds_out, probe_costs = [], []
    first_round, ckpt = 0, None
    if checkpoint is not None:
        ckpt = CampaignCheckpointer(checkpoint)
        done, carry = ckpt.restore_latest({"safe_set": ss, "probe_verts": probe_verts})
        if done is not None:
            ss, probe_verts = carry["safe_set"], carry["probe_verts"]
            with open(os.path.join(checkpoint, "rounds.json")) as f:
                rounds_out = json.load(f)[:done]
            probe_costs = [s["probe_lane_cost"] for s in rounds_out]
            first_round = done
            print(f"resumed after round {done} ({int(ss.n_trajectories)} trajectories)")
    t_start = time.time()
    for r in range(first_round, rounds):
        t0 = time.time()
        hw = int(ss.written)
        bucket = knn_bucket(hw, cap)
        view = trim(ss, bucket)
        V, _, new_verts = lmpc_plan_value(F, cfg, view, lp.x0_seed[None], xT,
                                          settle=LMPC_SETTLE, prev_vertices=probe_verts)
        if cfg.vertex_memory:
            probe_verts = new_verts
        out = fly_episode(F, cfg, view, x0s, xT, steps)
        ss = ss.add_trajectories(out["X"][:, :-1], out["U"], out["costs"], valid=out["success"])
        pruned_to = survived = None
        if prune is not None and float(ss.count) / cap > 0.9:
            ss = prune_safe_set(ss, int(0.8 * cap), strategy=prune)
            pruned_to = int(ss.count)
            if cfg.vertex_memory:
                pv = probe_verts[0].long()
                alive = ss.traj_ids[pv.clamp_min(0)] >= 0
                survived = int((alive & (pv >= 0)).sum())
        dt_round = time.time() - t0
        landed = out["landed"].cpu()
        n_landed = float(landed.float().sum())
        speed = torch.linalg.vector_norm(out["x_final"][:, 4:7], dim=1).double().cpu()
        summary = {
            "round": r + 1,
            "success_rate": _r(out["success"].float().mean(), 4),
            "total_cost_mean": _r(out["total_cost"].mean(), 1),
            "probe_lane_cost": _r(out["total_cost"][0], 1),
            "probe_plan_value": _r(V[0], 1),
            "probe_lane_steps": int(out["steps"][0]),
            "steps_mean": _r(out["steps"].float().mean(), 1),
            "qp_success_rate": _r(out["qp_success_rate"].mean(), 4),
            # over landed lanes only: one ballistic lane would swamp the mean
            "touchdown_speed_mean": (_r(speed[landed].sum() / n_landed, 3)
                                     if n_landed > 0 else None),
            # np.median's definition (the mean of the two middle values)
            "touchdown_speed_median": (_r(speed[landed].quantile(0.5), 3)
                                       if n_landed > 0 else None),
            "landed": int(landed.sum()),
            "safe_set_trajectories": int(ss.n_trajectories),
            "safe_set_states": int(ss.count),
            "pruned_to": pruned_to,
            "probe_verts_survived_prune": survived,
            "knn_bucket": bucket,
            "wall_s": round(dt_round, 1),
            "lmpc_cycles_per_s": round(batch * steps / dt_round, 1),
            "cycles": out["cycles"],
            "ms_per_step": dt_round * 1e3 / max(out["cycles"], 1),
        }
        rounds_out.append(summary)
        probe_costs.append(summary["probe_lane_cost"])
        if ckpt is not None:
            ckpt.save(r + 1, {"safe_set": ss, "probe_verts": probe_verts})
            with open(os.path.join(checkpoint, "rounds.json"), "w") as f:
                json.dump(rounds_out, f)
    wall = time.time() - t_start
    flown = rounds - first_round
    values = [s["probe_plan_value"] for s in rounds_out]
    result = {
        "campaign": f"fleet_lmpc_{lp.model}",
        "controller": "LMPC (condensed hull QP, fuel-filtered KNN terminal set)",
        "solver": cfg.solver,
        "touchdown_speed_weight": cfg.touchdown_speed_weight,
        "touchdown_speed_by_round": [s["touchdown_speed_mean"] for s in rounds_out],
        "touchdown_speed_median_by_round": [s["touchdown_speed_median"] for s in rounds_out],
        "batch": batch, "rounds": rounds, "max_steps": steps, "safe_set_capacity": cap,
        "prune_strategy": prune,
        "devices": [torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)],
        "seed_cost": round(seed_cost, 1),
        "probe_lane_costs": probe_costs,
        "probe_improves_on_seed": probe_costs[-1] < seed_cost,
        "probe_monotone_within_5pct": all(b <= a * 1.05 for a, b in
                                          zip(probe_costs, probe_costs[1:])),
        "probe_plan_values": values,
        "probe_value_monotone_within_1pct": all(b <= a * 1.01 for a, b in
                                                zip(values, values[1:])),
        "prune_events": [
            {"after_round": s["round"], "pruned_to": s["pruned_to"],
             "probe_verts_survived": s["probe_verts_survived_prune"],
             "probe_cost_pre": s["probe_lane_cost"],
             "probe_cost_post": (rounds_out[i + 1]["probe_lane_cost"]
                                 if i + 1 < len(rounds_out) else None),
             "touchdown_pre": s["touchdown_speed_mean"],
             "touchdown_post": (rounds_out[i + 1]["touchdown_speed_mean"]
                                if i + 1 < len(rounds_out) else None),
             "recovered_within_5pct": (rounds_out[i + 1]["probe_lane_cost"]
                                       <= s["probe_lane_cost"] * 1.05
                                       if i + 1 < len(rounds_out) else None)}
            for i, s in enumerate(rounds_out) if s["pruned_to"] is not None],
        "final_success_rate": rounds_out[-1]["success_rate"],
        "resumed_after_round": first_round or None,
        "episodes_flown": batch * flown,
        "episodes_per_s": round(batch * flown / wall, 2),
        "lmpc_cycles_per_s": round(batch * steps * flown / wall, 1),
        "wall_s": round(wall, 1),
        "per_round": rounds_out,
    }
    return result, ss


GPMPC_CAMPAIGN_LANES = 4096  # artifacts/campaign_gpmpc3dof_4096_rt.json's width


def gpmpc_campaign_gp(generator: torch.Generator, device: DeviceLike = "cuda"):
    """The 3-DoF GP-MPC campaign's GP (``run_campaign_tpu.py:143-146``):
    ``pretrain_gp_3dof`` with its defaults on the drag + wind plant that the
    campaign flies (:func:`online_flight_path`'s 3-DoF plant). Returns (gp,
    mean_fn, var_fn)."""
    fp = online_flight_path("3dof", device)
    return pretrain_gp_3dof(generator, Rocket3DoFParams(device=resolve_device(device)),
                            fp.F_true, dt=DT, device=resolve_device(device))


def _campaign_controller(fp: OnlinePath, mean_fn: Callable, var_fn: Callable):
    """(cinit, cstep) of the GP-MPC campaigns: ``fp``'s GP-MPC configuration
    with the campaign's GP, every lane tracking its cubic reference."""
    return make_gp_mpc_controller(fp.F, mean_fn, var_fn, fp.config.mpc, fp.x_target,
                                  reference_fn=fp.reference_fn, ref_horizon=fp.sim.max_steps)


def fly_gpmpc_campaign(mean_fn: Callable, var_fn: Callable, x0s: torch.Tensor) -> tuple:
    """``scripts/run_campaign_tpu.py --model 3dof --controller gp_mpc --rt
    --elide`` (``:91-110``, ``:143-160``): the main path's real-time GP-MPC
    configuration with the campaign's GP, every lane tracking its 100-step
    cubic descent reference under the drag + wind plant for up to 130
    steps, judged by the outcome state machine. Returns (per-lane results,
    ``campaign_statistics``)."""
    fp = online_flight_path("3dof", x0s.device)
    res = run_campaign(*_campaign_controller(fp, mean_fn, var_fn), fp.F_true, x0s, fp.sim)
    return res, campaign_statistics(res)


SHARDED_LANES = 2048  # artifacts/campaign_sharded_parity_cpu8_2048.json's width
SHARDED_LANES_PER_DEVICE = 256  # its lanes a device (8 devices)


def sharded_campaign_path(device: DeviceLike = "cuda") -> OnlinePath:
    """``scripts/run_campaign_tpu.py --model 3dof --controller gp_mpc --rt
    --sharded --parity --batch 2048 --steps 130``, as the artifact and
    ``docs/scaling.md:106`` ran it: :func:`fly_gpmpc_campaign`'s campaign
    without ``--elide``, so the state-bound rows stay in the condensed QP
    (n = 60, m = 200: 140 block-lower-triangular rows and the 60 diagonal
    ones; 50 iterations in one chunk). Initial states:
    :func:`sharded_campaign_x0`."""
    fp = online_flight_path("3dof", device)
    mpc = fp.config.mpc
    return fp._replace(config=dataclasses.replace(
        fp.config, mpc=mpc.replace(base=mpc.base.replace(x_bound_mask=None))))


def sharded_campaign_x0(generator: torch.Generator, batch: int = SHARDED_LANES,
                        device: DeviceLike = "cuda") -> torch.Tensor:
    """``sample_initial_conditions`` at altitude 30 ± 2 m (the script's
    ``--steps 130`` scenario)."""
    return sample_initial_conditions(generator, ONLINE_SIM["3dof"], batch, n_x=7, device=device)


def fly_sharded_campaign(mean_fn: Callable, var_fn: Callable, x0s: torch.Tensor,
                         mesh=None, **campaign_kw) -> Dict:
    """The sharded campaign: with a ``mesh`` (``parallel.hosts_chips_mesh``
    or ``scenario_mesh``), every rank is handed the global ``x0s`` and flies
    its block (``parallel.run_sharded_campaign``); without one, every lane
    of ``x0s`` in this process (the script's ``--parity`` re-fly).
    ``campaign_kw`` goes to ``run_campaign`` (``store_trajectories``).
    Returns ``{"results", "lanes", "stats"}`` either way."""
    fp = sharded_campaign_path(x0s.device)
    cinit, cstep = _campaign_controller(fp, mean_fn, var_fn)
    if mesh is not None:
        return run_sharded_campaign(mesh, cinit, cstep, fp.F_true, x0s, fp.sim, **campaign_kw)
    res = run_campaign(cinit, cstep, fp.F_true, x0s, fp.sim, **campaign_kw)
    return {"results": res, "lanes": slice(0, x0s.shape[0]), "stats": campaign_statistics(res)}


# -- the safety-filtered campaigns -------------------------------------------

SAFETY_LANES = 1024  # the rescue and GP-MPC safety artifacts' widths
RESCUE_STEPS, RESCUE_GUST = 150, -2.0
SAFETY_GPMPC_STEPS = 130
ONLINE_SAFETY_LANES, ONLINE_SAFETY_STEPS, ONLINE_SAFETY_GUST = 512, 110, -1.5
ONLINE_SAFETY_FILTER_N = 8
SAFETY_GPMPC_COMMIT = "ab18305"  # the commit the GP-MPC safety artifact was flown at


def _braking_filter(p: Rocket3DoFParams, N: int, dev: torch.device):
    """The campaigns' emergency-braking backup and filter configuration
    (``run_campaign_tpu.py:543-547``): thrust box [0, T_max] × [−T_max, T_max]²."""
    T = p.T_max
    return (EmergencyBrakingController(T_max=T, g_I=torch.tensor([-1.0, 0.0, 0.0], device=dev)),
            SafetyFilterConfig(N=N, dt=DT, u_min=(0.0, -T, -T), u_max=(T, T, T), device=dev))


def velocity_ellipsoid_filter(device: DeviceLike = "cuda"):
    """The altitude-blind velocity-ellipsoid filter of ``scripts/bench_safety_filter.py``
    and of the GP-MPC safety artifact (flown at ab18305, before the funnel):
    P = diag(0, 0, 0.3, 0.3, 1, 1, 1), x_eq with v_x = −1, α = 6, N = 5,
    emergency braking. Returns (invariant, backup, config)."""
    dev = resolve_device(device)
    P = torch.diag(torch.tensor([0.0, 0.0, 0.3, 0.3, 1.0, 1.0, 1.0], device=dev))
    x_eq = torch.tensor([0.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0], device=dev)
    inv = EllipsoidalInvariantSet(P=P, x_eq=x_eq, alpha=torch.tensor(6.0, device=dev))
    backup, cfg = _braking_filter(Rocket3DoFParams(device=dev), 5, dev)
    return inv, backup, cfg


class SafetyPath(NamedTuple):
    controller: tuple  # (cinit, cstep) of the unfiltered controller
    plant: Callable
    F_filter: Callable  # the filter's recoverability model
    invariant: object
    backup: object
    filter_config: object
    sim: SimulationConfig


def safety_rescue_path(device: DeviceLike = "cuda") -> SafetyPath:
    """``scripts/run_campaign_tpu.py --controller rti --safety-filter --gust
    -2.0 --steps 150``: the condensed RTI controller of ``:46-59`` (state
    bounds kept: n = 60, m = 200; 50 iterations in two chunks of 25, scaling
    3, accept 5e-3) tracking 100-step cubic references; the plant carries
    the downdraft (``:68-89``); the filter is the soft-landing funnel (slope
    0.6, v_free 1.5) over emergency braking, N = 5, on the nominal model
    padded with the same downdraft (``:548-558``)."""
    dev = resolve_device(device)
    p = Rocket3DoFParams(device=dev)
    base = RTIConfig(N=N, accept_pri_tol=5e-3, condensed=True,
                     admm=ADMMConfig(max_iter=ADMM_ITERS, polish=False, adaptive_rho=False,
                                     scaling=3, use_pallas="auto"),
                     device=dev)
    F = lambda x, u: r3.step(p, x, u, DT)
    pad = r3.Rocket3DoFDowndraftStep(p, DT, RESCUE_GUST)
    xT = torch.zeros(7, device=dev)
    xT[0] = 2.0
    ctrl = make_rti_controller(F, base, xT,
                               reference_fn=lambda x0: cubic_descent_reference(x0, xT, 100, DT),
                               ref_horizon=RESCUE_STEPS)
    backup, fcfg = _braking_filter(p, 5, dev)
    return SafetyPath(controller=ctrl, plant=pad, F_filter=pad,
                      invariant=DescentFunnelSet(slope=0.6, v_free=1.5), backup=backup,
                      filter_config=fcfg,
                      sim=SimulationConfig(max_steps=RESCUE_STEPS, altitude_mean=30.0,
                                           altitude_std=2.0))


def safety_gpmpc_path(mean_fn: Callable, var_fn: Callable,
                      device: DeviceLike = "cuda") -> SafetyPath:
    """``scripts/run_campaign_tpu.py --controller gp_mpc --safety-filter``
    without ``--rt`` (``:143-180``): two SCP iterations of the condensed
    GP-MPC (state bounds kept, 100 iterations in chunks of 25, scaling 3,
    accept 5e-3, chance tightening) with the campaign's GP
    (:func:`gpmpc_campaign_gp`), 130 steps on the drag + wind plant, and
    the filter the artifact flew at ab18305: :func:`velocity_ellipsoid_filter`
    on the nominal model."""
    dev = resolve_device(device)
    fp = online_flight_path("3dof", dev)
    cfg = GPMPCConfig(
        base=RTIConfig(N=N, accept_pri_tol=5e-3, condensed=True,
                       admm=ADMMConfig(max_iter=100, polish=False, adaptive_rho=False,
                                       scaling=3, use_pallas="auto"),
                       device=dev),
        scp_iterations=2, tighten=True)
    ctrl = make_gp_mpc_controller(fp.F, mean_fn, var_fn, cfg, fp.x_target,
                                  reference_fn=fp.reference_fn,
                                  ref_horizon=SAFETY_GPMPC_STEPS)
    inv, backup, fcfg = velocity_ellipsoid_filter(dev)
    return SafetyPath(controller=ctrl, plant=fp.F_true, F_filter=fp.F, invariant=inv,
                      backup=backup, filter_config=fcfg,
                      sim=SimulationConfig(max_steps=SAFETY_GPMPC_STEPS, altitude_mean=30.0,
                                           altitude_std=2.0))


def filtered_controller(sp: SafetyPath):
    """(finit, fstep) of the path's controller behind its filter, the early
    half ending at the episode's middle step (``run_campaign_tpu.py:560-563``)."""
    return make_filtered_controller(*sp.controller, sp.F_filter, sp.backup, sp.invariant,
                                    sp.filter_config, half_step=sp.sim.max_steps // 2)


def fly_safety(sp: SafetyPath, x0s: torch.Tensor) -> Dict:
    """The campaign with the filter and, on the same initial states, without
    it. Returns the script's summary (``run_campaign_tpu.py:703-740``) with
    both arms' statistics and the seconds of each."""
    t0 = time.time()
    res = run_campaign(*filtered_controller(sp), sp.plant, x0s, sp.sim,
                       cstate_info=filtered_controller_info)
    st = campaign_statistics(res)
    t1 = time.time()
    res_u = run_campaign(*sp.controller, sp.plant, x0s, sp.sim)
    st_u = campaign_statistics(res_u)
    t2 = time.time()
    n_int = res["n_interventions"].double().cpu()
    n_early = res["n_interventions_early"].double().cpu()
    f = lambda v: float(v)
    return {
        "lanes": x0s.shape[0], "steps": sp.sim.max_steps,
        "success_rate": f(st["success_rate"]),
        "landing_speed_mean": f(st["landing_speed_mean"]),
        "landing_error_mean": f(st["landing_error_mean"]),
        "fuel_used_mean": f(st["fuel_used_mean"]),
        "outcome_counts": {k: int(c) for k, c in st["outcome_counts"].items()},
        "intervention_rate": f((n_int > 0).double().mean()),
        "interventions_per_episode_mean": f(n_int.mean()),
        "interventions_first_half_mean": f(n_early.mean()),
        "interventions_second_half_mean": f((n_int - n_early).mean()),
        "success_rate_unfiltered": f(st_u["success_rate"]),
        "success_rate_delta": f(st["success_rate"]) - f(st_u["success_rate"]),
        "crash_count_filtered": int(st["outcome_counts"]["crash"]),
        "crash_count_unfiltered": int(st_u["outcome_counts"]["crash"]),
        "landing_speed_mean_unfiltered": f(st_u["landing_speed_mean"]),
        "seconds_filtered": t1 - t0, "seconds_unfiltered": t2 - t1,
    }


class OnlineSafetyPath(NamedTuple):
    inner: tuple  # (cinit, cstep) of the online GP-MPC controller
    controller: tuple  # (finit, fstep): the same behind the filter
    filter_model: Callable  # inner state -> the filter's lanes-first step function
    plant: Callable
    sim: SimulationConfig


def online_safety_path(device: DeviceLike = "cuda") -> OnlineSafetyPath:
    """``scripts/run_online_safety_tpu.py --filter-model gp --filter-n 8``
    (gust −1.5, v_free 1.5, 110 steps): the online GP-MPC controller
    (condensed, state bounds kept: n = 60, m = 200, 50 iterations in one
    chunk, scaling 2, one SCP iteration with the GP tape and the
    tightening; a GP per lane) tracking 65-step cubic references, on the
    drag + wind + downdraft plant, behind the funnel filter (N = 8) whose
    model is the nominal one plus the lane's own gated GP mean, the
    downdraft pad faded by the same variance gate (``:136-153``). The filter
    reads every lane's GP through one lanes-first step function a cycle."""
    dev = resolve_device(device)
    gust, steps = ONLINE_SAFETY_GUST, ONLINE_SAFETY_STEPS
    p = Rocket3DoFParams(device=dev)
    p_true = p.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    wind = torch.zeros(7, device=dev)
    wind[5], wind[6] = 0.4, 0.25
    F = lambda x, u: r3.step(p, x, u, DT)
    plant = lambda x, u: (r3.step(p_true, x, u, DT)
                          + DT * (wind + as_vertical(gust_accel(x, gust))))
    base = RTIConfig(N=N, dt=DT, accept_pri_tol=1e-2, condensed=True,
                     admm=ADMMConfig(max_iter=ADMM_ITERS, check_interval=ADMM_ITERS, scaling=2,
                                     polish=False, adaptive_rho=False, infeas_certs=False,
                                     use_pallas="auto"),
                     device=dev)
    ocfg = OnlineGPMPCConfig(mpc=GPMPCConfig(base=base, scp_iterations=1, tighten=True,
                                             rollout_gp_tape=True))
    xT = torch.zeros(7, device=dev)
    xT[0] = 2.0
    inner = make_online_gp_mpc_controller(
        F, ocfg, xT, lambda x0: cubic_descent_reference(x0, xT, 65, DT), steps, steps)

    def sf_from_inner(st):
        gp = st.gp
        prior_v = torch.exp(gp.gp.kernels.log_variance)[..., 0].clamp_min(1e-12)

        def sf(x, u):
            m, v = gp.predict_gated(x, u)
            w_vert = (1.0 - v[:, 0] / prior_v).clamp(0.0, 1.0)
            d = gp.lift_residual(m, 7) + as_vertical((1.0 - w_vert) * gust_accel(x, gust))
            return F(x, u) + DT * d

        return sf

    backup, fcfg = _braking_filter(p, ONLINE_SAFETY_FILTER_N, dev)
    pad = r3.Rocket3DoFDowndraftStep(p, DT, gust)
    ctrl = make_filtered_controller(*inner, pad, backup, DescentFunnelSet(0.6, 1.5), fcfg,
                                    step_fn_from_inner=sf_from_inner)
    return OnlineSafetyPath(inner=inner, controller=ctrl, filter_model=sf_from_inner, plant=plant,
                            sim=SimulationConfig(max_steps=steps, altitude_mean=15.0,
                                                 altitude_std=1.5))


def fly_online_safety(op: OnlineSafetyPath, x0s: torch.Tensor, episodes: int = 3) -> Dict:
    """Every lane flies ``episodes`` landings from the same initial state
    (``run_online_safety_tpu.py:166-230``), its GP carried between them by
    ``carry_gp_between_episodes`` and everything else reset; a landed lane
    is frozen but its controller keeps stepping. Returns the script's result
    (per episode: success, landed, the lanes whose state is not finite,
    interventions, touchdown speeds, model error, GP points; the McNemar z
    of each episode's success against the first; the gate ``:291-293``) and
    each episode's seconds."""
    finit, fstep = op.controller
    cinit = op.inner[0]
    steps = op.sim.max_steps
    per_ep, succ_lanes, secs = [], [], []
    fs = None
    for e in range(episodes):
        t0 = time.time()
        if fs is None:
            fs = finit(x0s)
        else:
            fs = (carry_gp_between_episodes(cinit, fs[0], x0s),) + tuple(
                torch.zeros_like(s) for s in fs[1:])
        x = x0s
        for k in range(steps):
            u, fs = fstep(fs, x, k)
            x_next = op.plant(x, u)
            x = torch.where((x[:, 1] <= 0.1)[:, None], x, x_next)
        landed = x[:, 1] <= 0.1
        speed = torch.linalg.vector_norm(x[:, 4:7], dim=1)
        success = landed & (speed <= 2.0)
        info = online_controller_info(fs[0])
        spd = speed[landed].double().cpu()
        ints = fs[1].double().cpu()
        per_ep.append({
            "episode": e + 1,
            "success_rate": float(success.float().mean()),
            "landed_rate": float(landed.float().mean()),
            # a lane that burned its fuel hovering or climbing (mass -> 0)
            "nonfinite_lanes": int((~torch.isfinite(x).all(-1)).sum()),
            "interventions_mean": float(ints.mean()),
            "intervention_rate": float((ints > 0).double().mean()),
            "touchdown_speed_mean": float(spd.mean()) if spd.numel() else float("nan"),
            "touchdown_speed_p95": float(spd.quantile(0.95)) if spd.numel() else float("nan"),
            # over every lane, as the script's nan-padded mean counts it
            "overspeed_rate": float((landed & (speed > 2.0)).float().mean()),
            "model_err_mean": float(info["err_hist"].double().nanmean(1).nanmean()),
            "gp_points_mean": float(info["gp_points"].float().mean()),
        })
        succ_lanes.append(success.cpu())
        secs.append(time.time() - t0)
    mcnemar = []
    for e in range(1, episodes):
        b = float((succ_lanes[0] & ~succ_lanes[e]).sum())  # degraded
        c = float((~succ_lanes[0] & succ_lanes[e]).sum())  # improved
        mcnemar.append((b - c) / max((b + c) ** 0.5, 1.0))
    ints = [r["interventions_mean"] for r in per_ep]
    out = {
        "batch": x0s.shape[0], "episodes": episodes, "steps": steps,
        "per_episode": per_ep, "interventions_by_episode": ints,
        "interventions_decrease": ints[-1] < ints[0],
        "model_err_by_episode": [r["model_err_mean"] for r in per_ep],
        "success_by_episode": [r["success_rate"] for r in per_ep],
        "success_mcnemar_z_vs_ep1": mcnemar,
        "success_non_decreasing_within_ci": all(z < 2.0 for z in mcnemar),
        "final_success_rate": per_ep[-1]["success_rate"],
        "seconds_by_episode": secs,
    }
    out["gate"] = (out["interventions_decrease"] and out["final_success_rate"] > 0.95
                   and out["success_non_decreasing_within_ci"])
    return out


# -- the experiment suite (scripts/run_experiments.py) -----------------------

SUITE_RUNS = {"quick": 64, "standard": 256, "full": 1024}
SUITE_DISPERSION_LANES = 64  # the dispersion sweep's lanes (:193)
SUITE_DISPERSION_LEVELS = ("low", "medium", "high")
SUITE_REF_STEPS = 96  # the 9.6 s cubic reference (:135)
SUITE_REF_HORIZON = 180
SUITE_SEED = 0  # --seed: the GP fit's generator takes SUITE_SEED + 42, the dispersion's + 1


class SuitePath(NamedTuple):
    params: Rocket3DoFParams  # the controllers' nominal model (config/rocket_params.yaml)
    F: Callable  # nominal step
    plant: Callable  # drag + steady wind + the low-altitude downdraft
    sim: SimulationConfig
    x_target: torch.Tensor
    reference_fn: Callable
    gp_config: GPMPCConfig
    rti_config: RTIConfig
    baselines: Optional[tuple]  # None: all four
    n_runs: int
    dispersion: bool
    pretrain: Dict  # pretrain_gp_3dof's episode counts


def suite_downdraft(x: torch.Tensor) -> torch.Tensor:
    """The unmodelled sink below ~6 m (``run_experiments.py:110-111``): (B,)
    from states (B, 7)."""
    return -2.0 * torch.sigmoid((6.0 - x[:, 1]) / 1.0)


def experiment_suite_path(n_runs: Optional[int] = None, preset: str = "standard",
                          device: DeviceLike = "cuda", max_steps: int = 200, n_episodes: int = 6,
                          episode_len: int = 120, tune_steps: int = 150) -> SuitePath:
    """``scripts/run_experiments.py --<preset> --seed 0``, its set-up
    step by step: the configuration from ``config/`` through the port's
    ``load_experiment_config`` (``:81-83``); the campaign scenario of
    ``:86-91`` (``max_steps`` steps, 30 ± 2 m, −3 m/s); the plant of
    ``:101-117`` (drag, a steady wind, the −2.0 m/s sigmoid downdraft below
    6 m) the nominal model does not know; the GP fit's size (``:127-130``,
    6 episodes of 120 steps); the 9.6 s cubic reference (``:135``); the
    GP-MPC configuration of ``:141-148`` (condensed, 100 fixed-ρ iterations,
    scaling 3, 2 SCP iterations, tightened); the RTI ablation on the YAML's
    ``RTIConfig`` (N = 15, sparse form, 100 iterations, polish); the
    baselines (``:155-157``: two at --quick, all four otherwise) and the
    dispersion sweep (--standard and --full). ``n_runs`` defaults to the
    preset's; ``max_steps`` and the GP fit's sizes are cut only by the CPU
    tests."""
    from .utils import load_experiment_config

    dev = resolve_device(device)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_experiment_config(os.path.join(root, "config"), device=dev)
    params = cfg["rocket_params"]
    rti_cfg = cfg["mpc_config"] if isinstance(cfg["mpc_config"], RTIConfig) else RTIConfig(
        device=dev)
    sim = SimulationConfig(max_steps=max_steps, dt=rti_cfg.dt, altitude_mean=30.0,
                           altitude_std=2.0, vertical_velocity_mean=-3.0,
                           m_dry=float(params.m_dry))
    dt = sim.dt
    xT = torch.zeros(7, device=dev)
    xT[0] = float(params.m_wet)
    p_true = params.replace(rho=1.0, C_D=1.0, A_ref=0.1)
    # the steady wind, held in both precisions (0.4 is not a float32 number)
    wind = {}
    for dtype in (torch.float32, torch.float64):
        wind[dtype] = torch.zeros(7, dtype=dtype, device=dev)
        wind[dtype][5], wind[dtype][6] = 0.4, 0.25

    def plant(x, u):
        return r3.step(p_true, x, u, dt) + dt * (wind[x.dtype] + as_vertical(suite_downdraft(x)))

    gp_cfg = GPMPCConfig(
        base=rti_cfg.replace(accept_pri_tol=5e-3, condensed=True,
                             admm=ADMMConfig(max_iter=100, polish=False, adaptive_rho=False,
                                             scaling=3)),
        scp_iterations=2, tighten=True)
    return SuitePath(
        params=params, F=lambda x, u: r3.step(params, x, u, dt), plant=plant, sim=sim,
        x_target=xT,
        reference_fn=lambda x0: cubic_descent_reference(x0, xT, SUITE_REF_STEPS, dt),
        gp_config=gp_cfg, rti_config=rti_cfg,
        baselines=("gravity_turn", "pid") if preset == "quick" else None,
        n_runs=n_runs or SUITE_RUNS.get(preset, 64), dispersion=preset in ("standard", "full"),
        pretrain=dict(n_episodes=n_episodes, episode_len=episode_len, tune_steps=tune_steps))


def experiments_x0(n_runs: int = 256, device: DeviceLike = "cuda") -> torch.Tensor:
    """The suite's initial states as the script draws them (``--seed 0``,
    ``tests/fixtures/experiments_x0.npz``), the first ``n_runs``."""
    import numpy as np

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    x0 = np.load(os.path.join(root, "tests", "fixtures", "experiments_x0.npz"))["x0"]
    return torch.as_tensor(x0[:n_runs]).to(resolve_device(device))


def suite_controllers(sp: SuitePath, mean_fn: Callable, var_fn: Callable) -> Dict:
    """Name → (cinit, cstep) of the suite's arms (``:150-158``): GP-MPC, the
    RTI ablation, the baselines."""
    from .experiments import create_baseline_controllers

    ctrls = {
        "gp_mpc": make_gp_mpc_controller(sp.F, mean_fn, var_fn, sp.gp_config, sp.x_target,
                                         reference_fn=sp.reference_fn,
                                         ref_horizon=SUITE_REF_HORIZON),
        "rti_mpc": make_rti_controller(sp.F, sp.rti_config, sp.x_target,
                                       reference_fn=sp.reference_fn,
                                       ref_horizon=SUITE_REF_HORIZON),
    }
    ctrls.update(create_baseline_controllers(sp.params, sp.x_target, sp.sim.dt,
                                             include=sp.baselines))
    return ctrls


def fly_experiments(sp: SuitePath, x0s: torch.Tensor, generator: torch.Generator,
                    out_dir: str) -> Dict:
    """``scripts/run_experiments.py`` from its GP fit to its verdict: fit the
    GP on the plant (``pretrain_gp_3dof``, its draws from ``generator``, the
    script's seed + 42), fly every arm through ``run_campaign`` on ``x0s``,
    sweep the dispersion levels for both MPC arms on the first 64 lanes
    (each level's draws from a generator seeded SUITE_SEED + 1 on
    ``generator``'s device, the same for both arms), write the exports
    (CSV, JSON, LaTeX, prose; ``:206-214``), the summary figure
    (``:217-223``: where matplotlib imports, inside the script's own
    guard), the z-test and its JSON (``:234-249``)
    and the JSONL run log. Returns the metrics, per-arm results and
    statistics, the z-test, each stage's wall seconds, the files written and
    the script's verdict (GP-MPC ≥ 0.9 and GP-MPC ≥ RTI, ``:251-252``)."""
    import importlib.util
    import json as _json

    from .experiments import (DispersionConfig, PerformanceMetrics, ResultsExporter,
                              create_summary_figure, make_dispersed_plant,
                              two_proportion_z_test)
    from .utils import RunLogger

    os.makedirs(out_dir, exist_ok=True)
    log = RunLogger(os.path.join(out_dir, "run.jsonl"))
    dev = x0s.device
    log.log("start", n_runs=x0s.shape[0], devices=[str(dev)])
    seconds: Dict[str, float] = {}
    t0 = time.time()
    gp, mean_fn, var_fn = pretrain_gp_3dof(generator, sp.params, sp.plant, dt=sp.sim.dt,
                                           device=dev, **sp.pretrain)
    seconds["pretrain"] = time.time() - t0
    log.log("pretrain", wall_s=round(seconds["pretrain"], 2))

    controllers = suite_controllers(sp, mean_fn, var_fn)
    metrics, results, stats = [], {}, {}
    for name, (cinit, cstep) in controllers.items():
        t0 = time.time()
        res = run_campaign(cinit, cstep, sp.plant, x0s, sp.sim)
        stats[name] = campaign_statistics(res)
        m = PerformanceMetrics.from_results(name, res)
        seconds[name] = time.time() - t0
        metrics.append(m)
        results[name] = res
        log.log("campaign", controller=name, success_rate=m.success_rate,
                wall_s=round(seconds[name], 2))

    dispersion = {}
    if sp.dispersion:
        xd = x0s[:min(SUITE_DISPERSION_LANES, x0s.shape[0])]
        for level in SUITE_DISPERSION_LEVELS:
            dcfg = DispersionConfig.preset(level)
            for name in ("gp_mpc", "rti_mpc"):
                t0 = time.time()
                g = torch.Generator(device=generator.device).manual_seed(SUITE_SEED + 1)
                cinit, cstep = controllers[name]
                res = run_campaign(cinit, cstep, make_dispersed_plant(sp.plant, dcfg, g,
                                                                      sp.sim.dt), xd, sp.sim)
                m = PerformanceMetrics.from_results(f"{name}_disp_{level}", res)
                key = f"{name}_disp_{level}"
                seconds[key] = time.time() - t0
                metrics.append(m)
                dispersion[key] = res
                log.log("dispersion", controller=name, level=level,
                        success_rate=m.success_rate)

    exp = ResultsExporter()
    files = {}
    for fname, text in (("metrics.csv", exp.to_csv(metrics)), ("metrics.json", exp.to_json(metrics)),
                        ("metrics.tex", exp.to_latex(metrics)),
                        ("report.txt", exp.to_prose(metrics))):
        files[fname] = os.path.join(out_dir, fname)
        with open(files[fname], "w") as f:
            f.write(text)
    figure = importlib.util.find_spec("matplotlib") is not None
    if figure:
        try:
            create_summary_figure(results["gp_mpc"], path=os.path.join(out_dir, "summary.png"))
            files["summary.png"] = os.path.join(out_dir, "summary.png")
        except Exception as e:  # plotting must never fail the campaign
            log.log("figure_error", error=str(e))
    log.log("done", out_dir=out_dir)

    gp_m = next(m for m in metrics if m.name == "gp_mpc")
    rti_m = next(m for m in metrics if m.name == "rti_mpc")
    z = two_proportion_z_test(gp_m.successes, gp_m.n_runs, rti_m.successes, rti_m.n_runs)
    comparison = {
        "gp_mpc_success": gp_m.success_rate,
        "rti_mpc_success": rti_m.success_rate,
        "z": round(float(z["z"]), 3),
        "p_value": round(float(z["p_value"]), 6),
        "significant_05": bool(z["significant_05"]),
    }
    files["gp_vs_rti_z_test.json"] = os.path.join(out_dir, "gp_vs_rti_z_test.json")
    with open(files["gp_vs_rti_z_test.json"], "w") as f:
        _json.dump(comparison, f, indent=1)
    log.log("z_test", **comparison)
    log.close()
    files["run.jsonl"] = os.path.join(out_dir, "run.jsonl")
    return {
        "metrics": metrics, "results": results, "dispersion": dispersion, "stats": stats,
        "z_test": comparison, "seconds": seconds, "files": files, "figure": figure,
        "gp": gp, "gp_fns": (mean_fn, var_fn), "controllers": controllers,
        "passed": gp_m.success_rate >= 0.9 and gp_m.success_rate >= rti_m.success_rate,
    }


# -- the SCVX trajectory library ---------------------------------------------

SCVX_N = 40
SCVX_LIBRARY_STATES = 64
SCVX_LIBRARY_DTS = (0.15, 0.35, 11)  # t_f from 6 to 14 s, bracketing the suite's 9.6 s
SCVX_ORACLE_DTS = (0.125, 0.25, 11)  # tests/test_experiments.py:295, t_f from 5 to 10 s
SCVX_ORACLE_X0 = (2.0, 25.0, 1.0, -0.5, -3.0, 0.0, 0.0)


class SCVXLibraryPath(NamedTuple):
    params: Rocket3DoFParams
    step_dt: Callable  # step_dt(x, u, dt) → x⁺
    config: object  # SCVXConfig
    x_target: torch.Tensor
    dt_candidates: torch.Tensor  # the library's sweep
    oracle_dts: torch.Tensor  # the oracle case's sweep


def scvx_library_path(device: DeviceLike = "cuda") -> SCVXLibraryPath:
    """The SCVX free-time sweep of ``tests/test_experiments.py:273-306`` at
    ``SCVXConfig(N=40)`` on the default 3-DoF model, landing at m = 2 at
    the origin; the library sweeps dt ∈ linspace(0.15, 0.35, 11)."""
    from .reference import SCVXConfig

    dev = resolve_device(device)
    p = Rocket3DoFParams(device=dev)
    xT = torch.zeros(7, device=dev)
    xT[0] = 2.0
    return SCVXLibraryPath(params=p, step_dt=lambda x, u, dt: r3.step(p, x, u, dt),
                           config=SCVXConfig(N=SCVX_N, device=dev), x_target=xT,
                           dt_candidates=torch.linspace(*SCVX_LIBRARY_DTS[:2],
                                                        SCVX_LIBRARY_DTS[2], device=dev),
                           oracle_dts=torch.linspace(*SCVX_ORACLE_DTS[:2], SCVX_ORACLE_DTS[2],
                                                     device=dev))


def fly_scvx_library(lp: SCVXLibraryPath, x0s: torch.Tensor, queries: torch.Tensor) -> Dict:
    """``generate_trajectory_library`` over ``x0s``: every state's
    ``scvx_free_time`` sweep over ``lp.dt_candidates``, all of them lanes of
    one batch (states × candidates); each trajectory stamped with its own
    chosen dt, its fuel as its cost. Then ``nearest`` and
    ``best_within_radius`` (radius 2, by fuel) for every state of
    ``queries``. Returns the library, the chosen solutions, the converged
    share, the largest defect, the chosen-duration histogram, the query
    answers and the seconds."""
    from .reference import generate_trajectory_library, scvx_free_time

    chosen = {}

    def solver(xs):
        sol = scvx_free_time(lp.step_dt, lp.config, xs, lp.x_target, lp.dt_candidates)
        chosen["sol"] = sol
        return sol.X, sol.U, sol.fuel_used, sol.fuel_used

    t0 = time.time()
    lib = generate_trajectory_library(solver, x0s)
    sol = chosen["sol"]
    T1 = sol.X.shape[1]
    lib = lib.replace(times=torch.arange(T1, device=x0s.device) * sol.dt[:, None])
    seconds = time.time() - t0
    out = {"library": lib, "solution": sol, "seconds": seconds,
           "converged_share": float(sol.converged.float().mean()),
           "max_defect": float(sol.defect.max()),
           "duration_histogram": {round(float(d) * lp.config.N, 3): int((
               (sol.dt - d).abs() < 1e-6).sum()) for d in lp.dt_candidates}}
    out["nearest"] = lib.nearest(queries)
    out["best_within_radius"] = lib.best_within_radius(queries, 2.0, by="fuel")
    return out


def scvx_oracle_case(lp: SCVXLibraryPath):
    """The oracle case of ``tests/test_experiments.py:273-306``: one initial
    state, dt over ``lp.oracle_dts``; returns the chosen solution."""
    from .reference import scvx_free_time

    x0 = torch.tensor(SCVX_ORACLE_X0, device=lp.x_target.device)
    return scvx_free_time(lp.step_dt, lp.config, x0, lp.x_target, lp.oracle_dts)
