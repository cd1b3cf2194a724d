"""Monte-Carlo landing campaigns (counterpart of
``gpmpc_tpu/experiments/monte_carlo.py``): outcome codes, landing criteria,
the campaign scenario, the Gaussian initial-condition sampler, the touchdown
classifier, the episode loop with its outcome state machine, the campaign
and its statistics, and the Wilson score interval.

The fleet is the batch axis: :func:`run_episode` flies every lane in
lockstep, and a lane whose outcome is decided is frozen (its state, its
controller state and its plant state stop changing). ``summarize`` prints a
campaign's statistics and ``compare_controllers`` flies several
controllers on shared initial states.

Spans (``utils.profiler.span``) of :func:`run_episode`: ``campaign.step``
(one whole step) with ``campaign.exit_check`` (the host read that ends the
loop early), ``campaign.plant`` and ``campaign.outcome`` inside it; the
controller's own spans nest there too.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..utils.profiler import span

Tensor = torch.Tensor

# outcome codes of a lane
RUNNING = -1
SUCCESS = 0
CRASH = 1
FUEL_EXHAUSTED = 2
CONSTRAINT_VIOLATION = 3
TIMEOUT = 4
DIVERGENCE = 5

OUTCOME_NAMES = {
    SUCCESS: "success",
    CRASH: "crash",
    FUEL_EXHAUSTED: "fuel_exhausted",
    CONSTRAINT_VIOLATION: "constraint_violation",
    TIMEOUT: "timeout",
    DIVERGENCE: "divergence",
}


@dataclass(frozen=True)
class LandingCriteria:
    """Success thresholds at touchdown."""

    landing_altitude: float = 0.1
    max_landing_speed: float = 2.0
    max_position_error: float = 1.0
    max_tilt: float = math.radians(20.0)  # used for 14-state only
    max_angular_rate: float = math.radians(10.0)


@dataclass(frozen=True)
class SimulationConfig:
    """Campaign scenario parameters; field names and defaults are those of
    the JAX ``SimulationConfig``."""

    dt: float = 0.1
    max_steps: int = 200
    # initial condition distribution (gravity along −x ⇒ x[1] is altitude)
    mass_mean: float = 2.0
    mass_std: float = 0.05
    altitude_mean: float = 30.0
    altitude_std: float = 2.0
    horizontal_std: float = 1.0
    vertical_velocity_mean: float = -3.0
    vertical_velocity_std: float = 0.3
    horizontal_velocity_std: float = 0.2
    m_dry: float = 1.0
    divergence_bound: float = 1e4


def sample_initial_conditions(generator: torch.Generator, config: SimulationConfig, n: int,
                              n_x: int = 7, device: DeviceLike = None) -> Tensor:
    """Gaussian initial states (n, n_x) with physical clipping: mass at least
    m_dry + 0.1, altitude at least 1. For n_x = 14 the attitude starts at
    identity with zero rates. The numbers are drawn from ``generator`` on its
    device, in the order mass, altitude, horizontal offsets, vertical
    velocity, horizontal velocities, and returned on ``device`` (default: the
    generator's)."""
    gdev = generator.device
    dev = gdev if device is None else resolve_device(device)
    randn = lambda *shape: torch.randn(*shape, generator=generator, device=gdev)
    m = (config.mass_mean + config.mass_std * randn(n)).clamp_min(config.m_dry + 0.1)
    alt = (config.altitude_mean + config.altitude_std * randn(n)).clamp_min(1.0)
    horiz = config.horizontal_std * randn(n, 2)
    v_vert = config.vertical_velocity_mean + config.vertical_velocity_std * randn(n)
    v_horiz = config.horizontal_velocity_std * randn(n, 2)
    parts = [m[:, None], alt[:, None], horiz, v_vert[:, None], v_horiz]
    if n_x != 7:
        quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=gdev).expand(n, 4)
        parts += [quat, torch.zeros(n, 3, device=gdev)]
    return torch.cat(parts, dim=1).to(dev)


def classify_touchdown(x: Tensor, criteria: LandingCriteria) -> Tensor:
    """SUCCESS or CRASH (int64 codes) for states (…, n_x) at the moment the
    altitude crosses the landing threshold."""
    speed = torch.linalg.vector_norm(x[..., 4:7], dim=-1)
    pos_err = torch.linalg.vector_norm(x[..., 2:4], dim=-1)
    ok = (speed <= criteria.max_landing_speed) & (pos_err <= criteria.max_position_error)
    if x.shape[-1] >= 14:
        cos_t = 1.0 - 2.0 * (x[..., 9] ** 2 + x[..., 10] ** 2)
        tilt = torch.arccos(cos_t.clamp(-1.0, 1.0))
        w = torch.linalg.vector_norm(x[..., 11:14], dim=-1)
        ok = ok & (tilt <= criteria.max_tilt) & (w <= criteria.max_angular_rate)
    return torch.where(ok, SUCCESS, CRASH)


def wilson_interval(successes, n, z: float = 1.96) -> Tuple[Tensor, Tensor]:
    """Wilson score interval (lower, upper) of a binomial proportion; tensors
    or numbers, broadcast together."""
    successes = torch.as_tensor(successes, dtype=torch.float32)
    n = torch.as_tensor(n, dtype=torch.float32, device=successes.device).clamp_min(1.0)
    # the constants as f32 tensors: torch evaluates number / tensor as a
    # reciprocal times the number, which rounds differently from a division
    z_, z2 = (torch.tensor(v, dtype=torch.float32, device=n.device) for v in (z, z**2))
    p = successes / n
    denom = 1.0 + z2 / n
    center = (p + z2 / (2 * n)) / denom
    half = (z_ / denom) * torch.sqrt(p * (1 - p) / n + z2 / (4 * n**2))
    return (center - half).clamp(0.0, 1.0), (center + half).clamp(0.0, 1.0)


def _keep_running(running: Tensor, new, old):
    """``new`` where a lane runs and ``old`` where it stopped, through
    tensors with a leading lane axis, tuples, lists and dataclasses."""
    if isinstance(new, Tensor):
        return torch.where(running.reshape(-1, *([1] * (new.dim() - 1))), new, old)
    if dataclasses.is_dataclass(new) and not isinstance(new, type):
        return dataclasses.replace(new, **{
            f.name: _keep_running(running, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new) if f.init})
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_keep_running(running, a, b) for a, b in zip(new, old)))
    if isinstance(new, (tuple, list)):
        return type(new)(_keep_running(running, a, b) for a, b in zip(new, old))
    return new


def run_episode(
    controller_init: Callable[[Tensor], object],
    controller_step: Callable[[object, Tensor, int], Tuple[Tensor, object]],
    plant_step,
    x0s: Tensor,
    sim: SimulationConfig,
    criteria: LandingCriteria,
    cstate_info: Optional[Callable[[object], Dict]] = None,
    store_trajectories: bool = True,
) -> Dict:
    """Fly every lane of ``x0s`` (B, n_x) for up to ``sim.max_steps`` steps
    in lockstep, with the outcome state machine in the reference's priority
    order: divergence (a non-finite state or one beyond
    ``sim.divergence_bound``), touchdown (altitude at or below the landing
    altitude, judged by :func:`classify_touchdown`), fuel out (mass at or
    below ``sim.m_dry``). A lane still running at the end is a TIMEOUT.

    - ``controller_init(x0s) → cstate`` and ``controller_step(cstate, x (B,
      n_x), k) → (u (B, n_u), cstate)``, k the step index (a Python int).
    - ``plant_step`` is ``f(x, u) → x⁺`` or a stateful pair ``(plant_init(x0s)
      → pstate, pstep(pstate, x, u) → (x⁺, pstate))``.
    - ``cstate_info`` maps the final controller state to extra per-lane
      result entries.

    Returns per-lane ``outcome``, ``x_final``, ``steps``, ``fuel_used``,
    ``landing_speed``, ``landing_error`` and, with ``store_trajectories``,
    ``X`` (B, max_steps+1, n_x) and ``U`` (B, max_steps, n_u). Without them the
    loop ends as soon as no lane runs (a stopped lane never changes)."""
    if isinstance(plant_step, tuple):
        plant_init, pstep = plant_step
    else:
        plant_init = lambda x0s: ()
        pstep = lambda ps, x, u: (plant_step(x, u), ps)
    dev = x0s.device
    x = x0s
    cstate = controller_init(x0s)
    pstate = plant_init(x0s)
    outcome = torch.full((x0s.shape[0],), RUNNING, dtype=torch.int64, device=dev)
    steps = torch.zeros(x0s.shape[0], dtype=torch.int32, device=dev)
    Xs, Us = [x0s], []
    for k in range(sim.max_steps):
        with span("campaign.step"):
            running = outcome == RUNNING
            if not store_trajectories:
                with span("campaign.exit_check"):
                    any_running = bool(running.any())
                if not any_running:
                    break
            u, cstate_new = controller_step(cstate, x, k)
            with span("campaign.plant"):
                x_next, pstate_new = pstep(pstate, x, u)
            with span("campaign.outcome"):
                diverged = ~torch.isfinite(x_next).all(dim=-1) | (
                    x_next.abs().amax(dim=-1) > sim.divergence_bound)
                new_outcome = torch.where(
                    diverged, DIVERGENCE,
                    torch.where(x_next[:, 1] <= criteria.landing_altitude,
                                classify_touchdown(x_next, criteria),
                                torch.where(x_next[:, 0] <= sim.m_dry, FUEL_EXHAUSTED,
                                            RUNNING)))
                outcome = torch.where(running, new_outcome, outcome)
                x = torch.where(running[:, None], x_next, x)
                cstate = _keep_running(running, cstate_new, cstate)
                pstate = _keep_running(running, pstate_new, pstate)
                steps = steps + running.to(torch.int32)
            if store_trajectories:
                Xs.append(x)
                Us.append(u)
    outcome = torch.where(outcome == RUNNING, TIMEOUT, outcome)
    out = {
        "outcome": outcome,
        "x_final": x,
        "steps": steps,
        "fuel_used": x0s[:, 0] - x[:, 0],
        "landing_speed": torch.linalg.vector_norm(x[:, 4:7], dim=-1),
        "landing_error": torch.linalg.vector_norm(x[:, 2:4], dim=-1),
    }
    if store_trajectories:
        out["X"] = torch.stack(Xs, dim=1)
        out["U"] = torch.stack(Us, dim=1)
    if cstate_info is not None:
        out.update(cstate_info(cstate))
    return out


def run_campaign(controller_init, controller_step, plant_step, x0s: Tensor,
                 sim: SimulationConfig, criteria: Optional[LandingCriteria] = None,
                 store_trajectories: bool = False,
                 cstate_info: Optional[Callable[[object], Dict]] = None) -> Dict:
    """The campaign over the scenarios ``x0s`` (B, n_x): :func:`run_episode`
    with the default criteria and without trajectories unless asked."""
    return run_episode(controller_init, controller_step, plant_step, x0s, sim,
                       criteria or LandingCriteria(), cstate_info=cstate_info,
                       store_trajectories=store_trajectories)


def campaign_statistics(results: Dict) -> Dict:
    """Aggregate a campaign's result: the success rate and its Wilson
    interval, the outcome counts, and over the successful lanes the mean
    fuel used (and its spread), touchdown speed, touchdown error and
    episode steps. Values are 0-dim tensors on the results' device."""
    outcome = results["outcome"]
    n = outcome.shape[0]
    ok = outcome == SUCCESS
    succ = ok.sum()
    lo, hi = wilson_interval(succ.to(torch.float32), float(n))
    okf = ok.to(torch.float32)
    denom = okf.sum().clamp_min(1.0)

    def succ_mean(v):
        return (v * okf).sum() / denom

    def succ_std(v):
        mu = succ_mean(v)
        return torch.sqrt(((okf * (v - mu) ** 2).sum() / denom).clamp_min(0.0))

    return {
        "n_runs": n,
        "success_rate": succ / n,
        "success_ci": (lo, hi),
        "outcome_counts": {name: (outcome == code).sum() for code, name in OUTCOME_NAMES.items()},
        "fuel_used_mean": succ_mean(results["fuel_used"]),
        "fuel_used_std": succ_std(results["fuel_used"]),
        "landing_speed_mean": succ_mean(results["landing_speed"]),
        "landing_error_mean": succ_mean(results["landing_error"]),
        "steps_mean": succ_mean(results["steps"].to(torch.float32)),
    }


def summarize(stats: Dict) -> str:
    """Human-readable campaign report of :func:`campaign_statistics`."""
    num = lambda v: v.item() if isinstance(v, Tensor) else v
    s = {k: num(v) for k, v in stats.items() if k not in ("success_ci", "outcome_counts")}
    lo, hi = (float(num(v)) for v in stats["success_ci"])
    lines = [
        "Monte-Carlo campaign summary",
        "============================",
        f"runs:          {int(s['n_runs'])}",
        f"success rate:  {float(s['success_rate']):.3f}"
        f"  (95% CI [{lo:.3f}, {hi:.3f}])",
    ]
    for name, cnt in stats["outcome_counts"].items():
        lines.append(f"  {name:22s} {int(num(cnt))}")
    lines += [
        f"fuel used (success): {float(s['fuel_used_mean']):.3f} ± {float(s['fuel_used_std']):.3f}",
        f"landing speed:       {float(s['landing_speed_mean']):.3f}",
        f"landing error:       {float(s['landing_error_mean']):.3f}",
        f"episode steps:       {float(s['steps_mean']):.1f}",
    ]
    return "\n".join(lines)


def compare_controllers(controllers: Dict[str, Tuple], plant_step, x0s: Tensor,
                        sim: SimulationConfig, criteria: Optional[LandingCriteria] = None
                        ) -> Dict[str, Dict]:
    """Fly several controllers on shared initial states: ``controllers`` maps
    a name to (controller_init, controller_step); returns each one's
    :func:`campaign_statistics`."""
    return {name: campaign_statistics(run_campaign(cinit, cstep, plant_step, x0s, sim,
                                                   criteria))
            for name, (cinit, cstep) in controllers.items()}
