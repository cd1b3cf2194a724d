"""Predictive safety filter with a backup controller, lanes first
(counterpart of ``gpmpc_tpu/safety/safety_filter.py``).

The safety check steps the candidate u once, then N−1 backup steps, and
tests the terminal value V(x_N) ≤ α (plus optional immediate constraints).
Where a lane is unsafe the minimal-intervention QP

    min ‖u − u_nom‖² + w·s²   s.t.  V0 + gᵀ(u − u_lin) ≤ α·margin + s,
                                    u_min ≤ u ≤ u_max,  s ≥ 0

linearizes V(x_N(u)) and is solved on the ADMM solver in a fixed small SCP
loop. V and ∂V/∂u of every lane come from one launch of the backup-value
kernel where the state lies on a card and
``ops/kernels/backup_value.py::fused`` admits the model, backup and set (the
rescue campaign's filter), else from one ``torch.autograd.grad`` of the
summed V (lanes do not couple). The lane axis is the batch axis of one
``ops.qp.solve`` call per SCP iteration: the QP is solved for every lane
every cycle and ``where(safe, …)`` picks the result, as the JAX package's
``vmap`` does. There is no branch on the data and no host read besides the
solver's own (none on the default schedule, whose every chunk adapts ρ).

``step_fn(x, u) → x⁺`` and the backup's ``control`` take (B, n_x), (B, n_u)
and must be differentiable by autograd; ``invariant.value`` maps (B, n_x) to
(B,). The span ``safety.filter`` encloses one :func:`filter_control` call,
and ``safety.check``, ``safety.grad``, ``safety.qp`` and ``safety.select``
name its stages in a profiler trace; inside them each evaluation of V and
∂V/∂u is a span ``safety.value.kernel`` or ``safety.value.autograd``, by the
route that ran. Inside ``utils.profiler.solve_record`` each SCP iteration
records its V, ∂V/∂u, linearization point, QP solution, QP status and ADMM
settings under ``"filter"``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import torch

from .._device import DeviceLike, resolve_device
from ..ops.kernels import backup_value
from ..ops.kernels.backup_value import backup_value_grad_plain as _value_and_grad
from ..ops.qp import SOLVED, ADMMConfig, QPData
from ..ops.qp import solve as qp_solve
from ..utils.profiler import open_solve_record, span

Tensor = torch.Tensor

_BIG = 1e20  # the QP's infinite bound


@dataclass(frozen=True)
class SafetyFilterConfig:
    """Field names and defaults are those of the JAX ``SafetyFilterConfig``.
    The control box lives on ``device``.

    Recovery policy: after ``max_consecutive`` interventions in a row,
    ``after_max="switch_to_backup"`` hands the lane to the backup for the
    rest of the episode (sticky, masked); ``"continue"`` filters forever."""

    N: int = 10
    dt: float = 0.1
    alpha_margin: float = 0.9  # V(x_N) ≤ α·margin in the intervention QP
    scp_iterations: int = 2
    soft: bool = True
    slack_weight: float = 1e4
    u_min: Optional[Tensor] = None  # default [0.3, −5, −5]
    u_max: Optional[Tensor] = None  # default [5, 5, 5]
    max_consecutive: int = 10
    after_max: str = "continue"
    device: DeviceLike = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        for name, default in (("u_min", (0.3, -5.0, -5.0)), ("u_max", (5.0, 5.0, 5.0))):
            v = getattr(self, name)
            object.__setattr__(self, name, torch.as_tensor(
                default if v is None else v, dtype=torch.float32).to(dev))

    def replace(self, **kw) -> "SafetyFilterConfig":
        return replace(self, **kw)


class SafetyFilterResult(NamedTuple):
    u: Tensor  # (B, n_u)
    intervened: Tensor  # (B,) bool
    safe: Tensor  # (B,) bool
    lyapunov_value: Tensor  # (B,) V(x_N) under the nominal control
    qp_success: Tensor  # (B,) bool: the last SCP iteration's QP solved


def _value_grad(step_fn, backup, invariant, N: int, x: Tensor, u: Tensor):
    """(V(x_N(u)) (B,), ∂V/∂u (B, n_u)) of every lane: one launch of the
    backup-value kernel where the state lies on a card and the kernel's seam
    admits the step, backup and set (span ``safety.value.kernel``), else the
    autograd route (span ``safety.value.autograd``)."""
    if x.is_cuda and backup_value.fused(step_fn, backup, invariant, x):
        with span("safety.value.kernel"):
            return backup_value.backup_value_grad(step_fn, backup, invariant, N,
                                                  x.contiguous(), u.contiguous())
    with span("safety.value.autograd"):
        return _value_and_grad(step_fn, backup, invariant, N, x, u)


def check_safety(step_fn: Callable, backup, invariant, config: SafetyFilterConfig, x: Tensor,
                 u: Tensor, constraint_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None):
    """(is_safe (B,), V(x_N) (B,)): the terminal test, and where
    ``constraint_fn(x, u) → (B, k)`` is given every constraint ≤ 0."""
    V, _ = _value_grad(step_fn, backup, invariant, config.N, x, u)
    safe = V <= invariant.alpha
    if constraint_fn is not None:
        safe = safe & (constraint_fn(x, u) <= 0.0).all(-1)
    return safe, V


def _target(config: SafetyFilterConfig, invariant):
    """α·margin, multiplied in f32 as the JAX package does (on the host
    where α is a number, so no tensor is copied to the device)."""
    alpha = invariant.alpha
    if isinstance(alpha, Tensor):
        return alpha * config.alpha_margin
    return (torch.tensor(config.alpha_margin) * torch.tensor(float(alpha))).item()


def _intervention_qp(config: SafetyFilterConfig, u_nominal: Tensor, u_lin: Tensor, V0: Tensor,
                     g: Tensor, target) -> QPData:
    """The linearized minimal-intervention QP of every lane, decision
    z = [u, s]: rows [gᵀ, −1] (V's linearization), s ≥ 0, then the box of
    z (slack row unbounded above in soft mode, pinned to 0 in hard mode)."""
    Bsz, n_u = u_nominal.shape
    nz = n_u + 1
    dev, dt = u_nominal.device, u_nominal.dtype
    eye = torch.eye(nz, dtype=dt, device=dev)
    P = eye.clone()
    P[n_u, n_u] = config.slack_weight
    e_s = eye[n_u]
    A = torch.cat([torch.cat([g, -torch.ones(Bsz, 1, dtype=dt, device=dev)], dim=1)[:, None],
                   e_s.expand(Bsz, 1, nz), eye.expand(Bsz, nz, nz)], dim=1)
    slack_hi = _BIG if config.soft else 0.0
    col = lambda v: torch.full((Bsz, 1), v, dtype=dt, device=dev)
    lo = torch.cat([col(-_BIG), col(0.0), config.u_min.expand(Bsz, n_u), col(0.0)], dim=1)
    hi = torch.cat([(target - V0 + (g * u_lin).sum(-1))[:, None], col(slack_hi),
                    config.u_max.expand(Bsz, n_u), col(slack_hi)], dim=1)
    q = torch.cat([-u_nominal, col(0.0)], dim=1)
    return QPData(P=P.expand(Bsz, nz, nz), q=q, A=A, l=lo, u=hi)


def filter_control(step_fn: Callable, backup, invariant, config: SafetyFilterConfig, x: Tensor,
                   u_nominal: Tensor, admm: Optional[ADMMConfig] = None) -> SafetyFilterResult:
    """Pass u_nominal (B, n_u) through where a lane is safe, else the
    minimal-intervention QP's control, re-linearized ``scp_iterations``
    times; where the last QP fails, the backup's control. The QP runs on
    ``admm`` (default: 100 iterations in four chunks that all adapt ρ, with
    polish), through the chunk kernel on a CUDA tensor."""
    with span("safety.filter"):
        return _filter_control(step_fn, backup, invariant, config, x, u_nominal, admm)


def _filter_control(step_fn, backup, invariant, config: SafetyFilterConfig, x: Tensor,
                    u_nominal: Tensor, admm: Optional[ADMMConfig]) -> SafetyFilterResult:
    admm = admm or ADMMConfig(max_iter=100, polish=True)
    n_u = u_nominal.shape[1]
    N = config.N
    x = x.detach()
    u_nominal = u_nominal.detach()
    target = _target(config, invariant)
    with span("safety.check"):
        # the check's evaluation is the first SCP iteration's linearization:
        # one evaluation serves both
        V0_nom, g_nom = _value_grad(step_fn, backup, invariant, N, x, u_nominal)
        safe = V0_nom <= invariant.alpha
    u_lin = u_nominal
    qp_ok = torch.ones_like(safe)
    record = open_solve_record()
    for it in range(config.scp_iterations):
        with span("safety.grad"):
            if it == 0:
                V0, g = V0_nom, g_nom
            else:
                V0, g = _value_grad(step_fn, backup, invariant, N, x, u_lin)
        with span("safety.qp"):
            data = _intervention_qp(config, u_nominal, u_lin, V0, g, target)
            z0 = torch.cat([u_lin, torch.zeros_like(u_lin[:, :1])], dim=1)
            sol = qp_solve(data, z0, None, admm)
            qp_ok = sol.status == SOLVED
            if record is not None:
                record["filter"].append({"V": V0, "dVdu": g, "u_lin": u_lin, "x": sol.x,
                                         "ok": qp_ok, "admm": admm})
            u_lin = torch.where(qp_ok[:, None], sol.x[:, :n_u], u_lin)
    with span("safety.select"):
        u_filtered = torch.where(qp_ok[:, None], u_lin, backup.control(x))
        u_out = torch.where(safe[:, None], u_nominal, u_filtered)
    return SafetyFilterResult(u=u_out, intervened=~safe, safe=safe, lyapunov_value=V0_nom,
                              qp_success=qp_ok)


def filter_gradient(step_fn: Callable, backup, invariant, config: SafetyFilterConfig, x: Tensor,
                    u_nominal: Tensor, steps: int = 20, lr: float = 0.1) -> SafetyFilterResult:
    """The QP-free fallback: projected gradient descent on V(x_N(u)) into
    the control box, a lane moving while its V lies above α·margin."""
    x, u_nominal = x.detach(), u_nominal.detach()
    safe, V0 = check_safety(step_fn, backup, invariant, config, x, u_nominal)
    target = _target(config, invariant)
    u = u_nominal
    for _ in range(steps):
        V, g = _value_grad(step_fn, backup, invariant, config.N, x, u)
        u_new = torch.minimum(torch.maximum(u - lr * g, config.u_min), config.u_max)
        u = torch.where((V > target)[:, None], u_new, u)
    return SafetyFilterResult(u=torch.where(safe[:, None], u_nominal, u), intervened=~safe,
                              safe=safe, lyapunov_value=V0, qp_success=torch.ones_like(safe))


def simulate_filtered(step_fn: Callable, backup, invariant, config: SafetyFilterConfig,
                      controller_fn: Callable[[Tensor, int], Tensor], x0: Tensor,
                      n_steps: int) -> dict:
    """Closed loop of every lane of x0 (B, n_x) with the filter applied every
    cycle; ``controller_fn(x, k) → u`` (B, n_u). Returns X (B, n_steps+1,
    n_x), U (B, n_steps, n_u), interventions (B, n_steps) and
    n_interventions (B,)."""
    x, Xs, Us, ints = x0, [x0], [], []
    for k in range(n_steps):
        res = filter_control(step_fn, backup, invariant, config, x, controller_fn(x, k))
        x = step_fn(x, res.u)
        Xs.append(x)
        Us.append(res.u)
        ints.append(res.intervened)
    interventions = torch.stack(ints, dim=1)
    return {"X": torch.stack(Xs, dim=1), "U": torch.stack(Us, dim=1),
            "interventions": interventions, "n_interventions": interventions.sum(1)}


def make_filtered_controller(controller_init, controller_step, step_fn: Callable, backup,
                             invariant, config: SafetyFilterConfig,
                             admm: Optional[ADMMConfig] = None, half_step: int = 10**9,
                             step_fn_from_inner: Optional[Callable] = None):
    """Compose a Monte-Carlo ``(controller_init, controller_step)`` pair with
    the filter, for ``run_campaign``. The wrapped state is ``(inner,
    n_interventions, n_interventions_early, consecutive, switched)``, each
    counter (B,); :func:`filtered_controller_info` surfaces them. A hit is
    an intervention while the lane is in flight (x[1] > 0.15); "early" hits
    come at k < ``half_step``.

    ``config.after_max="switch_to_backup"`` hands a lane whose filter
    intervened ``config.max_consecutive`` cycles in a row to the backup for
    the rest of the episode. ``step_fn_from_inner(inner) → step_fn``
    optionally derives the filter's model from the inner controller's state
    after its step (nominal plus the lanes' own learned GP means): it is
    called once a cycle and returns one lanes-first step function."""
    if config.after_max not in ("continue", "switch_to_backup"):
        raise ValueError(
            f"after_max={config.after_max!r}; expected 'continue' or 'switch_to_backup'")
    switch = config.after_max == "switch_to_backup"

    def finit(x0s):
        z = torch.zeros(x0s.shape[0], dtype=torch.int32, device=x0s.device)
        return (controller_init(x0s), z, z.clone(), z.clone(),
                torch.zeros(x0s.shape[0], dtype=torch.bool, device=x0s.device))

    def fstep(state, x, k: int):
        inner, n_int, n_early, consec, switched = state
        u_nom, inner2 = controller_step(inner, x, k)
        sf = step_fn if step_fn_from_inner is None else step_fn_from_inner(inner2)
        res = filter_control(sf, backup, invariant, config, x, u_nom, admm)
        # post-touchdown frozen lanes do not count
        hit_b = res.intervened & (x[:, 1] > 0.15)
        hit = hit_b.to(torch.int32)
        early = hit if int(k) < half_step else torch.zeros_like(hit)
        consec = torch.where(hit_b, consec + 1, torch.zeros_like(consec))
        u = res.u
        if switch:
            switched = switched | (consec >= config.max_consecutive)
            u_bak = torch.minimum(torch.maximum(backup.control(x), config.u_min), config.u_max)
            u = torch.where(switched[:, None], u_bak, u)
        return u, (inner2, n_int + hit, n_early + early, consec, switched)

    return finit, fstep


def filtered_controller_info(state) -> dict:
    """``cstate_info`` of campaigns over a filtered controller: the per-lane
    intervention counts (all, and before the factory's ``half_step``) and
    whether the lane switched to the backup."""
    _, n_int, n_early, _, switched = state
    return {"n_interventions": n_int, "n_interventions_early": n_early,
            "switched_to_backup": switched}


@dataclass(frozen=True)
class SimpleSafetyFilter:
    """Magnitude clamp only."""

    u_min: Tensor
    u_max: Tensor

    def filter(self, x: Tensor, u: Tensor) -> SafetyFilterResult:
        u_clamped = torch.minimum(torch.maximum(u, self.u_min), self.u_max)
        changed = ((u_clamped - u).abs() > 1e-9).any(-1)
        return SafetyFilterResult(u=u_clamped, intervened=changed, safe=~changed,
                                  lyapunov_value=torch.zeros_like(u[..., 0]),
                                  qp_success=torch.ones_like(changed))
