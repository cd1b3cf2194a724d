"""The safety filter's backup rollout and its gradient: the terminal value
V(x_N(u)) of every lane and ∂V/∂u, by a hand-written Hopper kernel or by its
plain version, and the wrapper that picks between them.

Replaces no TPU kernel (the JAX package differentiates the rollout with
``jax.grad`` under ``vmap`` and leaves it to XLA). The plain version is an
autograd tape of ~1,500 launches an evaluation; the kernel,
``gpmpc_tpu_torch/csrc/backup_value.cu`` (its header has the design and the
bound), is one. For each lane: x_1 = F(x, u), x_{k+1} = F(x_k, u_b(x_k)) for
k = 1 … N − 1, and V = invariant.value(x_N).

- :func:`fused` — whether the kernel computes what the plain version
  computes for a step, a backup and an invariant set; the only place that
  knows what the kernel takes.
- :func:`backup_value_grad` — the wrapper. A CUDA tensor launches the kernel
  (one launch) or raises, also when the card refuses the launch; a CPU
  tensor runs :func:`backup_value_grad_plain`. There is no fallback from the
  kernel to the plain version.
- :func:`backup_value_grad_plain` — the autograd route, the filter's since
  the port began: one backward pass of the summed V gives every lane's
  gradient (lanes do not couple). :func:`terminal_value` is its forward.
- :func:`bound_ms` — the least time an H100 could take for a launch.
- ``LAUNCHES`` — launches of the kernel, incremented once per launch and
  nowhere else (in a replayed CUDA graph, once per replay).

Launch ABI (that of ``rollout_linearize``): ``backup_value_f32(x, u, V, g, B,
N, model, stream)``, where ``model`` is the kernel's ``Model`` as a packed
float array in host memory: the 3-DoF constants (α, g, ½ρC_D A_ref, ε²),
dt/2, dt, dt/6, the downdraft's gust (0 for a plain ``Rocket3DoFStep``), the
backup's T_max and g_I, and the funnel's slope.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Tuple

import torch

from ...dynamics import rocket3dof as r3
from ...utils.graph_segments import tally
from . import F32_FLOPS_PER_S, HBM_BYTES_PER_S, _build
from .rollout_linearize import _constants3dof

NAME = "backup_value"  # csrc/<NAME>.cu and its entry points <NAME>_*
LAUNCHES = 0
_STEPS = (r3.Rocket3DoFStep, r3.Rocket3DoFDowndraftStep)


def fused(step, backup, invariant, x: torch.Tensor) -> bool:
    """Whether the kernel computes what the plain version computes: the step
    is a 3-DoF step value (nominal or with the downdraft) integrating by
    RK4, the backup emergency braking, the invariant set the descent funnel
    and the state float32. A lambda step, a learned model, another backup
    or set, another integrator or dtype keep the plain version."""
    # imported here: the safety package imports this module
    from ...safety.backup_controller import EmergencyBrakingController
    from ...safety.invariant_sets import DescentFunnelSet

    return (type(step) in _STEPS and step.params.integrator == "rk4"
            and type(backup) is EmergencyBrakingController
            and type(invariant) is DescentFunnelSet and x.dtype == torch.float32)


def backup_rollout_terminal(step_fn: Callable, backup, x: torch.Tensor, u: torch.Tensor,
                            N: int) -> torch.Tensor:
    """x_N after [u, backup, backup, …]."""
    x = step_fn(x, u)
    for _ in range(N - 1):
        x = step_fn(x, backup.control(x))
    return x


def terminal_value(step_fn, backup, invariant, N: int, x: torch.Tensor,
                   u: torch.Tensor) -> torch.Tensor:
    """V(x_N(u)) (B,)."""
    return invariant.value(backup_rollout_terminal(step_fn, backup, x, u, N))


def backup_value_grad_plain(step_fn, backup, invariant, N: int, x: torch.Tensor,
                            u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V(x_N(u)) (B,), ∂V/∂u (B, n_u)) of every lane from one backward
    pass of the summed V."""
    with torch.enable_grad():
        u = u.detach().requires_grad_(True)
        V = terminal_value(step_fn, backup, invariant, N, x.detach(), u)
        (g,) = torch.autograd.grad(V.sum(), u)
    return V.detach(), g


def _check(x: torch.Tensor, u: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] != r3.N_STATE or x.shape[0] < 1:
        raise ValueError(f"x must be (B, {r3.N_STATE}) with B ≥ 1, got {tuple(x.shape)}")
    if tuple(u.shape) != (x.shape[0], r3.N_CONTROL):
        raise ValueError(f"u must be {(x.shape[0], r3.N_CONTROL)}, got {tuple(u.shape)}")
    for name, t in (("x", x), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"u is on {u.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library() -> ctypes.CDLL:
    lib = _build.load(NAME)
    entry = getattr(lib, f"{NAME}_f32")
    if entry.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        entry.argtypes, entry.restype = [p] * 4 + [i] * 2 + [p, p], i
        for what in ("threads", "lanes", "model_floats"):
            fn = getattr(lib, f"{NAME}_{what}")
            fn.argtypes, fn.restype = [], i
    return lib


def _report(what: str) -> int:
    return getattr(_library(), f"{NAME}_{what}")()


def threads() -> int:
    """Threads a block of the launch."""
    return _report("threads")


def lanes_per_block() -> int:
    """Lanes a block of the launch."""
    return _report("lanes")


# the host copy of each (step, backup, invariant)'s Model, read once (the
# backup's g_I lies on the device; a launch reads nothing back from it):
# ids → (the three objects, floats)
_MODELS: Dict[Tuple[int, int, int], Tuple[tuple, List[float]]] = {}


def _model(step, backup, invariant) -> List[float]:
    """The kernel's ``Model``, field by field."""
    key = (id(step), id(backup), id(invariant))
    held = _MODELS.get(key)
    if held is None or any(a is not b for a, b in zip(held[0], (step, backup, invariant))):
        h = step.dt
        floats = (_constants3dof(step.params) + [0.5 * h, h, h / 6.0, getattr(step, "gust", 0.0),
                                                 backup.T_max]
                  + backup.g_I.detach().double().cpu().tolist() + [invariant.slope])
        held = _MODELS[key] = ((step, backup, invariant), floats)
    return held[1]


def _launch(step, backup, invariant, N: int, x: torch.Tensor, u: torch.Tensor):
    B = x.shape[0]
    lib = _library()
    model = _model(step, backup, invariant)
    floats = _report("model_floats")
    if len(model) != floats:
        raise RuntimeError(f"{NAME}'s model has {floats} floats, the wrapper packs {len(model)}")
    model = (ctypes.c_float * len(model))(*model)
    V = torch.empty(B, device=x.device)
    g = torch.empty(B, r3.N_CONTROL, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"{NAME}_f32")(x.data_ptr(), u.data_ptr(), V.data_ptr(),
                                          g.data_ptr(), B, N,
                                          ctypes.cast(model, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"{NAME}_f32 launch failed: CUDA error {err} (B={B}, N={N})")

    def count():
        global LAUNCHES
        LAUNCHES += 1

    tally(count)  # at each replay instead where a CUDA-graph recording captured the launch
    return V, g


def backup_value_grad(step, backup, invariant, N: int, x: torch.Tensor,
                      u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V(x_N(u)) (B,), ∂V/∂u (B, 3)) of every lane of x (B, 7) under the
    candidate control u (B, 3), then N − 1 steps of the backup.

    Both float32, contiguous and on one device. On CUDA this launches the
    kernel once, where :func:`fused` admits the step, backup and set (else
    ``ValueError``); on the CPU it runs :func:`backup_value_grad_plain`."""
    _check(x, u)
    if N < 1:
        raise ValueError(f"N must be ≥ 1, got {N}")
    if x.device.type == "cuda":
        if not fused(step, backup, invariant, x):
            raise ValueError(f"the kernel takes a 3-DoF RK4 step value, emergency braking and "
                             f"the descent funnel; got {type(step).__name__}, "
                             f"{type(backup).__name__}, {type(invariant).__name__}")
        return _launch(step, backup, invariant, N, x, u)
    if x.device.type == "cpu":
        return backup_value_grad_plain(step, backup, invariant, N, x, u)
    raise ValueError(f"unsupported device {x.device}")


def flops_per_lane(N: int) -> int:
    """Float operations of one lane, each counted once (the three threads of
    a lane each recompute the primal; that is not counted): a step's primal
    205 (‖u‖_ε 7, f 25 at each of 4 stages, the RK4 combination 91, the
    downdraft 7) and 247 a tangent column (‖u‖_ε's derivative 6, f's 36 a
    stage, the combination 91, the downdraft's 6); a backup control 30 and
    45 a column; the funnel 7 and 8 a column."""
    n_u = r3.N_CONTROL
    return N * (205 + n_u * 247) + (N - 1) * (30 + n_u * 45) + 7 + n_u * 8


def bound_ms(B: int, N: int) -> Tuple[float, str, int, int]:
    """(least ms on an H100, "bytes" or "ops", bytes, operations) for a launch
    over B lanes and N steps: x and u read once, V and g written once,
    against :func:`flops_per_lane`."""
    nbytes = 4 * B * (r3.N_STATE + r3.N_CONTROL + 1 + r3.N_CONTROL)
    flops = B * flops_per_lane(N)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "ops"), nbytes, flops
