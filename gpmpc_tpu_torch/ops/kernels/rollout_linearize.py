"""The GP-MPC cycle's re-anchoring rollout and its Jacobians: a hand-written
Hopper kernel for each rocket model, their plain version, and the wrapper
that picks between them by the step's type and the device.

Replaces no TPU kernel (the JAX package leaves the rollout's scan and
``vmap(jacfwd(F))`` to XLA's fusion). Eager PyTorch runs them as 1,945
launches a cycle on the 3-DoF main path and ~7,900 on the 6-DoF Path D; each
kernel is one. ``_KERNELS`` names the kernel of each step type:

- :class:`~gpmpc_tpu_torch.dynamics.rocket3dof.Rocket3DoFStep` —
  ``gpmpc_tpu_torch/csrc/rollout_linearize.cu``, RK4;
- :class:`~gpmpc_tpu_torch.dynamics.rocket6dof.Rocket6DoFStep` —
  ``gpmpc_tpu_torch/csrc/rollout_linearize6dof.cu``, RK4 with the
  quaternion renormalised after the step.

Each source's header has its design and bound. All take one launch ABI:
``<name>_f32(x0, U, tape, X, A, Bm, c, B, N, model, stream)``, where
``model`` is the kernel's ``Model`` as a packed float array in host memory,
and ``<name>_threads``, ``<name>_lanes`` and ``<name>_model_floats`` report
the launch and the model's size.

For a lane and knot k of the step F: X[k+1] = F(X[k], U[k]) + dt·tape[k]
(no residual where ``tape`` is None), and A[k], B[k], c[k] with F(x, u) ≈
A x + B u + c at (X[k], U[k]): the first SCP iteration's linearization in
``mpc/gp_mpc.py``.

- :func:`fused` — whether a kernel computes what the eager route computes
  for a step; the only place that knows which steps have a kernel.
- :func:`rollout_linearize` — the wrapper. A CUDA tensor launches the step's
  kernel (one launch) or raises, also when the card refuses the launch; a
  CPU tensor runs :func:`rollout_linearize_plain`. There is no fallback
  from the kernel to the plain version.
- :func:`rollout_linearize_plain` — the eager sequence it replaces, exactly:
  ``residual_rollout`` and then ``trajectory_jacobians``.
- :func:`bound_ms` — the least time an H100 could take for a launch.
- ``LAUNCHES`` — launches by kernel name, each incremented once per launch
  of its kernel, and nowhere else: in a cycle replayed from CUDA graphs
  (``utils/graph_segments.py``), once per replay and not at the recording.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ...dynamics import rocket3dof as r3
from ...dynamics import rocket6dof as r6
from ...dynamics.linearize import residual_rollout, trajectory_jacobians
from ...utils.graph_segments import tally
from . import F32_FLOPS_PER_S, HBM_BYTES_PER_S, _build

_Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _constants3dof(p: r3.Rocket3DoFParams) -> List[float]:
    """The 3-DoF ``Model``'s leading fields: α, g (3), ½ρC_D A_ref, ε²."""
    return [p.alpha, *p.gravity, 0.5 * p.rho * p.C_D * p.A_ref, r3._EPS_THRUST**2]


def _constants6dof(p: r6.Rocket6DoFParams) -> List[float]:
    """The 6-DoF ``Model``'s leading fields: α, ε², ½ρS, g_I, r_T_B, r_cp_B,
    J_B, J_B⁻¹, C_A (row-major)."""
    mats = torch.cat([t.detach().reshape(-1) for t in
                      (p.g_I, p.r_T_B, p.r_cp_B, p.J_B, p.J_B_inv, p.C_A)])
    return [p.alpha, r6._EPS_THRUST**2, 0.5 * p.rho * p.S_ref] + mats.double().cpu().tolist()


@dataclass(frozen=True)
class _Kernel:
    name: str  # csrc/<name>.cu and its entry points <name>_*
    n_x: int
    n_u: int
    flops_per_knot: int
    # the step's parameters → the Model's fields before dt/2, dt, dt/6 and
    # the tape's dt, which end every Model
    constants: Callable[[Any], List[float]]


_KERNELS: Dict[type, _Kernel] = {
    r3.Rocket3DoFStep: _Kernel(
        "rollout_linearize", r3.N_STATE, r3.N_CONTROL,
        # float operations a lane and knot, each counted once (the ten
        # threads of a lane each recompute the primal; that is not counted):
        # ‖u‖_ε 7; at each of the 4 RK4 stages f 24, and its derivative along
        # each of the 10 tangent columns 42; the 3 stage points 14, and 14 a
        # column; the RK4 sum and step 49, and 49 a column; the residual 14;
        # c = F − A x − B u 154
        7 + 4 * (24 + 10 * 42) + 3 * (14 + 10 * 14) + (49 + 10 * 49) + 14 + 154,
        _constants3dof),
    r6.Rocket6DoFStep: _Kernel(
        "rollout_linearize6dof", r6.N_STATE, r6.N_CONTROL,
        # float operations a lane and knot, each counted once (the 14
        # threads of a lane each recompute the primal; that is not counted):
        # ‖u‖_ε 8; at each of the 4 RK4 stages f 195, and its derivative
        # along each of the 14 live tangent columns 305; the 3 stage points,
        # the RK4 sum and step 182, and 182 a column; the renormalisation 13,
        # and 19 a column; the residual 28; c = F − A x − B u 476
        (8 + 4 * (195 + 14 * 305) + (182 + 14 * 182) + (13 + 14 * 19) + 28
         + 14 * (r6.N_STATE + r6.N_CONTROL) * 2),
        _constants6dof),
}
LAUNCHES: Dict[str, int] = {k.name: 0 for k in _KERNELS.values()}


def fused(step, x0: torch.Tensor) -> bool:
    """Whether a kernel computes what the eager route computes for ``step``
    from ``x0``: the step's type has a kernel, it integrates by RK4 and the
    state is float32. A lambda step, another integrator or dtype keep the
    eager route."""
    return (type(step) in _KERNELS and step.params.integrator == "rk4"
            and x0.dtype == torch.float32)


def kernel_name(model: type) -> str:
    """The kernel of a step type: its source ``csrc/<name>.cu``, its key in
    ``LAUNCHES``."""
    return _KERNELS[model].name


def rollout_linearize_plain(step, x0: torch.Tensor, U: torch.Tensor,
                            tape: Optional[torch.Tensor] = None,
                            dt: Optional[float] = None) -> _Outputs:
    """The eager route: the rollout x⁺ = F(x, u) + dt·tape[k] (a zero
    residual without a tape), then the forward-mode Jacobians of F at every
    knot. Returns X (B,N+1,n_x), A (B,N,n_x,n_x), B (B,N,n_x,n_u),
    c (B,N,n_x)."""
    dt = step.dt if dt is None else dt
    if tape is None:
        X = residual_rollout(step, x0, U, dt, lambda k, x, u: torch.zeros_like(x))
    else:
        X = residual_rollout(step, x0, U, dt, lambda k, x, u: tape[:, k])
    return (X, *trajectory_jacobians(step, X, U))


def _check(step, x0, U, tape) -> _Kernel:
    kernel = _KERNELS.get(type(step))
    if kernel is None:
        raise TypeError(f"no rollout kernel takes a {type(step).__name__} step; kernels take "
                        + ", ".join(t.__name__ for t in _KERNELS))
    n_x, n_u = kernel.n_x, kernel.n_u
    if U.dim() != 3 or U.shape[2] != n_u or U.shape[0] < 1 or U.shape[1] < 1:
        raise ValueError(f"U must be (B, N, {n_u}) with B, N ≥ 1, got {tuple(U.shape)}")
    B, N = U.shape[:2]
    want = {"x0": (x0, (B, n_x))}
    if tape is not None:
        want["tape"] = (tape, (B, N, n_x))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in [("U", U)] + [(k, v[0]) for k, v in want.items()]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != U.device:
            raise ValueError(f"{name} is on {t.device}, U on {U.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return kernel


def _library(kernel: _Kernel) -> ctypes.CDLL:
    lib = _build.load(kernel.name)
    entry = getattr(lib, f"{kernel.name}_f32")
    if entry.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        entry.argtypes, entry.restype = [p] * 7 + [i] * 2 + [p, p], i
        for what in ("threads", "lanes", "model_floats"):
            fn = getattr(lib, f"{kernel.name}_{what}")
            fn.argtypes, fn.restype = [], i
    return lib


def _report(kernel: _Kernel, what: str) -> int:
    return getattr(_library(kernel), f"{kernel.name}_{what}")()


def threads(model: type) -> int:
    """Threads a block of the step type's launch."""
    return _report(_KERNELS[model], "threads")


def lanes_per_block(model: type) -> int:
    """Lanes a block of the step type's launch."""
    return _report(_KERNELS[model], "lanes")


# the host copy of each parameter set's constants, read once (a launch reads
# no tensor back from the device): id(params) → (params, floats)
_CONSTANTS: Dict[int, Tuple[Any, List[float]]] = {}


def _model(step, dt: float) -> List[float]:
    """The kernel's ``Model``, field by field: the step's constants, then
    dt/2, dt, dt/6 of the step and the tape's dt."""
    p, h = step.params, step.dt
    held = _CONSTANTS.get(id(p))
    if held is None or held[0] is not p:
        held = _CONSTANTS[id(p)] = (p, _KERNELS[type(step)].constants(p))
    return held[1] + [0.5 * h, h, h / 6.0, dt]


def _launch(kernel: _Kernel, step, x0, U, tape, dt: float) -> _Outputs:
    B, N = U.shape[:2]
    name = kernel.name
    lib = _library(kernel)
    model = _model(step, dt)
    floats = _report(kernel, "model_floats")
    if len(model) != floats:
        raise RuntimeError(f"{name}'s model has {floats} floats, the wrapper packs {len(model)}")
    model = (ctypes.c_float * len(model))(*model)
    n_x, n_u = kernel.n_x, kernel.n_u
    X = torch.empty(B, N + 1, n_x, device=U.device)
    A = torch.empty(B, N, n_x, n_x, device=U.device)
    Bm = torch.empty(B, N, n_x, n_u, device=U.device)
    c = torch.empty(B, N, n_x, device=U.device)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = getattr(lib, f"{name}_f32")(
            x0.data_ptr(), U.data_ptr(), None if tape is None else tape.data_ptr(),
            X.data_ptr(), A.data_ptr(), Bm.data_ptr(), c.data_ptr(), B, N,
            ctypes.cast(model, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"{name}_f32 launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, tape {tape is not None})")

    def count():
        LAUNCHES[name] += 1

    tally(count)  # at each replay instead where a CUDA-graph recording captured the launch
    return X, A, Bm, c


def rollout_linearize(step, x0: torch.Tensor, U: torch.Tensor,
                      tape: Optional[torch.Tensor] = None,
                      dt: Optional[float] = None) -> _Outputs:
    """The rollout from x0 (B,n_x) under U (B,N,n_u) with the residual tape
    (B,N,n_x) scaled by ``dt`` (default: the step's), or none, and the
    step's Jacobians at its knots: X (B,N+1,n_x), A (B,N,n_x,n_x),
    B (B,N,n_x,n_u), c (B,N,n_x), with n_x and n_u the step's model's.

    ``step`` is a step value with a kernel (``TypeError`` otherwise). Every
    tensor is float32, contiguous and on one device. On CUDA this launches
    the step's kernel once (or raises); on the CPU it runs
    :func:`rollout_linearize_plain`."""
    kernel = _check(step, x0, U, tape)
    dt = step.dt if dt is None else dt
    if U.device.type == "cuda":
        if not fused(step, x0):
            raise ValueError(f"the kernel integrates by RK4, the step by "
                             f"{step.params.integrator!r}")
        return _launch(kernel, step, x0, U, tape, dt)
    if U.device.type == "cpu":
        return rollout_linearize_plain(step, x0, U, tape, dt)
    raise ValueError(f"unsupported device {U.device}")


def bound_ms(model: type, B: int, N: int, tape: bool = True) -> Tuple[float, str, int, int]:
    """(least ms on an H100, "bytes" or "ops", bytes, operations) for a launch
    of the step type's kernel over B lanes and N knots: each input byte read
    once and each output byte written once, against the kernel's float
    operations a lane and knot."""
    k = _KERNELS[model]
    n_x, n_u = k.n_x, k.n_u
    floats_in = n_x + N * n_u + (N * n_x if tape else 0)
    floats_out = (N + 1) * n_x + N * (n_x * n_x + n_x * n_u + n_x)
    nbytes = 4 * B * (floats_in + floats_out)
    flops = B * N * k.flops_per_knot
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "ops"), nbytes, flops
