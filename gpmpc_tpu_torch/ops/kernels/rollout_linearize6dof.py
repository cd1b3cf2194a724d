"""The 6-DoF GP-MPC cycle's re-anchoring rollout and its Jacobians:
hand-written Hopper kernel, its plain version, and the wrapper that picks
between them by device.

Replaces no TPU kernel (the JAX package leaves the rollout's scan and
``vmap(jacfwd(F))`` to XLA's fusion). Eager PyTorch runs them as ~7,900
launches a cycle on Path D; the kernel, ``gpmpc_tpu_torch/csrc/
rollout_linearize6dof.cu``, is one. Its source's header has the design and
the bound. The 3-DoF rocket has its own kernel and wrapper
(``rollout_linearize``); the two share no code.

For a lane and knot k of the 6-DoF rocket's renormalised RK4 step F
(:class:`~gpmpc_tpu_torch.dynamics.rocket6dof.Rocket6DoFStep`): X[k+1] =
F(X[k], U[k]) + dt·tape[k] (no residual where ``tape`` is None), and A[k],
B[k], c[k] with F(x, u) ≈ A x + B u + c at (X[k], U[k]): the first SCP
iteration's linearization in ``mpc/gp_mpc.py``.

- :func:`rollout_linearize6dof` — the wrapper. A CUDA tensor launches the
  kernel (one launch) or raises, also when the card refuses the launch; a
  CPU tensor runs :func:`rollout_linearize6dof_plain`. There is no fallback
  from the kernel to the plain version.
- :func:`rollout_linearize6dof_plain` — the eager sequence it replaces,
  exactly: ``residual_rollout`` and then ``trajectory_jacobians``.
- :func:`bound_ms` — the least time an H100 could take for a launch.
- ``LAUNCHES`` — incremented once per kernel launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from ...dynamics.linearize import residual_rollout, trajectory_jacobians
from ...dynamics.rocket6dof import (_EPS_THRUST, N_CONTROL, N_STATE, Rocket6DoFParams,
                                    Rocket6DoFStep)
from . import _build

KERNEL = "rollout_linearize6dof"
LAUNCHES = 0
# float operations a lane and knot, each counted once (the 14 threads of a
# lane each recompute the primal; that is not counted): ‖u‖_ε 8; at each of
# the 4 RK4 stages f 195, and its derivative along each of the 14 live
# tangent columns 305; the 3 stage points, the RK4 sum and step 182, and 182
# a column; the renormalisation 13, and 19 a column; the residual 28;
# c = F − A x − B u 476
FLOPS_PER_KNOT = (8 + 4 * (195 + 14 * 305) + (182 + 14 * 182) + (13 + 14 * 19) + 28
                  + 14 * (N_STATE + N_CONTROL) * 2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

_Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def rollout_linearize6dof_plain(step: Rocket6DoFStep, x0: torch.Tensor, U: torch.Tensor,
                                tape: Optional[torch.Tensor] = None,
                                dt: Optional[float] = None) -> _Outputs:
    """The eager route: the rollout x⁺ = F(x, u) + dt·tape[k] (a zero
    residual without a tape), then the forward-mode Jacobians of F at every
    knot. Returns X (B,N+1,14), A (B,N,14,14), B (B,N,14,3), c (B,N,14)."""
    dt = step.dt if dt is None else dt
    if tape is None:
        X = residual_rollout(step, x0, U, dt, lambda k, x, u: torch.zeros_like(x))
    else:
        X = residual_rollout(step, x0, U, dt, lambda k, x, u: tape[:, k])
    return (X, *trajectory_jacobians(step, X, U))


def _check(step, x0, U, tape) -> Tuple[int, int]:
    if not isinstance(step, Rocket6DoFStep):
        raise TypeError(f"step must be a Rocket6DoFStep, got {type(step).__name__}")
    if U.dim() != 3 or U.shape[2] != N_CONTROL or U.shape[0] < 1 or U.shape[1] < 1:
        raise ValueError(f"U must be (B, N, {N_CONTROL}) with B, N ≥ 1, got {tuple(U.shape)}")
    B, N = U.shape[:2]
    want = {"x0": (x0, (B, N_STATE))}
    if tape is not None:
        want["tape"] = (tape, (B, N, N_STATE))
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
    return B, N


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.rollout_linearize6dof_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rollout_linearize6dof_f32.argtypes = [p] * 7 + [i] * 2 + [p, p]
        lib.rollout_linearize6dof_f32.restype = i
        for name in ("threads", "lanes", "model_floats"):
            fn = getattr(lib, f"rollout_linearize6dof_{name}")
            fn.argtypes, fn.restype = [], i
    return lib


def threads() -> int:
    """Threads a block of the launch."""
    return _library().rollout_linearize6dof_threads()


def lanes_per_block() -> int:
    """Lanes a block of the launch."""
    return _library().rollout_linearize6dof_lanes()


# the host copy of each parameter set's constants, read from the device once
# (a launch reads no tensor back): id(params) → (params, floats)
_CONSTANTS: Dict[int, Tuple[Rocket6DoFParams, List[float]]] = {}


def _model(step: Rocket6DoFStep, dt: float) -> List[float]:
    """The kernel's ``Model``, field by field: α, ε², ½ρS, g_I, r_T_B,
    r_cp_B, J_B, J_B⁻¹, C_A (row-major), dt/2, dt, dt/6 of the step, and the
    tape's dt."""
    p, h = step.params, step.dt
    held = _CONSTANTS.get(id(p))
    if held is None or held[0] is not p:
        mats = torch.cat([t.detach().reshape(-1) for t in
                          (p.g_I, p.r_T_B, p.r_cp_B, p.J_B, p.J_B_inv, p.C_A)])
        held = _CONSTANTS[id(p)] = (p, [p.alpha, _EPS_THRUST**2, 0.5 * p.rho * p.S_ref]
                                    + mats.double().cpu().tolist())
    return held[1] + [0.5 * h, h, h / 6.0, dt]


def _launch(step: Rocket6DoFStep, x0, U, tape, dt: float) -> _Outputs:
    global LAUNCHES
    B, N = U.shape[:2]
    if step.params.integrator != "rk4":
        raise ValueError(f"the kernel integrates by RK4, the step by {step.params.integrator!r}")
    lib = _library()
    model = _model(step, dt)
    if len(model) != lib.rollout_linearize6dof_model_floats():
        raise RuntimeError(f"the kernel's model has {lib.rollout_linearize6dof_model_floats()} "
                           f"floats, the wrapper packs {len(model)}")
    model = (ctypes.c_float * len(model))(*model)
    X = torch.empty(B, N + 1, N_STATE, device=U.device)
    A = torch.empty(B, N, N_STATE, N_STATE, device=U.device)
    Bm = torch.empty(B, N, N_STATE, N_CONTROL, device=U.device)
    c = torch.empty(B, N, N_STATE, device=U.device)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = lib.rollout_linearize6dof_f32(
            x0.data_ptr(), U.data_ptr(), None if tape is None else tape.data_ptr(),
            X.data_ptr(), A.data_ptr(), Bm.data_ptr(), c.data_ptr(), B, N,
            ctypes.cast(model, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"rollout_linearize6dof_f32 launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, tape {tape is not None})")
    LAUNCHES += 1
    return X, A, Bm, c


def rollout_linearize6dof(step: Rocket6DoFStep, x0: torch.Tensor, U: torch.Tensor,
                          tape: Optional[torch.Tensor] = None,
                          dt: Optional[float] = None) -> _Outputs:
    """The rollout from x0 (B,14) under U (B,N,3) with the residual tape
    (B,N,14) scaled by ``dt`` (default: the step's), or none, and the step's
    Jacobians at its knots: X (B,N+1,14), A (B,N,14,14), B (B,N,14,3),
    c (B,N,14).

    Every tensor is float32, contiguous and on one device. On CUDA this
    launches the kernel once (or raises); on the CPU it runs
    :func:`rollout_linearize6dof_plain`."""
    _check(step, x0, U, tape)
    dt = step.dt if dt is None else dt
    if U.device.type == "cuda":
        return _launch(step, x0, U, tape, dt)
    if U.device.type == "cpu":
        return rollout_linearize6dof_plain(step, x0, U, tape, dt)
    raise ValueError(f"unsupported device {U.device}")


def bound_ms(B: int, N: int, tape: bool = True) -> Tuple[float, str, int, int]:
    """(least ms on an H100, "bytes" or "ops", bytes, operations) for a launch
    of B lanes and N knots: each input byte read once and each output byte
    written once, against ``FLOPS_PER_KNOT`` a lane and knot."""
    floats_in = N_STATE + N * N_CONTROL + (N * N_STATE if tape else 0)
    floats_out = (N + 1) * N_STATE + N * (N_STATE * N_STATE + N_STATE * N_CONTROL + N_STATE)
    nbytes = 4 * B * (floats_in + floats_out)
    flops = B * N * FLOPS_PER_KNOT
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "ops"), nbytes, flops
