"""The GP-MPC control cycle replayed from CUDA-graph segments.

The condensed 3-DoF cycle is some 660 microsecond-scale kernels, each behind
a launch call of its own, so the host sets its pace and the device idles.
Where :func:`replay_rule` admits a call, the first call at its key
(:func:`cycle_key`) runs eagerly, which also warms up cuBLAS and cuSOLVER;
the second records the cycle (``utils/graph_segments.py``) as CUDA-graph
segments broken at the stage spans (``gpmpc.rollout``, ``gpmpc.gp_posterior``,
``gpmpc.propagate_tighten``, ``gpmpc.qp_build``, ``gpmpc.admm_solve`` and its
``admm.*`` children; the tail after the solve is a segment of its own) and
at the ADMM chunk launch, which stays an eager launch of the hand-written
kernel on every cycle; every later call replays them. A replay copies the
state and x0 into the recording's input buffers, launches the segments
inside their spans under the span ``gpmpc.replay``, and copies the results
out: what a call returns is the caller's, and no later call writes to it.
Every other call runs eagerly under the span ``gpmpc.eager``.

A replay reads the GP's tensors where the recording found them, so both GP
callables must declare a frozen posterior (:func:`declare_frozen`, set where
a fitted GP's callables are built); a learner that refits its GP builds
callables without it and stays eager.

Counters: ``CAPTURES``, ``REPLAYS``, and ``EAGER`` by the reason the rule
gave ("first_call": the eager first call at a replayable key;
"capture_failed": a key whose recording raised, with a warning, for a host
read the rule does not see).
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from ..ops.qp.admm import host_reads
from ..utils.graph_segments import SegmentedGraph
from ..utils.profiler import span
from .rti import _condensed_admm_cfg

FROZEN = "frozen_posterior"  # the attribute a GP callable declares
CAPTURE_FAILED = "capture_failed"  # the reason, and the key's mark, after a failed recording
MAX_CYCLES = 4  # recordings kept, the least recently used dropped first

CAPTURES = 0
REPLAYS = 0
EAGER: Dict[str, int] = {}

# key → the key's objects (held, so that their ids stay theirs) while it has
# been seen once, then its _Replay, or CAPTURE_FAILED
_CYCLES: "OrderedDict[tuple, object]" = OrderedDict()

_STATE_IN = ("X_lin", "U_lin", "x_ref", "rho", "y_prev")
_FLOATS = ("X_opt", "U_opt", "cost", "Sigmas", "X_lin", "U_lin", "rho", "y_prev")


def declare_frozen(*fns: Callable) -> None:
    """Declare that each GP callable reads a posterior that no later call
    changes in place: a replayed cycle may read it where it was recorded."""
    for fn in fns:
        setattr(fn, FROZEN, True)


def is_frozen(fn: Callable) -> bool:
    return getattr(fn, FROZEN, False) is True


def replay_rule(config, device, fused: bool, frozen: bool) -> Optional[str]:
    """Why a cycle of ``config`` on ``device`` runs eagerly, or None where it
    is replayed. ``fused``: the rollout takes its kernel's route
    (``gp_mpc.fused_rollout``); ``frozen``: both GP callables declare a
    frozen posterior. A replay needs a cycle that never reads the device from
    the host and reads nothing the recording cannot hold: the condensed QP,
    solved by ADMM with no host read in its schedule (one chunk, or no early
    exit, and no bf16 tail), no KKT carry, no stage rows from a callable,
    the tightening mask on the device, the fused rollout and frozen GPs."""
    base = config.base
    if torch.device(device).type != "cuda":
        return "device"
    if config.warm_kkt:
        return "warm_kkt"
    if not base.condensed:
        return "sparse_form"
    if base.solver != "admm":
        return "solver"
    if base.stage_rows_fn is not None:
        return "stage_rows_fn"
    mask = config.tighten_mask
    if mask is not None and not (torch.is_tensor(mask) and mask.dtype == torch.float32
                                 and mask.device == torch.device(device)):
        return "tighten_mask"
    if host_reads(_condensed_admm_cfg(base)):
        return "admm_host_reads"
    if not fused:
        return "rollout"
    if not frozen:
        return "posterior"
    return None


def cycle_key(step_fn, gp_mean_fn, gp_var_fn, config, x0: torch.Tensor) -> tuple:
    return (id(step_fn), id(gp_mean_fn), id(gp_var_fn), id(config), tuple(x0.shape),
            x0.dtype, x0.device)


def run(cycle: Callable, step_fn, gp_mean_fn, gp_var_fn, config, state, x0, fused: bool):
    """One control cycle: ``cycle(step_fn, gp_mean_fn, gp_var_fn, config,
    state, x0)`` (the eager cycle), replayed where the rule admits it."""
    global CAPTURES, REPLAYS
    key = cycle_key(step_fn, gp_mean_fn, gp_var_fn, config, x0)
    held = _CYCLES.get(key)
    if isinstance(held, _Replay) and held.takes(state, x0):
        _CYCLES.move_to_end(key)
        REPLAYS += 1
        with span("gpmpc.replay"):
            return held(state, x0)
    reason = replay_rule(config, x0.device, fused,
                         is_frozen(gp_mean_fn) and is_frozen(gp_var_fn))
    if reason is None and isinstance(held, _Replay):
        reason = "state"  # the state's shapes are not the recording's
    elif reason is None and isinstance(held, str):
        reason = held
    elif reason is None and held is None:
        _CYCLES[key] = (step_fn, gp_mean_fn, gp_var_fn, config)
        while len(_CYCLES) > MAX_CYCLES:
            _CYCLES.popitem(last=False)
        reason = "first_call"
    elif reason is None:
        with span("gpmpc.capture"):
            try:
                rep = _Replay(cycle, (step_fn, gp_mean_fn, gp_var_fn, config), state, x0)
            except Exception as exc:
                # a host read the rule does not see: the key runs eagerly from now on
                warnings.warn(f"the GP-MPC cycle could not be recorded as CUDA graphs, and "
                              f"runs eagerly: {exc}")
                _CYCLES[key] = reason = CAPTURE_FAILED
            else:
                _CYCLES[key] = rep
                _CYCLES.move_to_end(key)
                CAPTURES += 1
                return rep(state, x0)
    EAGER[reason] = EAGER.get(reason, 0) + 1
    with span("gpmpc.eager"):
        return cycle(step_fn, gp_mean_fn, gp_var_fn, config, state, x0)


class _Replay:
    """One recorded cycle: its input buffers, its segments and the flat
    buffers its results are packed into (the floats, then the two flags)."""

    def __init__(self, cycle: Callable, fns: tuple, state, x0: torch.Tensor):
        self.fns = fns  # held, so that the key's ids stay theirs
        self.x0 = torch.empty(x0.shape, dtype=x0.dtype, device=x0.device)
        self.ins = {k: torch.empty(getattr(state, k).shape, dtype=getattr(state, k).dtype,
                                   device=x0.device) for k in _STATE_IN}
        self.graph = SegmentedGraph(x0.device)
        self._fill(state, x0)
        held: dict = {}

        def body():
            sol, new = cycle(*fns, state.replace(**self.ins), self.x0)
            outs = [getattr(sol, k) for k in _FLOATS[:4]] + [getattr(new, k) for k in _FLOATS[4:]]
            if any(t.dtype != x0.dtype for t in outs):
                raise TypeError("a replayed cycle packs its results in x0's dtype")
            held.update(sol=sol, shapes=[t.shape for t in outs])
            return (torch.cat([t.reshape(-1) for t in outs]),
                    torch.cat([sol.converged, sol.success]))

        self.flat, self.flags = self.graph.record(body)
        self.sol = held["sol"]  # the template: scp_iters and the fields' types
        self.views, o = [], 0
        for k, shape in zip(_FLOATS, held["shapes"]):
            n = shape.numel()
            self.views.append((k, o, n, shape))
            o += n

    def takes(self, state, x0: torch.Tensor) -> bool:
        """Whether the state's tensors fit the input buffers (x0's shape,
        dtype and device are the key's)."""
        for k, buf in self.ins.items():
            t = getattr(state, k)
            if t.shape != buf.shape or t.dtype != buf.dtype or t.device != buf.device:
                return False
        return True

    def _fill(self, state, x0: torch.Tensor) -> None:
        self.x0.copy_(x0)
        for k, buf in self.ins.items():
            buf.copy_(getattr(state, k))

    def __call__(self, state, x0: torch.Tensor):
        self._fill(state, x0)
        self.graph.replay()
        flat, flags = self.flat.clone(), self.flags.clone()
        r = {k: flat[o:o + n].view(shape) for k, o, n, shape in self.views}
        B = flags.shape[0] // 2
        sol = self.sol._replace(X_opt=r["X_opt"], U_opt=r["U_opt"], u0=r["U_opt"][:, 0],
                                cost=r["cost"], converged=flags[:B], success=flags[B:],
                                Sigmas=r["Sigmas"])
        return sol, state.replace(X_lin=r["X_lin"], U_lin=r["U_lin"], rho=r["rho"],
                                  y_prev=r["y_prev"])
