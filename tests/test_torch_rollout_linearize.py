"""The fused rollout and linearization on the CPU, for each rocket model that
has a kernel: the step values ``Rocket3DoFStep`` and ``Rocket6DoFStep``
against their models' ``step``, the plain version of ``rollout_linearize``
against the JAX package, the route ``gp_mpc_solve`` takes to it, the
wrapper's argument checks, its bound and the kernel's packed model. The
kernels themselves run in tests/test_torch_cuda.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from gpmpc_tpu.dynamics import Rocket3DoFParams as Jax3Params
from gpmpc_tpu.dynamics import Rocket6DoFParams as Jax6Params
from gpmpc_tpu.dynamics import rocket3dof as jr3
from gpmpc_tpu.dynamics import rocket6dof as jr6
from gpmpc_tpu.dynamics import trajectory_jacobians as jax_tj
from gpmpc_tpu_torch.dynamics import (Rocket3DoFParams, Rocket3DoFStep, Rocket6DoFParams,
                                      Rocket6DoFStep)
from gpmpc_tpu_torch.dynamics import rocket3dof as tr3
from gpmpc_tpu_torch.dynamics import rocket6dof as tr6
from gpmpc_tpu_torch.main_path import main_path, sixdof_path
from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve
from gpmpc_tpu_torch.mpc.gp_mpc import fused_rollout
from gpmpc_tpu_torch.ops.kernels import rollout_linearize as RL

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
MODELS = ("3dof", "6dof")
STEP = {"3dof": Rocket3DoFStep, "6dof": Rocket6DoFStep}
PARAMS = {"3dof": Rocket3DoFParams, "6dof": Rocket6DoFParams}
JAX_STEP = {"3dof": jr3.step, "6dof": jr6.step}
STEP_FN = {"3dof": tr3.step, "6dof": tr6.step}
N_X = {"3dof": 7, "6dof": 14}
KERNEL = {"3dof": "rollout_linearize", "6dof": "rollout_linearize6dof"}
# each model nominal and with its plant's drag: the main path's drag for the
# 3-DoF rocket, Path D's light aero for the 6-DoF one (tests/test_torch_6dof.py's)
VARIANTS = [("3dof", "nominal"), ("3dof", "drag"), ("6dof", "nominal"), ("6dof", "aero")]
DRAG = dict(rho=1.0, C_D=1.0, A_ref=0.1)
AERO = dict(rho=0.8, C_A=0.05 * np.eye(3, dtype=np.float32))


def _params(model, variant="nominal"):
    """The JAX package's and the port's parameters of one variant."""
    if model == "3dof":
        kw = DRAG if variant == "drag" else {}
        return Jax3Params().replace(**kw), Rocket3DoFParams(device="cpu", **kw)
    jp, tp = Jax6Params(), Rocket6DoFParams(device="cpu")
    if variant == "aero":
        jp = jp.replace(rho=AERO["rho"], C_A=jnp.asarray(AERO["C_A"]))
        tp = tp.replace(**AERO)
    return jp, tp


def _plant(model):
    return "drag" if model == "3dof" else "aero"


def _inputs(model, seed=0, B=3, N=5):
    """3-DoF: states around the main path's (30 m, −3 m/s), controls around
    hover, a residual tape of the GP's size (lifted accelerations of ~0.1).
    6-DoF: descent states about Path D's (15-20 m, −2 m/s), unit quaternions
    near upright, small rates; controls about hover; a residual tape of the
    GP's lifted size (accelerations of ~0.05 on every row)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    if model == "3dof":
        x0 = np.array([2, 30, 0, 0, -3, 0, 0]) + 0.5 * rng.normal(size=(B, 7))
        U = np.array([2, 0, 0]) + 0.3 * rng.normal(size=(B, N, 3))
        tape = 0.1 * rng.normal(size=(B, N, 7))
        return f32(x0), f32(U), f32(tape)
    x0 = np.zeros((B, 14))
    x0[:, 0] = 1.5 + 0.4 * rng.random(B)
    x0[:, 1] = 15.0 + 5.0 * rng.random(B)
    x0[:, 2:4] = rng.normal(size=(B, 2))
    x0[:, 4:7] = np.array([-2.0, 0.1, 0.0]) + 0.5 * rng.normal(size=(B, 3))
    q = np.array([1.0, 0, 0, 0]) + 0.2 * rng.normal(size=(B, 4))
    x0[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x0[:, 11:14] = 0.2 * rng.normal(size=(B, 3))
    U = np.array([2.0, 0, 0]) + 0.3 * rng.normal(size=(B, N, 3))
    tape = 0.05 * rng.normal(size=(B, N, 14))
    return f32(x0), f32(U), f32(tape)


def _jax_rollout(jstep, jp, x0, U, tape):
    """gpmpc_tpu/mpc/gp_mpc.py's tape rollout (a zero residual without a
    tape), then its trajectory_jacobians, for each lane."""

    def lane(x0, U, tape):
        def body(x, inp):
            u, mu = inp
            xn = jstep(jp, x, u, DT) + DT * mu
            return xn, xn

        _, Xr = jax.lax.scan(body, x0, (U, tape))
        X = jnp.concatenate([x0[None], Xr], axis=0)
        return (X, *jax_tj(lambda x, u: jstep(jp, x, u, DT), X, U))

    return jax.vmap(lane)(x0, U, tape)


@pytest.mark.parametrize("model,variant", VARIANTS)
def test_step_value_is_the_step(model, variant):
    _, p = _params(model, variant)
    F = STEP[model](p, DT)
    lam = lambda x, u: STEP_FN[model](p, x, u, DT)
    x0, U, _ = _inputs(model)
    x, u = torch.tensor(x0), torch.tensor(U[:, 0])
    assert torch.equal(F(x, u), STEP_FN[model](p, x, u, DT))
    J = vmap(jacfwd(F, argnums=(0, 1)))(x, u)
    J_lam = vmap(jacfwd(lam, argnums=(0, 1)))(x, u)
    assert all(torch.equal(a, b) for a, b in zip(J, J_lam))
    assert F == STEP[model](p, DT) and hash(F) == hash(STEP[model](p, DT))


# (the states' rtol and atol, the Jacobians' and c's): the 3-DoF step to
# tests/test_torch_dynamics.py's 1e-6 (the states over 5 knots carry 30 m of
# altitude, so they take it relative to that), its Jacobians to rtol 1e-5,
# atol 1e-6; the renormalised 6-DoF step to tests/test_torch_6dof.py's
# 1e-5, its Jacobians and c to 1e-4
PLAIN_TOL = {"3dof": ((1e-6, 1e-6), (1e-5, 1e-6)), "6dof": ((1e-5, 1e-5), (1e-4, 1e-4))}


@pytest.mark.parametrize("tape", [True, False], ids=["tape", "zero-residual"])
@pytest.mark.parametrize("model,variant", VARIANTS)
def test_plain_version_matches_jax(model, variant, tape):
    jp, tp = _params(model, variant)
    step = STEP[model](tp, DT)
    x0, U, T = _inputs(model, 1)
    ref = _jax_rollout(JAX_STEP[model], jp, x0, U, T if tape else np.zeros_like(T))
    out = RL.rollout_linearize_plain(step, torch.tensor(x0), torch.tensor(U),
                                     torch.tensor(T) if tape else None)
    (rx, ax), (rj, aj) = PLAIN_TOL[model]
    np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=rx, atol=ax)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), r, rtol=rj, atol=aj)


@pytest.mark.parametrize("tape", [True, False], ids=["tape", "zero-residual"])
@pytest.mark.parametrize("model", MODELS)
def test_wrapper_on_the_cpu_is_the_plain_version(model, tape):
    step = STEP[model](_params(model, _plant(model))[1], DT)
    x0, U, T = (torch.tensor(a) for a in _inputs(model, 2, B=4, N=20))
    T = T if tape else None
    before = dict(RL.LAUNCHES)
    got = RL.rollout_linearize(step, x0, U, T)
    want = RL.rollout_linearize_plain(step, x0, U, T)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    n = N_X[model]
    assert [tuple(t.shape) for t in got] == [(4, 21, n), (4, 20, n, n), (4, 20, n, 3), (4, 20, n)]
    assert RL.LAUNCHES == before  # a CPU tensor runs the plain version


def _gp_fns(model):
    """A smooth stand-in for the GP: small state-dependent means on the
    velocity rows (and on the rate rows of the 6-DoF two-GP residual),
    constant variances (n_gp = 3, or 6)."""
    def mean(X, U):
        out = torch.zeros_like(X)
        out[..., 4:7] = 0.05 * torch.tanh(0.1 * X[..., 4:7] + 0.01 * U)
        if model == "6dof":
            out[..., 11:14] = 0.02 * torch.tanh(X[..., 11:14] + 0.01 * U)
        return out

    n_gp = 3 if model == "3dof" else 6
    return mean, lambda X, U: torch.full((*X.shape[:-1], n_gp), 1e-3)


def _path(model):
    return main_path("cpu") if model == "3dof" else sixdof_path("cpu")


@pytest.mark.parametrize("kw", [{}, {"augment_rollout": False}, {"scp_iterations": 2}],
                         ids=["tape", "zero-residual", "two-scp-iterations"])
@pytest.mark.parametrize("model", MODELS)
def test_gp_mpc_solve_with_the_step_value_is_unchanged(model, kw):
    """The path's step value (main_path()'s, sixdof_path()'s) takes the
    fused route, a lambda of the same step the eager one: on the CPU both
    give the same bits, over three closed-loop cycles."""
    path = _path(model)
    cfg = path.config.replace(**kw)
    lam = lambda x, u: STEP_FN[model](path.params, x, u, DT)
    mean, var = _gp_fns(model)
    x0 = torch.tensor(_inputs(model, 3, B=6 if model == "3dof" else 4)[0])
    assert fused_rollout(path.F, cfg, x0) and not fused_rollout(lam, cfg, x0)
    states = [gp_mpc_init(cfg, x0, path.x_target, device="cpu") for _ in range(2)]
    xs = [x0, x0]
    for _ in range(3):
        sols = []
        for i, F in enumerate((path.F, lam)):
            sol, states[i] = gp_mpc_solve(F, mean, var, cfg, states[i], xs[i])
            xs[i] = path.F_true(xs[i], sol.u0)
            sols.append(sol)
        for a, b in zip(sols[0], sols[1]):
            if torch.is_tensor(a):
                assert torch.equal(a, b)
            else:
                assert a == b
        assert torch.equal(xs[0], xs[1])


def _route_case(model, case):
    p = PARAMS[model](device="cpu")
    cfg = _path(model).config
    x0 = torch.zeros(2, N_X[model])
    F = STEP[model](p, DT)
    if case in ("tape", "value"):
        return F, cfg, x0, True
    if case == "zero-residual":
        return F, cfg.replace(augment_rollout=False, rollout_gp_tape=False), x0, True
    if case == "gp-in-the-loop":
        return F, cfg.replace(rollout_gp_tape=False), x0, False
    if case == "euler":
        return STEP[model](p.replace(integrator="euler"), DT), cfg, x0, False
    if case == "lambda":
        return (lambda x, u: STEP_FN[model](p, x, u, DT)), cfg, x0, False
    if case == "float64":
        return F, cfg, x0.double(), False
    raise ValueError(case)


@pytest.mark.parametrize("case", ["tape", "zero-residual", "gp-in-the-loop", "euler", "lambda",
                                  "float64", "value"])
@pytest.mark.parametrize("model", MODELS)
def test_route_predicate(model, case):
    """A step value takes the fused route under the conditions in which
    its kernel computes what the eager route computes; every other case
    keeps the eager route. "value": each model's step value names its own
    model's kernel, not the other's."""
    F, cfg, x0, want = _route_case(model, case)
    assert fused_rollout(F, cfg, x0) is want
    assert RL.fused(F, x0) is (case not in ("lambda", "euler", "float64"))
    if case == "value":
        assert RL.kernel_name(type(F)) == KERNEL[model]
        assert KERNEL[model] in RL.LAUNCHES and set(RL.LAUNCHES) == set(KERNEL.values())


def _bad(model, what):
    step = STEP[model](PARAMS[model](device="cpu"), DT)
    x0, U, T = (torch.tensor(a) for a in _inputs(model, 4, B=2, N=4))
    if what == "x0-shape":
        x0 = x0[:, :-1]
    elif what == "x0-lanes":
        x0 = x0[:1]
    elif what == "U-shape":
        U = U[..., :2]
    elif what == "U-empty":
        U = U[:, :0]
    elif what == "tape-shape":
        T = T[:, :3]
    elif what == "x0-dtype":
        x0 = x0.double()
    elif what == "U-dtype":
        U = U.half()
    elif what == "tape-dtype":
        T = T.double()
    elif what == "contiguity":
        U = U.transpose(0, 1).contiguous().transpose(0, 1)
    elif what == "step":
        step = lambda x, u: x
    elif what == "other-model-step":  # its kernel takes the other model's widths
        other = MODELS[1 - MODELS.index(model)]
        step = STEP[other](PARAMS[other](device="cpu"), DT)
    return step, x0, U, T


@pytest.mark.parametrize("what,err", [
    ("x0-shape", ValueError), ("x0-lanes", ValueError), ("U-shape", ValueError),
    ("U-empty", ValueError), ("tape-shape", ValueError), ("x0-dtype", TypeError),
    ("U-dtype", TypeError), ("tape-dtype", TypeError), ("contiguity", ValueError),
    ("step", TypeError), ("other-model-step", ValueError)])
@pytest.mark.parametrize("model", MODELS)
def test_wrapper_checks_its_arguments(model, what, err):
    with pytest.raises(err):
        RL.rollout_linearize(*_bad(model, what))


# bytes a lane in (x0, U, the tape) and out at N = 20, in without the tape,
# and the range of the operations' time over the bytes' time at 512 lanes
BOUND = {"3dof": (828, 6748, 268, (0.3, 0.5)), "6dof": (1416, 21336, 296, (0.9, 1.0))}


@pytest.mark.parametrize("model", MODELS)
def test_bound_at_the_paths_widths(model):
    """Bytes bind at the main path's and Path D's widths: the 6-DoF
    kernel's barely, its operations taking ~94% of the bytes' time."""
    read, written, read_no_tape, (lo, hi) = BOUND[model]
    ms, by, nbytes, flops = RL.bound_ms(STEP[model], 512, 20)
    assert (by, nbytes) == ("bytes", 512 * (read + written))
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)
    assert flops == 512 * 20 * RL._KERNELS[STEP[model]].flops_per_knot
    assert lo < (flops / 67e12) / (nbytes / 3.35e12) < hi
    assert RL.bound_ms(STEP[model], 4096, 20, tape=False)[2] == 4096 * (read_no_tape + written)


@pytest.mark.parametrize("model", MODELS)
def test_model_is_packed_in_the_kernels_order(model):
    """The kernel's Model, field by field, from the step's parameters, as
    many floats as the kernel's source declares, read once per parameter
    set."""
    _, p = _params(model, _plant(model))
    m = RL._model(STEP[model](p, 0.1), 0.05)
    src = (Path(RL.__file__).parents[2] / "csrc" / f"{KERNEL[model]}.cu").read_text()
    assert len(m) == int(re.search(r"constexpr int kModelFloats = (\d+);", src).group(1))
    if model == "3dof":
        assert m[:6] == [p.alpha, -1.0, 0.0, 0.0, 0.5 * 1.0 * 1.0 * 0.1, 1e-10**2]
    else:
        assert m[:3] == [p.alpha, 1e-10**2, 0.5 * 0.8 * p.S_ref]
        np.testing.assert_array_equal(m[3:12], np.concatenate([p.g_I, p.r_T_B, p.r_cp_B]))
        np.testing.assert_array_equal(m[12:39], np.concatenate(
            [p.J_B.reshape(-1), p.J_B_inv.reshape(-1), p.C_A.reshape(-1)]))
    assert m[-4:] == [0.05, 0.1, 0.1 / 6.0, 0.05]
    assert RL._CONSTANTS[id(p)][0] is p
