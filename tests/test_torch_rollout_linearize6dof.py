"""The 6-DoF fused rollout and linearization on the CPU: the step value
``Rocket6DoFStep`` against ``rocket6dof.step``, the plain version of
``rollout_linearize6dof`` against the JAX package, the route
``gp_mpc_solve`` takes to it, and the wrapper's argument checks. The kernel
itself runs in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from gpmpc_tpu.dynamics import Rocket6DoFParams as JaxParams
from gpmpc_tpu.dynamics import rocket6dof as jr
from gpmpc_tpu.dynamics import trajectory_jacobians as jax_tj
from gpmpc_tpu_torch.dynamics import (Rocket3DoFParams, Rocket3DoFStep, Rocket6DoFParams,
                                      Rocket6DoFStep, rocket6dof as tr)
from gpmpc_tpu_torch.main_path import main_path, sixdof_path
from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve
from gpmpc_tpu_torch.mpc.gp_mpc import fused_kernel, fused_rollout
from gpmpc_tpu_torch.ops.kernels import rollout_linearize as RL3
from gpmpc_tpu_torch.ops.kernels import rollout_linearize6dof as RL

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
# Path D's plant: light aero (tests/test_torch_6dof.py's)
AERO = dict(rho=0.8, C_A=0.05 * np.eye(3, dtype=np.float32))


def _params(aero):
    jp, tp = JaxParams(), Rocket6DoFParams(device="cpu")
    if aero:
        jp = jp.replace(rho=AERO["rho"], C_A=jnp.asarray(AERO["C_A"]))
        tp = tp.replace(**AERO)
    return jp, tp


def _inputs(seed=0, B=3, N=5):
    """Descent states about Path D's (15-20 m, −2 m/s), unit quaternions
    near upright, small rates; controls about hover; a residual tape of the
    GP's lifted size (accelerations of ~0.05 on every row)."""
    rng = np.random.default_rng(seed)
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
    f32 = lambda a: a.astype(np.float32)
    return f32(x0), f32(U), f32(tape)


def _jax_rollout(jp, x0, U, tape):
    """gpmpc_tpu/mpc/gp_mpc.py's tape rollout (a zero residual without a
    tape), then its trajectory_jacobians, for each lane."""

    def lane(x0, U, tape):
        def body(x, inp):
            u, mu = inp
            xn = jr.step(jp, x, u, DT) + DT * mu
            return xn, xn

        _, Xr = jax.lax.scan(body, x0, (U, tape))
        X = jnp.concatenate([x0[None], Xr], axis=0)
        return (X, *jax_tj(lambda x, u: jr.step(jp, x, u, DT), X, U))

    return jax.vmap(lane)(x0, U, tape)


@pytest.mark.parametrize("aero", [False, True], ids=["nominal", "aero"])
def test_step_value_is_the_step(aero):
    _, p = _params(aero)
    F = Rocket6DoFStep(p, DT)
    lam = lambda x, u: tr.step(p, x, u, DT)
    x0, U, _ = _inputs()
    x, u = torch.tensor(x0), torch.tensor(U[:, 0])
    assert torch.equal(F(x, u), tr.step(p, x, u, DT))
    J = vmap(jacfwd(F, argnums=(0, 1)))(x, u)
    J_lam = vmap(jacfwd(lam, argnums=(0, 1)))(x, u)
    assert all(torch.equal(a, b) for a, b in zip(J, J_lam))
    assert F == Rocket6DoFStep(p, DT) and hash(F) == hash(Rocket6DoFStep(p, DT))


@pytest.mark.parametrize("tape", [True, False], ids=["tape", "zero-residual"])
@pytest.mark.parametrize("aero", [False, True], ids=["nominal", "aero"])
def test_plain_version_matches_jax(aero, tape):
    """Tolerances of tests/test_torch_6dof.py: the states to rtol 1e-5,
    atol 1e-5 (the renormalised step's), the Jacobians and c to 1e-4."""
    jp, tp = _params(aero)
    step = Rocket6DoFStep(tp, DT)
    x0, U, T = _inputs(1)
    ref = _jax_rollout(jp, x0, U, T if tape else np.zeros_like(T))
    out = RL.rollout_linearize6dof_plain(step, torch.tensor(x0), torch.tensor(U),
                                         torch.tensor(T) if tape else None)
    np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=1e-5, atol=1e-5)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tape", [True, False], ids=["tape", "zero-residual"])
def test_wrapper_on_the_cpu_is_the_plain_version(tape):
    step = Rocket6DoFStep(_params(True)[1], DT)
    x0, U, T = (torch.tensor(a) for a in _inputs(2, B=4, N=20))
    T = T if tape else None
    before = RL.LAUNCHES
    got = RL.rollout_linearize6dof(step, x0, U, T)
    want = RL.rollout_linearize6dof_plain(step, x0, U, T)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [tuple(t.shape) for t in got] == [(4, 21, 14), (4, 20, 14, 14), (4, 20, 14, 3),
                                             (4, 20, 14)]
    assert RL.LAUNCHES == before  # a CPU tensor runs the plain version


def _gp_fns():
    """A smooth stand-in for the two-GP residual: small state-dependent
    means on the velocity and rate rows, constant variances (n_gp = 6)."""
    def mean(X, U):
        out = torch.zeros_like(X)
        out[..., 4:7] = 0.05 * torch.tanh(0.1 * X[..., 4:7] + 0.01 * U)
        out[..., 11:14] = 0.02 * torch.tanh(X[..., 11:14] + 0.01 * U)
        return out

    return mean, lambda X, U: torch.full((*X.shape[:-1], 6), 1e-3)


@pytest.mark.parametrize("kw", [{}, {"augment_rollout": False}, {"scp_iterations": 2}],
                         ids=["tape", "zero-residual", "two-scp-iterations"])
def test_gp_mpc_solve_with_the_step_value_is_unchanged(kw):
    """sixdof_path()'s step value takes the fused route, a lambda of the
    same step the eager one: on the CPU both give the same bits, over three
    closed-loop cycles."""
    sp = sixdof_path("cpu")
    cfg = sp.config.replace(**kw)
    lam = lambda x, u: tr.step(sp.params, x, u, DT)
    mean, var = _gp_fns()
    x0 = torch.tensor(_inputs(3, B=4)[0])
    assert fused_rollout(sp.F, cfg, x0) and not fused_rollout(lam, cfg, x0)
    states = [gp_mpc_init(cfg, x0, sp.x_target, device="cpu") for _ in range(2)]
    xs = [x0, x0]
    for _ in range(3):
        sols = []
        for i, F in enumerate((sp.F, lam)):
            sol, states[i] = gp_mpc_solve(F, mean, var, cfg, states[i], xs[i])
            xs[i] = sp.F_true(xs[i], sol.u0)
            sols.append(sol)
        for a, b in zip(sols[0], sols[1]):
            if torch.is_tensor(a):
                assert torch.equal(a, b)
            else:
                assert a == b
        assert torch.equal(xs[0], xs[1])


def _route_case(case):
    p = Rocket6DoFParams(device="cpu")
    cfg = sixdof_path("cpu").config
    x0 = torch.zeros(2, 14)
    F = Rocket6DoFStep(p, DT)
    if case == "tape":
        return F, cfg, x0, RL.rollout_linearize6dof
    if case == "zero-residual":
        return F, cfg.replace(augment_rollout=False, rollout_gp_tape=False), x0, \
            RL.rollout_linearize6dof
    if case == "gp-in-the-loop":
        return F, cfg.replace(rollout_gp_tape=False), x0, None
    if case == "euler":
        return Rocket6DoFStep(p.replace(integrator="euler"), DT), cfg, x0, None
    if case == "lambda":
        return (lambda x, u: tr.step(p, x, u, DT)), cfg, x0, None
    if case == "float64":
        return F, cfg, x0.double(), None
    if case == "3dof-value":
        return (Rocket3DoFStep(Rocket3DoFParams(device="cpu"), DT), main_path("cpu").config,
                torch.zeros(2, 7), RL3.rollout_linearize)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["tape", "zero-residual", "gp-in-the-loop", "euler", "lambda",
                                  "float64", "3dof-value"])
def test_route_predicate(case):
    """Each step value goes to its own kernel's wrapper (the 3-DoF one to
    the 3-DoF kernel), under the conditions the eager route computes the
    same thing; every other case keeps the eager route."""
    F, cfg, x0, want = _route_case(case)
    assert fused_rollout(F, cfg, x0) is (want is not None)
    if want is not None:
        assert fused_kernel(F) is want


def _bad(what):
    step = Rocket6DoFStep(Rocket6DoFParams(device="cpu"), DT)
    x0, U, T = (torch.tensor(a) for a in _inputs(4, B=2, N=4))
    if what == "x0-shape":
        x0 = x0[:, :7]
    elif what == "x0-lanes":
        x0 = x0[:1]
    elif what == "U-shape":
        U = U[..., :2]
    elif what == "U-empty":
        U = U[:, :0]
    elif what == "tape-shape":
        T = T[..., :7]
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
    elif what == "3dof-step":
        step = Rocket3DoFStep(Rocket3DoFParams(device="cpu"), DT)
    return step, x0, U, T


@pytest.mark.parametrize("what,err", [
    ("x0-shape", ValueError), ("x0-lanes", ValueError), ("U-shape", ValueError),
    ("U-empty", ValueError), ("tape-shape", ValueError), ("x0-dtype", TypeError),
    ("U-dtype", TypeError), ("tape-dtype", TypeError), ("contiguity", ValueError),
    ("step", TypeError), ("3dof-step", TypeError)])
def test_wrapper_checks_its_arguments(what, err):
    with pytest.raises(err):
        RL.rollout_linearize6dof(*_bad(what))


def test_bound_at_path_d_widths():
    """1,416 bytes in and 21,336 out a lane at N = 20 with a tape; bytes
    bind, barely: the operations take ~94% of the bytes' time."""
    ms, by, nbytes, flops = RL.bound_ms(512, 20)
    assert (by, nbytes) == ("bytes", 512 * (1416 + 21336))
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)
    assert flops == 512 * 20 * RL.FLOPS_PER_KNOT
    assert 0.9 < (flops / 67e12) / (nbytes / 3.35e12) < 1.0
    assert RL.bound_ms(4096, 20, tape=False)[2] == 4096 * (296 + 21336)


def test_model_is_packed_in_the_kernels_order():
    """The kernel's Model, field by field, from the step's parameters: 43
    floats, read from the device once per parameter set."""
    _, p = _params(True)
    m = RL._model(Rocket6DoFStep(p, 0.1), 0.05)
    assert len(m) == 43
    assert m[:3] == [p.alpha, 1e-10**2, 0.5 * 0.8 * p.S_ref]
    np.testing.assert_array_equal(m[3:12], np.concatenate([p.g_I, p.r_T_B, p.r_cp_B]))
    np.testing.assert_array_equal(m[12:39], np.concatenate(
        [p.J_B.reshape(-1), p.J_B_inv.reshape(-1), p.C_A.reshape(-1)]))
    assert m[39:] == [0.05, 0.1, 0.1 / 6.0, 0.05]
    assert RL._CONSTANTS[id(p)][0] is p
