"""The fused rollout and linearization on the CPU: the step value
``Rocket3DoFStep`` against ``rocket3dof.step``, the plain version of
``rollout_linearize`` against the JAX package, the route ``gp_mpc_solve``
takes to it, and the wrapper's argument checks. The kernel itself runs in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams
from gpmpc_tpu.dynamics import rocket3dof as jr
from gpmpc_tpu.dynamics import trajectory_jacobians as jax_tj
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, Rocket3DoFStep, rocket3dof as tr
from gpmpc_tpu_torch.main_path import main_path
from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve
from gpmpc_tpu_torch.mpc.gp_mpc import fused_rollout
from gpmpc_tpu_torch.ops.kernels import rollout_linearize as RL

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
DRAG = dict(rho=1.0, C_D=1.0, A_ref=0.1)


def _inputs(seed=0, B=3, N=5):
    """States around the main path's (30 m, −3 m/s), controls around hover,
    a residual tape of the GP's size (lifted accelerations of ~0.1)."""
    rng = np.random.default_rng(seed)
    x0 = (np.array([2, 30, 0, 0, -3, 0, 0]) + 0.5 * rng.normal(size=(B, 7))).astype(np.float32)
    U = (np.array([2, 0, 0]) + 0.3 * rng.normal(size=(B, N, 3))).astype(np.float32)
    tape = (0.1 * rng.normal(size=(B, N, 7))).astype(np.float32)
    return x0, U, tape


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


@pytest.mark.parametrize("drag", [False, True])
def test_step_value_is_the_step(drag):
    p = Rocket3DoFParams(device="cpu", **(DRAG if drag else {}))
    F = Rocket3DoFStep(p, DT)
    lam = lambda x, u: tr.step(p, x, u, DT)
    x0, U, _ = _inputs()
    x, u = torch.tensor(x0), torch.tensor(U[:, 0])
    assert torch.equal(F(x, u), tr.step(p, x, u, DT))
    J = vmap(jacfwd(F, argnums=(0, 1)))(x, u)
    J_lam = vmap(jacfwd(lam, argnums=(0, 1)))(x, u)
    assert all(torch.equal(a, b) for a, b in zip(J, J_lam))
    assert F == Rocket3DoFStep(p, DT) and hash(F) == hash(Rocket3DoFStep(p, DT))


@pytest.mark.parametrize("tape", [True, False], ids=["tape", "zero-residual"])
@pytest.mark.parametrize("drag", [False, True])
def test_plain_version_matches_jax(drag, tape):
    """Tolerances of tests/test_torch_dynamics.py: the step to 1e-6, the
    Jacobians to rtol 1e-5, atol 1e-6; the states over 5 knots carry 30 m
    of altitude, so they take the step's 1e-6 relative to it."""
    kw = dict(DRAG) if drag else {}
    jp = JaxParams().replace(**kw)
    step = Rocket3DoFStep(Rocket3DoFParams(device="cpu", **kw), DT)
    x0, U, T = _inputs(1)
    ref = _jax_rollout(jp, x0, U, T if tape else np.zeros_like(T))
    out = RL.rollout_linearize_plain(step, torch.tensor(x0), torch.tensor(U),
                                     torch.tensor(T) if tape else None)
    np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=1e-6, atol=1e-6)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tape", [True, False], ids=["tape", "zero-residual"])
def test_wrapper_on_the_cpu_is_the_plain_version(tape):
    step = Rocket3DoFStep(Rocket3DoFParams(device="cpu", **DRAG), DT)
    x0, U, T = (torch.tensor(a) for a in _inputs(2, B=4, N=20))
    T = T if tape else None
    before = RL.LAUNCHES
    got = RL.rollout_linearize(step, x0, U, T)
    want = RL.rollout_linearize_plain(step, x0, U, T)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [tuple(t.shape) for t in got] == [(4, 21, 7), (4, 20, 7, 7), (4, 20, 7, 3), (4, 20, 7)]
    assert RL.LAUNCHES == before  # a CPU tensor runs the plain version


def _gp_fns():
    """A smooth stand-in for the GP: a small state-dependent mean on the
    velocity rows, constant variances (n_gp = 3)."""
    def mean(X, U):
        out = torch.zeros_like(X)
        out[..., 4:7] = 0.05 * torch.tanh(0.1 * X[..., 4:7] + 0.01 * U)
        return out

    return mean, lambda X, U: torch.full((*X.shape[:-1], 3), 1e-3)


@pytest.mark.parametrize("kw", [{}, {"augment_rollout": False}, {"scp_iterations": 2}],
                         ids=["tape", "zero-residual", "two-scp-iterations"])
def test_gp_mpc_solve_with_the_step_value_is_unchanged(kw):
    """main_path()'s step value takes the fused route, a lambda of the same
    step the eager one: on the CPU both give the same bits, over three
    closed-loop cycles."""
    mp = main_path("cpu")
    cfg = mp.config.replace(**kw)
    lam = lambda x, u: tr.step(mp.params, x, u, DT)
    mean, var = _gp_fns()
    x0, _, _ = _inputs(3, B=6)
    x0 = torch.tensor(x0)
    assert fused_rollout(mp.F, cfg, x0) and not fused_rollout(lam, cfg, x0)
    states = [gp_mpc_init(cfg, x0, mp.x_target, device="cpu") for _ in range(2)]
    xs = [x0, x0]
    for _ in range(3):
        sols = []
        for i, F in enumerate((mp.F, lam)):
            sol, states[i] = gp_mpc_solve(F, mean, var, cfg, states[i], xs[i])
            xs[i] = mp.F_true(xs[i], sol.u0)
            sols.append(sol)
        for a, b in zip(sols[0], sols[1]):
            if torch.is_tensor(a):
                assert torch.equal(a, b)
            else:
                assert a == b
        assert torch.equal(xs[0], xs[1])


def _route_case(case):
    p = Rocket3DoFParams(device="cpu")
    cfg = main_path("cpu").config
    x0 = torch.zeros(2, 7)
    F = Rocket3DoFStep(p, DT)
    if case == "tape":
        return F, cfg, x0, True
    if case == "zero-residual":
        return F, cfg.replace(augment_rollout=False, rollout_gp_tape=False), x0, True
    if case == "gp-in-the-loop":
        return F, cfg.replace(rollout_gp_tape=False), x0, False
    if case == "euler":
        return Rocket3DoFStep(p.replace(integrator="euler"), DT), cfg, x0, False
    if case == "lambda":
        return (lambda x, u: tr.step(p, x, u, DT)), cfg, x0, False
    if case == "float64":
        return F, cfg, x0.double(), False
    raise ValueError(case)


@pytest.mark.parametrize("case", ["tape", "zero-residual", "gp-in-the-loop", "euler", "lambda",
                                  "float64"])
def test_route_predicate(case):
    F, cfg, x0, want = _route_case(case)
    assert fused_rollout(F, cfg, x0) is want


def _bad(what):
    step = Rocket3DoFStep(Rocket3DoFParams(device="cpu"), DT)
    x0, U, T = (torch.tensor(a) for a in _inputs(4, B=2, N=4))
    if what == "x0-shape":
        x0 = x0[:, :6]
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
    return step, x0, U, T


@pytest.mark.parametrize("what,err", [
    ("x0-shape", ValueError), ("x0-lanes", ValueError), ("U-shape", ValueError),
    ("U-empty", ValueError), ("tape-shape", ValueError), ("x0-dtype", TypeError),
    ("U-dtype", TypeError), ("tape-dtype", TypeError), ("contiguity", ValueError),
    ("step", TypeError)])
def test_wrapper_checks_its_arguments(what, err):
    with pytest.raises(err):
        RL.rollout_linearize(*_bad(what))


def test_bound_at_the_main_path_widths():
    """828 bytes in and 6,748 out a lane at N = 20 with a tape; bytes bind."""
    ms, by, nbytes, flops = RL.bound_ms(512, 20)
    assert (by, nbytes) == ("bytes", 512 * (828 + 6748))
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)
    assert flops == 512 * 20 * RL.FLOPS_PER_KNOT
    assert RL.bound_ms(4096, 20, tape=False)[2] == 4096 * (268 + 6748)
