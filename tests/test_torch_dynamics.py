"""The port's 3-DoF dynamics and Jacobians against the JAX package, and
``trajectory_jacobians`` against central differences."""

import jax
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams
from gpmpc_tpu.dynamics import rocket3dof as jr
from gpmpc_tpu.dynamics import trajectory_jacobians as jax_tj
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr, trajectory_jacobians

DT = 0.1
DRAG = dict(rho=1.0, C_D=1.0, A_ref=0.1)


def _knots(seed=0, B=3, N=5):
    rng = np.random.default_rng(seed)
    X = (np.array([2, 20, 0, 0, -3, 0, 0]) + 0.5 * rng.normal(size=(B, N + 1, 7))).astype(np.float32)
    U = (np.array([2, 0, 0]) + 0.3 * rng.normal(size=(B, N, 3))).astype(np.float32)
    return X, U


@pytest.mark.parametrize("drag", [False, True])
@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_step_matches_jax(drag, integrator):
    kw = dict(DRAG) if drag else {}
    jp = JaxParams(integrator=integrator).replace(**kw)
    tp = Rocket3DoFParams(integrator=integrator, device="cpu", **kw)
    X, U = _knots()
    x, u = X[:, 0], U[:, 0]
    ref = jax.vmap(lambda a, b: jr.step(jp, a, b, DT))(x, u)
    out = tr.step(tp, torch.tensor(x), torch.tensor(u), DT)
    # same f32 arithmetic in the same order
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("drag", [False, True])
def test_trajectory_jacobians_match_jax(drag):
    kw = dict(DRAG) if drag else {}
    jp = JaxParams().replace(**kw)
    tp = Rocket3DoFParams(device="cpu", **kw)
    X, U = _knots()
    ref = jax.vmap(lambda a, b: jax_tj(lambda x, u: jr.step(jp, x, u, DT), a, b))(X, U)
    out = trajectory_jacobians(lambda x, u: tr.step(tp, x, u, DT), torch.tensor(X), torch.tensor(U))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-6)


def test_trajectory_jacobians_match_central_differences():
    tp = Rocket3DoFParams(device="cpu", **DRAG)
    F = lambda x, u: tr.step(tp, x, u, DT)
    X, U = _knots(1, B=2, N=3)
    A, Bm, c = trajectory_jacobians(F, torch.tensor(X), torch.tensor(U))
    eps = 1e-5
    for b in range(2):
        for k in range(3):
            # the step in float64 (g_I promotes), differenced centrally
            x = torch.tensor(X[b, k], dtype=torch.float64)
            u = torch.tensor(U[b, k], dtype=torch.float64)
            Anum = torch.stack([(F(x + eps * e, u) - F(x - eps * e, u)) / (2 * eps)
                                for e in torch.eye(7, dtype=torch.float64)], dim=1)
            Bnum = torch.stack([(F(x, u + eps * e) - F(x, u - eps * e)) / (2 * eps)
                                for e in torch.eye(3, dtype=torch.float64)], dim=1)
            # f32 forward-mode AD against an f64 central difference
            np.testing.assert_allclose(A[b, k].numpy(), Anum.numpy(), atol=1e-5)
            np.testing.assert_allclose(Bm[b, k].numpy(), Bnum.numpy(), atol=1e-5)
            # the affine model reproduces the step at the knot
            xf, uf = torch.tensor(X[b, k]), torch.tensor(U[b, k])
            np.testing.assert_allclose((A[b, k] @ xf + Bm[b, k] @ uf + c[b, k]).numpy(),
                                       F(xf, uf).numpy(), atol=1e-5)


def test_thrust_helpers_match_jax():
    jp = JaxParams()
    tp = Rocket3DoFParams(device="cpu")
    rng = np.random.default_rng(2)
    U = (rng.normal(size=(6, 3)) * 4).astype(np.float32)
    U[0] = 0.0  # the zero-thrust guard
    ref = jax.vmap(lambda u: jr.clamp_thrust(jp, u))(U)
    np.testing.assert_allclose(tr.clamp_thrust(tp, torch.tensor(U)).numpy(), ref, rtol=1e-6, atol=1e-7)
    X, _ = _knots()
    np.testing.assert_allclose(tr.hover_thrust(tp, torch.tensor(X[:, 0])).numpy(),
                               jax.vmap(lambda x: jr.hover_thrust(jp, x))(X[:, 0]))


def test_cuda_device_requires_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Rocket3DoFParams()
