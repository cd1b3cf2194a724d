"""The port's ADMM chunk (gpmpc_tpu_torch/ops/kernels/admm_chunk.py) against
the JAX Pallas kernels in interpret mode, on the CPU.

Tolerances are tests/test_pallas.py's: atol 3e-4 on x and z, 2e-3 on y
(duals on ρ-boosted equality rows amplify f32 reordering noise). The CUDA
kernel itself is compared with the plain version on the card by
chip_smoke.py and by tests/test_torch_cuda.py.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops.pallas.admm_kernel import admm_chunk as jax_admm_chunk
from gpmpc_tpu.ops.pallas.admm_kernel import make_admm_chunk_lanes
from gpmpc_tpu.ops.qp import admm as JA
from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

sys.path.insert(0, "tests")
from test_qp import random_qp  # noqa: E402

ATOL_XZ, ATOL_Y = 3e-4, 2e-3


def _lane(seed, n=12, m=18):
    data = random_qp(np.random.default_rng(seed), n=n, m=m, eq_rows=4)
    rho_v = JA._rho_vec(data.l, data.u, jnp.asarray(0.1))
    Minv = JA._factor(data.P, data.A, rho_v, 1e-6)
    rng = np.random.default_rng(100 + seed)
    x = jnp.asarray(rng.normal(size=n) * 0.1, jnp.float32)
    z = data.A @ x
    y = jnp.asarray(rng.normal(size=m) * 0.01, jnp.float32)
    return (Minv, data.A, data.q, data.l, data.u, rho_v, x, z, y)


def _batch(seeds):
    lanes = [_lane(s) for s in seeds]
    return [np.stack([np.asarray(l[i]) for l in lanes]) for i in range(9)]


def _torch(args):
    return [torch.tensor(a) for a in args]


@pytest.mark.parametrize("iters", [1, 10])
def test_plain_matches_pallas_admm_chunk(iters):
    args = _batch(range(3))
    xt, zt, yt = K.admm_chunk_plain(*_torch(args), iters=iters, sigma=1e-6, alpha=1.6)
    for b in range(3):
        xj, zj, yj = jax_admm_chunk(*[jnp.asarray(a[b]) for a in args], iters=iters,
                                    sigma=1e-6, alpha=1.6, interpret=True)
        np.testing.assert_allclose(xt[b].numpy(), xj, atol=ATOL_XZ)
        np.testing.assert_allclose(zt[b].numpy(), zj, atol=ATOL_XZ)
        np.testing.assert_allclose(yt[b].numpy(), yj, atol=ATOL_Y)


def test_plain_matches_vmapped_lanes_kernel():
    args = _batch(range(4))
    chunk = make_admm_chunk_lanes(8, 1e-6, 1.6, interpret=True)
    xj, zj, yj = jax.jit(jax.vmap(chunk))(*[jnp.asarray(a) for a in args])
    xt, zt, yt = K.admm_chunk_plain(*_torch(args), iters=8, sigma=1e-6, alpha=1.6)
    np.testing.assert_allclose(xt.numpy(), xj, atol=ATOL_XZ)
    np.testing.assert_allclose(zt.numpy(), zj, atol=ATOL_XZ)
    np.testing.assert_allclose(yt.numpy(), yj, atol=ATOL_Y)


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    args = _torch(_batch(range(2)))
    before = K.LAUNCHES
    out = K.admm_chunk(*args, iters=5, sigma=1e-6, alpha=1.6)
    ref = K.admm_chunk_plain(*args, iters=5, sigma=1e-6, alpha=1.6)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert K.LAUNCHES == before  # the counter counts kernel launches only


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrapper_rejects_bad_operands(bad):
    args = _torch(_batch(range(2)))
    if bad == "shape":
        args[2] = args[2][:, :-1]
        with pytest.raises(ValueError, match="q must be"):
            K.admm_chunk(*args, iters=1, sigma=1e-6, alpha=1.6)
    else:
        args[0] = args[0].double()
        with pytest.raises(TypeError, match="float32"):
            K.admm_chunk(*args, iters=1, sigma=1e-6, alpha=1.6)


def test_pallas_available_false_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert not K.pallas_available()
    assert not K.pallas_available("cpu")
