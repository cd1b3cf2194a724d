"""The CUDA chunk kernel against its plain PyTorch version, on the card.

Marked ``cuda``: without a Hopper device every test skips. The module
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Tolerances are tests/test_pallas.py's (atol 3e-4 on x and z, 2e-3 on y),
taken around a float64 run of the plain version and widened by how far the
float32 plain version itself lands from it: on ρ-boosted equality rows f32
reordering noise alone moves the duals by up to 3.3e-3 after 50 iterations.
"""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.ops.kernels import admm_chunk as K
from gpmpc_tpu_torch.ops.qp import QPData, ruiz_equilibrate
from gpmpc_tpu_torch.ops.qp.admm import _factor, _rho_vec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not K.pallas_available():
        pytest.skip("needs a Hopper (sm_90) CUDA device; run on the card")
    return torch.device("cuda")


def _chunk_args(B, n, m, dense, dev, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    P = G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    A = rng.normal(size=(B, m, n)) if dense else np.tile(np.eye(m, n), (B, 1, 1))
    lo = -np.abs(rng.normal(size=(B, m))) - 0.5
    hi = np.abs(rng.normal(size=(B, m))) + 0.5
    lo[:, :2] = hi[:, :2] = 0.3  # equality rows: ρ boosted ×1e3
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    sd, _ = ruiz_equilibrate(QPData(P=t(P), q=t(rng.normal(size=(B, n))), A=t(A),
                                    l=t(lo), u=t(hi)), 2)
    rho = _rho_vec(sd.l, sd.u, torch.full((B,), 0.1, device=dev))
    Minv = _factor(sd.P, sd.A, rho, 1e-6)
    x = t(0.1 * rng.normal(size=(B, n)))
    z = torch.bmm(sd.A, x[:, :, None])[:, :, 0]
    y = t(0.01 * rng.normal(size=(B, m)))
    return [Minv, sd.A.contiguous(), sd.q, sd.l, sd.u, rho, x, z, y]


@pytest.mark.parametrize("B,n,m,dense,iters", [
    (4, 12, 18, True, 25),      # test_pallas.py's random-QP shape
    (64, 60, 60, False, 50),    # the main path: identity control rows
    (16, 60, 60, True, 50),     # dense at the main-path size
    (3, 100, 700, True, 10),    # too big for shared memory: global variant
])
def test_kernel_matches_plain_version(cuda_device, B, n, m, dense, iters):
    args = _chunk_args(B, n, m, dense, cuda_device)
    before = K.LAUNCHES
    kern = K.admm_chunk(*args, iters=iters, sigma=1e-6, alpha=1.6)
    plain = K.admm_chunk_plain(*args, iters=iters, sigma=1e-6, alpha=1.6)
    ref = K.admm_chunk_plain(*[a.double() for a in args], iters=iters, sigma=1e-6, alpha=1.6)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    for k, p, r, atol in zip(kern, plain, ref, (3e-4, 3e-4, 2e-3)):
        f32_noise = (p.double() - r).abs().max().item()
        torch.testing.assert_close(k.double(), r, rtol=0, atol=atol + f32_noise)


def test_kernel_picks_the_global_variant_when_smem_is_short(cuda_device):
    assert K.smem_variant(60, 60) == 1
    assert K.smem_variant(207, 354) == 0


def test_wrapper_leaves_inputs_untouched(cuda_device):
    args = _chunk_args(8, 20, 30, True, cuda_device)
    saved = [a.clone() for a in args]
    K.admm_chunk(*args, iters=5, sigma=1e-6, alpha=1.6)
    torch.cuda.synchronize()
    for a, b in zip(args, saved):
        assert torch.equal(a, b)
