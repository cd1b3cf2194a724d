"""The port's QP layer (gpmpc_tpu_torch/ops/qp) against the JAX package on
the CPU: Ruiz scaling, the condensed and sparse-form QP assembly, and the
batched ADMM solve (every row segment kind, infeasibility certificates,
polish) on random QPs and the golden sparse-form fixtures."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops.qp import admm as JA
from gpmpc_tpu.ops.qp import condensed as JC
from gpmpc_tpu.ops.qp import ruiz as JR
from gpmpc_tpu.ops.qp import mpc_qp as JM
from gpmpc_tpu.ops.qp.mpc_qp import split_z as jax_split_z
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.ops.qp import QPData, admm as TA, condensed as TC, mpc_qp as TM, ruiz as TR
from gpmpc_tpu_torch.ops.qp import join_z, split_z

sys.path.insert(0, "tests")
from test_qp import random_qp  # noqa: E402

torch.set_num_threads(1)  # the suite's xdist workers share the cores

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "qp_golden.npz")
SCENARIOS = ("canonical", "high_fast", "low_slow", "lateral")


def _stack(datas):
    return QPData(*[torch.tensor(np.stack([np.asarray(getattr(d, k)) for d in datas]))
                    for k in ("P", "q", "A", "l", "u")])


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_ruiz_matches_jax():
    datas = [random_qp(np.random.default_rng(s)) for s in range(3)]
    sd, sc = TR.ruiz_equilibrate(_stack(datas), 10)
    for b, d in enumerate(datas):
        jd, jsc = JR.ruiz_equilibrate(d, 10)
        # f32 products of a few scaling factors: a few ulps
        for k in ("P", "q", "A", "l", "u"):
            np.testing.assert_allclose(getattr(sd, k)[b].numpy(), getattr(jd, k),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sc.D[b].numpy(), jsc.D, rtol=1e-5)
        np.testing.assert_allclose(sc.E[b].numpy(), jsc.E, rtol=1e-5)
        np.testing.assert_allclose(sc.c[b].item(), float(jsc.c), rtol=1e-5)


def test_rho_vec_and_factor_match_jax():
    datas = [random_qp(np.random.default_rng(s)) for s in range(3)]
    td = _stack(datas)
    rv = TA._rho_vec(td.l, td.u, torch.full((3,), 0.1))
    Minv = TA._factor(td.P, td.A, rv, 1e-6)
    for b, d in enumerate(datas):
        jrv = JA._rho_vec(d.l, d.u, jnp.asarray(0.1))
        np.testing.assert_array_equal(rv[b].numpy(), jrv)
        jM = JA._factor(d.P, d.A, jrv, 1e-6)
        # two f32 Cholesky implementations: relative error of the inverse
        # ~ cond(M)·eps; 1e-4 of its largest entry
        np.testing.assert_allclose(Minv[b].numpy(), jM, atol=1e-4 * float(jnp.abs(jM).max()))


def test_factor_marks_indefinite_lanes_nan():
    P = torch.stack([torch.eye(3), -torch.eye(3)])
    A = torch.zeros(2, 1, 3)
    Minv = TA._factor(P, A, torch.ones(2, 1), 0.0)
    assert bool(torch.isfinite(Minv[0]).all())
    assert bool(torch.isnan(Minv[1]).all())


@pytest.mark.parametrize("mode", ["off", "auto"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_solve_matches_jax_off(mode, adaptive):
    datas = [random_qp(np.random.default_rng(s)) for s in range(4)]
    jcfg = JA.ADMMConfig(max_iter=100, use_pallas="off", infeas_certs=False,
                         adaptive_rho=adaptive)
    tcfg = convert.admm_config_from_fields(_fields(jcfg)).replace(use_pallas=mode)
    ts = TA.solve(_stack(datas), config=tcfg)
    js = [JA.solve(d, config=jcfg) for d in datas]
    # f32 Cholesky/reduction order differs between the frameworks; over 100
    # iterations the iterates stay within 5e-4 (test_pallas.py's lanes-vs-off
    # bound for the full solve)
    np.testing.assert_allclose(ts.x.numpy(), np.stack([s.x for s in js]), atol=5e-4)
    np.testing.assert_allclose(ts.obj.numpy(), np.stack([s.obj for s in js]), rtol=1e-4, atol=1e-4)
    if not adaptive:
        # fixed ρ: no discrete ρ decisions to flip, so the schedule is identical
        np.testing.assert_array_equal(ts.status.numpy(), [int(s.status) for s in js])
        np.testing.assert_array_equal(ts.iterations.numpy(), [int(s.iterations) for s in js])


def test_solve_warm_start_and_rho0_match_jax():
    datas = [random_qp(np.random.default_rng(s)) for s in range(3)]
    rng = np.random.default_rng(9)
    x0 = rng.normal(size=(3, 12)).astype(np.float32)
    y0 = rng.normal(size=(3, 18)).astype(np.float32) * 0.1
    rho0 = np.array([0.05, 0.1, 0.3], np.float32)
    jcfg = JA.ADMMConfig(max_iter=50, check_interval=25, use_pallas="off",
                         infeas_certs=False, adaptive_rho=False, scaling=2)
    tcfg = convert.admm_config_from_fields(_fields(jcfg))
    ts = TA.solve(_stack(datas), torch.tensor(x0), torch.tensor(y0), tcfg,
                  rho0=torch.tensor(rho0))
    for b, d in enumerate(datas):
        js = JA.solve(d, jnp.asarray(x0[b]), jnp.asarray(y0[b]), jcfg, rho0=jnp.asarray(rho0[b]))
        np.testing.assert_allclose(ts.x[b].numpy(), js.x, atol=5e-4)
        np.testing.assert_allclose(ts.y[b].numpy(), js.y, atol=5e-3)
        assert int(ts.status[b]) == int(js.status)


def test_fixed_scaling_matches_jax():
    datas = [random_qp(np.random.default_rng(s)) for s in range(2)]
    jcfg = JA.ADMMConfig(max_iter=100, use_pallas="off", infeas_certs=False,
                         adaptive_rho=False)
    tcfg = convert.admm_config_from_fields(_fields(jcfg))
    td = _stack(datas)
    _, sc = TR.ruiz_equilibrate(td, 3)
    ts = TA.solve(td, config=tcfg, fixed_scaling=sc)
    for b, d in enumerate(datas):
        jsc = JR.Scaling(D=jnp.asarray(sc.D[b].numpy()), E=jnp.asarray(sc.E[b].numpy()),
                         c=jnp.asarray(sc.c[b].item()))
        js = JA.solve(d, config=jcfg, fixed_scaling=jsc)
        np.testing.assert_allclose(ts.x[b].numpy(), js.x, atol=5e-4)


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_golden_fixtures_match_certified_optimum(mode):
    """The four sparse-form golden QPs (n=207, m=354) solved in one batch at
    the JAX test's settings (tests/test_qp.py: 400 iterations, polish on).
    The polish lands both packages within 1e-3 of the certified optimum
    x_star's u0, the JAX test's bound, and so within 2e-3 of each other."""
    fx = np.load(FIXTURE)
    data = QPData(*[torch.tensor(np.stack([fx[f"{s}/{p}"] for s in SCENARIOS]),
                                 dtype=torch.float32) for p in ("P", "q", "A", "l", "u")])
    cfg = TA.ADMMConfig(max_iter=400, polish=True, use_pallas=mode)
    sol = TA.solve(data, config=cfg)
    _, U = split_z(sol.x, 20, 7, 3)
    for b, s in enumerate(SCENARIOS):
        jd = JA.QPData(*[jnp.asarray(fx[f"{s}/{p}"], jnp.float32) for p in ("P", "q", "A", "l", "u")])
        jsol = JA.solve(jd, config=JA.ADMMConfig(max_iter=400, polish=True, use_pallas="off"))
        _, U_j = jax_split_z(jsol.x, 20, 7, 3)
        _, U_star = jax_split_z(jnp.asarray(fx[f"{s}/x_star"], jnp.float32), 20, 7, 3)
        assert int(sol.status[b]) == TA.SOLVED or float(sol.pri_res[b]) < 1e-2
        np.testing.assert_allclose(U[b, 0].numpy(), U_star[0], atol=1e-3)
        np.testing.assert_allclose(np.asarray(U_j[0]), U_star[0], atol=1e-3)
        np.testing.assert_allclose(U[b, 0].numpy(), U_j[0], atol=2e-3)


def test_chunk_guard_is_two_sided():
    data = _stack([random_qp(np.random.default_rng(0))])
    for mi, ci in ((80, 50), (20, 25)):
        cfg = TA.ADMMConfig(max_iter=mi, check_interval=ci, infeas_certs=False)
        with pytest.raises(ValueError, match="must be a multiple"):
            TA.solve(data, config=cfg)


@pytest.mark.parametrize("kw", [
    {"matvec_dtype": "bf16"}, {"tail_f32_iters": 25},
    {"matvec_dtype": "bf16", "tail_f32_iters": 25},
])
def test_features_outside_the_slice_raise(kw):
    """The bf16 stream and its f32 tail are ported now, with the JAX
    package's rule for each mode: on the streamed path (``"off"``) the solve
    follows JAX's (a tail without bf16 runs nothing, as in JAX); on a kernel
    mode the chunk applies the f32 A, so bf16 changes nothing and a bf16
    tail raises, as JAX's Pallas modes do. The QP is ``tests/test_qp.py``'s
    bf16 one (seed 0): on QPs where the bf16 iteration is not contractive
    (seeds 1 and 2) both packages diverge, and the rounding of the vector
    to bf16 turns one ulp of f32 reordering into a whole bf16 step, so the
    two runs part by 3e-4 and 3e-3 after two iterations."""
    datas = [random_qp(np.random.default_rng(0))]
    base = {"max_iter": 25, "infeas_certs": False}
    jcfg = JA.ADMMConfig(**{**base, **kw}, use_pallas="off")
    tcfg = convert.admm_config_from_fields(_fields(jcfg))
    ts = TA.solve(_stack(datas), config=tcfg)
    js = [JA.solve(d, config=jcfg) for d in datas]
    # one chunk of 25 (plus the tail): the bf16 rounding of a vector can flip
    # on one ulp of f32 reordering, so the bound is test_solve_matches_jax_off's
    np.testing.assert_allclose(ts.x.numpy(), np.stack([s.x for s in js]), atol=5e-4)
    np.testing.assert_array_equal(ts.iterations.numpy(), [int(s.iterations) for s in js])
    f32 = TA.solve(_stack(datas), config=TA.ADMMConfig(**base, use_pallas="auto"))
    kernel_cfg = tcfg.replace(use_pallas="auto")
    if kernel_cfg.matvec_dtype == "bf16" and kernel_cfg.tail_f32_iters > 0:
        with pytest.raises(ValueError, match="kernel path"):
            TA.solve(_stack(datas), config=kernel_cfg)
        with pytest.raises(ValueError, match="Pallas"):
            JA.solve(datas[0], config=jcfg.replace(use_pallas="lanes_interpret"))
    else:
        torch.testing.assert_close(TA.solve(_stack(datas), config=kernel_cfg).x, f32.x,
                                   rtol=0, atol=0)


def test_warm_kkt_raises():
    """``kkt_inv0`` is ported now (it raised before): the solve refreshes the
    given inverse by Newton–Schulz under the fixed scaling and returns the
    refreshed one, as the JAX solver does. A zero inverse cannot lower
    ‖MX − I‖, so the acceptance keeps it in both packages (and the iterates
    never move); a perturbed true inverse is refreshed, lane by lane."""
    datas = [random_qp(np.random.default_rng(s)) for s in range(3)]
    td = _stack(datas)
    sd, sc = TR.ruiz_equilibrate(td, 3)
    rv = TA._rho_vec(sd.l, sd.u, torch.full((3,), 0.1))
    true_inv = TA._factor(sd.P, sd.A, rv, 1e-6)
    noise = torch.randn(true_inv.shape, generator=torch.Generator().manual_seed(0))
    pert = true_inv * (1 + 1e-3 * (noise + noise.transpose(1, 2)))
    jcfg = JA.ADMMConfig(max_iter=50, use_pallas="off", infeas_certs=False, adaptive_rho=False)
    tcfg = convert.admm_config_from_fields(_fields(jcfg))
    for X0 in (torch.zeros_like(true_inv), pert):
        for mode in ("off", "auto"):
            ts = TA.solve(td, config=tcfg.replace(use_pallas=mode), fixed_scaling=sc,
                          kkt_inv0=X0)
            for b, d in enumerate(datas):
                jsc = JR.Scaling(D=jnp.asarray(sc.D[b].numpy()), E=jnp.asarray(sc.E[b].numpy()),
                                 c=jnp.asarray(sc.c[b].item()))
                js = JA.solve(d, config=jcfg, fixed_scaling=jsc, kkt_inv0=jnp.asarray(X0[b].numpy()))
                scale = float(np.abs(js.kkt_inv).max())
                np.testing.assert_allclose(ts.kkt_inv[b].numpy(), js.kkt_inv, atol=1e-4 * max(scale, 1))
                # the two refreshed inverses differ by ~1e-5 of their scale
                # (f32 matmul order), which 50 iterations carry to ~5e-4
                np.testing.assert_allclose(ts.x[b].numpy(), js.x, atol=1e-3)
        if not bool(X0.any()):
            assert not bool(ts.kkt_inv.any()) and not bool(ts.x.any())
    assert TA.solve(td, config=tcfg).kkt_inv is None  # no carry asked, none returned


def test_ns_refresh_acceptance_matches_jax():
    """``_ns_refresh`` per lane: a nearby inverse is refreshed toward M⁻¹; one
    outside the Newton–Schulz region (×3: ‖I − MX₀‖ = 2) diverges and the
    monotone acceptance keeps it, in both packages."""
    datas = [random_qp(np.random.default_rng(s)) for s in range(2)]
    td = _stack(datas)
    rv = TA._rho_vec(td.l, td.u, torch.full((2,), 0.1))
    inv = TA._factor(td.P, td.A, rv, 1e-6)
    X0 = torch.stack([inv[0] * 1.01, inv[1] * 3.0])
    X = TA._ns_refresh(td.P, td.A, rv, 1e-6, X0, iters=4)
    assert torch.equal(X[1], X0[1])
    assert (X[0] - inv[0]).abs().max() < 1e-2 * (X0[0] - inv[0]).abs().max()
    for b, d in enumerate(datas):
        jX = JA._ns_refresh(d.P, d.A, jnp.asarray(rv[b].numpy()), 1e-6,
                            jnp.asarray(X0[b].numpy()), iters=4)
        np.testing.assert_allclose(X[b].numpy(), jX, atol=1e-4 * float(np.abs(jX).max()))


def test_bf16_operator_consistent_factor_stays_bounded():
    """``tests/test_qp.py``'s twin on its QP (seed 0): the bf16 stream
    factors from the rounded operator and stays near the f32 solution; the
    JAX solve of the same QP reads the same."""
    d = random_qp(np.random.default_rng(0))
    kw = dict(max_iter=400, check_interval=50, adaptive_rho=False, infeas_certs=False,
              use_pallas="off")
    f32 = TA.solve(_stack([d]), config=TA.ADMMConfig(**kw))
    bf16 = TA.solve(_stack([d]), config=TA.ADMMConfig(**kw, matvec_dtype="bf16"))
    assert float((bf16.x - f32.x).abs().max()) < 1.0
    assert float(bf16.pri_res[0]) < 1.0
    jb = JA.solve(d, config=JA.ADMMConfig(**kw, matvec_dtype="bf16"))
    assert float(jnp.max(jnp.abs(jb.x - f32.x[0].numpy()))) < 1.0
    # the first chunks agree lane for lane: the rounded vectors have not
    # parted yet (they part later on one-ulp differences, as bf16 does)
    kw100 = {**kw, "max_iter": 100, "matvec_dtype": "bf16"}
    np.testing.assert_allclose(TA.solve(_stack([d]), config=TA.ADMMConfig(**kw100)).x[0].numpy(),
                               JA.solve(d, config=JA.ADMMConfig(**kw100)).x, atol=5e-4)


def test_bf16_f32_tail_recovers_f32_fixed_point():
    """The twin of ``tests/test_qp.py``'s: after an 80-iteration bf16 bulk,
    320 f32 iterations with their own factor reach the f32 fixed point."""
    d = random_qp(np.random.default_rng(0))
    kw = dict(adaptive_rho=False, infeas_certs=False, use_pallas="off")
    f32 = TA.solve(_stack([d]), config=TA.ADMMConfig(max_iter=400, check_interval=50, **kw))
    cfg = TA.ADMMConfig(max_iter=80, check_interval=40, matvec_dtype="bf16",
                        tail_f32_iters=320, **kw)
    tail = TA.solve(_stack([d]), config=cfg)
    np.testing.assert_allclose(tail.x.numpy(), f32.x.numpy(), atol=5e-3)
    assert float(tail.pri_res[0]) < 1e-3
    assert int(tail.iterations[0]) == 400
    jt = JA.solve(d, config=JA.ADMMConfig(max_iter=80, check_interval=40, matvec_dtype="bf16",
                                          tail_f32_iters=320, **kw))
    np.testing.assert_allclose(tail.x[0].numpy(), jt.x, atol=5e-3)


def test_bf16_diag_row_structure_operator_consistent():
    """The twin of ``tests/test_qp.py``'s: the "diag" rows stream f32 and
    stay f32 in the factored operator, the others are rounded."""
    rng = np.random.default_rng(0)
    n = 12
    extra = rng.normal(size=(8, n))
    A = np.concatenate([np.diag(1.0 + 0.5 * rng.random(n)), extra])
    G = rng.normal(size=(n, n))
    jd = JA.QPData(P=jnp.asarray(G @ G.T + 0.1 * np.eye(n), jnp.float32),
                   q=jnp.asarray(rng.normal(size=n), jnp.float32),
                   A=jnp.asarray(A, jnp.float32), l=jnp.full(20, -1.0), u=jnp.full(20, 1.0))
    segs = (("diag", n), ("dense", 8))
    kw = dict(adaptive_rho=False, infeas_certs=False, row_structure=segs, use_pallas="off")
    td = _stack([jd])
    f32 = TA.solve(td, config=TA.ADMMConfig(max_iter=400, check_interval=50, **kw))
    tail = TA.solve(td, config=TA.ADMMConfig(max_iter=200, check_interval=50,
                                             matvec_dtype="bf16", tail_f32_iters=200, **kw))
    np.testing.assert_allclose(tail.x.numpy(), f32.x.numpy(), atol=5e-3)
    assert float(tail.pri_res[0]) < 1e-3
    # the factored operator: the diag rows exact, the dense ones rounded
    ops = TA._cast_ops(TA.compact_structure(td.A, segs))
    Af = TA._materialize_ops(ops, n)
    assert torch.equal(Af[:, :n], td.A[:, :n])
    assert torch.equal(Af[:, n:], td.A[:, n:].to(torch.bfloat16).float())
    assert not torch.equal(Af[:, n:], td.A[:, n:])


@pytest.mark.parametrize("name", ["blt", "blockdiag", "blockdiag_shared"])
def test_bf16_materialized_operator_matches_jax(name):
    """``_materialize_ops`` of every composite segment kind against JAX's,
    on the scaled A with its Ruiz factors (the shared block rounds before
    its per-stage ratios multiply, as in JAX)."""
    segs = _SEGS[name]
    data = _structured(5, segs)
    sd, sc = TR.ruiz_equilibrate(_stack([data]), 3)
    ops = TA._cast_ops(TA.compact_structure(sd.A, segs, E=sc.E, D=sc.D))
    jops = JA._cast_ops(JA._compact_structure(jnp.asarray(sd.A[0].numpy()), segs,
                                              E=jnp.asarray(sc.E[0].numpy()),
                                              D=jnp.asarray(sc.D[0].numpy())), jnp.bfloat16)
    n, m = sd.A.shape[2], sd.A.shape[1]
    np.testing.assert_allclose(TA._materialize_ops(ops, n)[0].numpy(),
                               JA._materialize_ops(jops, m, n, jnp.float32), rtol=1e-6, atol=0)


def test_bf16_tail_on_pallas_path_raises():
    """The twin of ``tests/test_qp.py``'s: a bf16 tail on a kernel mode
    refuses to run (the chunk applies the f32 A)."""
    data = _stack([random_qp(np.random.default_rng(0))])
    for mode in ("on", "auto", "lanes"):
        with pytest.raises(ValueError, match="kernel path"):
            TA.solve(data, config=TA.ADMMConfig(max_iter=100, check_interval=50,
                                                matvec_dtype="bf16", tail_f32_iters=20,
                                                use_pallas=mode))


def test_solve_batch_matches_jax():
    """``tests/test_qp.py``'s batch twin: ``solve_batch`` of four stacked
    QPs (default warm starts filled per lane) against the JAX
    ``solve_batch``, and ``solve_jit`` is the same solve."""
    datas = [random_qp(np.random.default_rng(s)) for s in range(4)]
    jbatch = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    jsol = JA.solve_batch(jbatch, config=JA.ADMMConfig(max_iter=400, use_pallas="off"))
    for mode in ("off", "auto"):
        cfg = TA.ADMMConfig(max_iter=400, use_pallas=mode)
        tsol = TA.solve_batch(_stack(datas), config=cfg)
        np.testing.assert_allclose(tsol.x.numpy(), jsol.x, atol=1e-3)
        for i, d in enumerate(datas):
            s = TA.solve(_stack([d]), config=cfg)
            np.testing.assert_allclose(tsol.x[i].numpy(), s.x[0].numpy(), atol=1e-4)
        torch.testing.assert_close(TA.solve_jit(_stack(datas), config=cfg).x,
                                   TA.solve(_stack(datas), config=cfg).x, rtol=0, atol=0)


def test_diag_structure_matches_dense():
    """The compacted 'diag' stream gives the dense stream's answer."""
    n = 12
    rng = np.random.default_rng(3)
    G = rng.normal(size=(2, n, n))
    P = torch.tensor(G @ G.transpose(0, 2, 1) + 0.1 * np.eye(n), dtype=torch.float32)
    q = torch.tensor(rng.normal(size=(2, n)), dtype=torch.float32)
    A = torch.eye(n).expand(2, n, n).clone()
    data = QPData(P=P, q=q, A=A, l=-torch.ones(2, n), u=torch.ones(2, n))
    base = dict(max_iter=50, check_interval=25, infeas_certs=False, use_pallas="off")
    dense = TA.solve(data, config=TA.ADMMConfig(**base))
    diag = TA.solve(data, config=TA.ADMMConfig(**base, row_structure=(("diag", n),)))
    torch.testing.assert_close(diag.x, dense.x, rtol=0, atol=1e-5)


def test_condensed_qp_matches_jax():
    rng = np.random.default_rng(0)
    B, N, n_x, n_u = 3, 6, 7, 3
    Aks = (np.eye(n_x) + 0.05 * rng.normal(size=(B, N, n_x, n_x))).astype(np.float32)
    Bks = (0.1 * rng.normal(size=(B, N, n_x, n_u))).astype(np.float32)
    cks = (0.1 * rng.normal(size=(B, N, n_x))).astype(np.float32)
    x0 = rng.normal(size=(B, n_x)).astype(np.float32)
    Q = np.diag([0.0, 10, 10, 10, 1, 1, 1]).astype(np.float32)
    R = (np.eye(3) * 0.01).astype(np.float32)
    xr = rng.normal(size=(B, N + 1, n_x)).astype(np.float32)
    xmin = np.array([-1e20, -100, -100, -100, -50, -50, -50], np.float32)
    xmax = -xmin
    Ulo = (0.3 + 0.1 * rng.random(size=(B, N, n_u))).astype(np.float32)
    Uhi = Ulo + 4.0
    u = rng.normal(size=(B, N * n_u)).astype(np.float32)
    T = torch.tensor
    for mask in (None, (False,) * 7, (False, True, False, True, False, False, True)):
        td, tG, tds = TC.build_condensed_qp(
            T(Aks), T(Bks), T(cks), T(x0), T(Q), T(R), T(Q * 10), T(xr),
            T(xmin), T(xmax), T(Ulo), T(Uhi), x_bound_mask=mask)
        tX = TC.recover_states(tG, tds, T(u), T(x0))
        for b in range(B):
            jd, jG, jds = JC.build_condensed_qp(
                Aks[b], Bks[b], cks[b], x0[b], Q, R, Q * 10, xr[b], xmin, xmax,
                Ulo[b], Uhi[b], x_bound_mask=mask)
            for k in ("P", "q", "A", "l", "u"):
                ref = np.asarray(getattr(jd, k))
                # f32 matmul chains of a few stages; relative to the entry scale
                np.testing.assert_allclose(getattr(td, k)[b].numpy(), ref,
                                           rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref[np.abs(ref) < 1e19]).max()))
            np.testing.assert_allclose(tX[b].numpy(), JC.recover_states(jG, jds, u[b], x0[b]),
                                       rtol=1e-5, atol=1e-5)


def _ltv(rng, B, N, n_x=7, n_u=3):
    Aks = (np.eye(n_x) + 0.05 * rng.normal(size=(B, N, n_x, n_x))).astype(np.float32)
    Bks = (0.1 * rng.normal(size=(B, N, n_x, n_u))).astype(np.float32)
    cks = (0.1 * rng.normal(size=(B, N, n_x))).astype(np.float32)
    x0 = rng.normal(size=(B, n_x)).astype(np.float32)
    xr = rng.normal(size=(B, N + 1, n_x)).astype(np.float32)
    return Aks, Bks, cks, x0, xr


_Q = np.diag([0.0, 10, 10, 10, 1, 1, 1]).astype(np.float32)
_R = (np.eye(3) * 0.01).astype(np.float32)
_XMIN = np.array([-1e20, -100, -100, -100, -50, -50, -50], np.float32)


def _assert_qp_equal(td, b, jd):
    for k in ("P", "q", "A", "l", "u"):
        ref = np.asarray(getattr(jd, k))
        # f32 matmul chains of a few stages; relative to the entry scale
        np.testing.assert_allclose(
            getattr(td, k)[b].numpy(), ref, rtol=1e-5,
            atol=1e-5 * max(1.0, np.abs(ref[np.abs(ref) < 1e19]).max()), err_msg=k)


@pytest.mark.parametrize("gx", ["constant", "per_stage", "per_lane", None])
def test_condensed_facets_match_jax(gx):
    """Gx facet rows (one block, per stage, and per lane and stage as a
    batched stage_rows_fn gives them) and Gu facet rows, matrix for matrix."""
    rng = np.random.default_rng(1)
    B, N = 3, 5
    Aks, Bks, cks, x0, xr = _ltv(rng, B, N)
    shape = {"constant": (2, 7), "per_stage": (N, 2, 7), "per_lane": (B, N, 2, 7), None: None}[gx]
    Gx = None if gx is None else rng.normal(size=shape).astype(np.float32)
    gx_l = np.array([-1.0, -1e20], np.float32)
    gx_u = np.array([2.0, 0.5], np.float32)
    Gu = rng.normal(size=(4, 3)).astype(np.float32)
    gu_l, gu_u = -np.ones(4, np.float32), np.full(4, 1e20, np.float32)
    T = lambda a: None if a is None else torch.tensor(a)
    mask = (False, True, False, True, False, False, False)
    td, _, _ = TC.build_condensed_qp(
        T(Aks), T(Bks), T(cks), T(x0), T(_Q), T(_R), T(_Q * 10), T(xr), T(_XMIN), T(-_XMIN),
        T(np.array([0.3, -5, -5], np.float32)), T(np.full(3, 5, np.float32)),
        T(Gx), T(gx_l) if gx else None, T(gx_u) if gx else None, T(Gu), T(gu_l), T(gu_u),
        x_bound_mask=mask)
    n_gx = 2 if gx else 0
    assert td.m == TC.n_condensed_constraints(N, 7, 3, n_gx, 4, mask) == JC.n_condensed_constraints(
        N, 7, 3, n_gx, 4, mask)
    for b in range(B):
        Gx_b = Gx[b] if gx == "per_lane" else Gx
        jd, _, _ = JC.build_condensed_qp(
            Aks[b], Bks[b], cks[b], x0[b], _Q, _R, _Q * 10, xr[b], _XMIN, -_XMIN,
            jnp.array([0.3, -5, -5]), jnp.full(3, 5.0),
            None if gx is None else jnp.asarray(Gx_b), gx_l if gx else None,
            gx_u if gx else None, jnp.asarray(Gu), gu_l, gu_u, x_bound_mask=mask)
        _assert_qp_equal(td, b, jd)


@pytest.mark.parametrize("facets", [False, True])
def test_sparse_form_qp_matches_jax(facets):
    """build_mpc_qp (with per-stage and per-lane bounds, as an SCP loop hands
    them over), build_stage_rows and extend_qp, matrix for matrix."""
    rng = np.random.default_rng(2)
    B, N = 3, 5
    Aks, Bks, cks, x0, xr = _ltv(rng, B, N)
    Xlo = (_XMIN + rng.random(size=(B, N + 1, 7))).astype(np.float32)
    Ulo = (0.3 + 0.1 * rng.random(size=(B, N, 3))).astype(np.float32)
    T = torch.tensor
    td = TM.build_mpc_qp(T(Aks), T(Bks), T(cks), T(x0), T(_Q), T(_R), T(_Q * 10), T(xr),
                         T(Xlo), T(-_XMIN), T(Ulo), T(Ulo + 4.0))
    assert td.n == TM.n_vars(N, 7, 3) == JM.n_vars(N, 7, 3)
    assert td.m == TM.n_constraints(N, 7, 3) == JM.n_constraints(N, 7, 3)
    Gx = rng.normal(size=(2, 7)).astype(np.float32)
    Gu = rng.normal(size=(4, 3)).astype(np.float32)
    rows = (Gx, np.array([-1.0, -1e20], np.float32), np.array([2.0, 0.5], np.float32),
            Gu, -np.ones(4, np.float32), np.full(4, 1e20, np.float32))
    if facets:
        ext = TM.build_stage_rows(N, 7, 3, *[T(a) for a in rows])
        jext = JM.build_stage_rows(N, 7, 3, *[jnp.asarray(a) for a in rows])
        for a, b in zip(ext, jext):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        td = TM.extend_qp(td, *ext)
    for b in range(B):
        jd = JM.build_mpc_qp(Aks[b], Bks[b], cks[b], x0[b], _Q, _R, _Q * 10, xr[b],
                             Xlo[b], -_XMIN, Ulo[b], Ulo[b] + 4.0)
        if facets:
            jd = JM.extend_qp(jd, *jext)
        _assert_qp_equal(td, b, jd)


def test_build_cost_with_control_reference_matches_jax():
    rng = np.random.default_rng(3)
    xr = rng.normal(size=(2, 5, 7)).astype(np.float32)
    ur = rng.normal(size=(2, 4, 3)).astype(np.float32)
    P, q = TM.build_cost(4, torch.tensor(_Q), torch.tensor(_R), torch.tensor(_Q * 10),
                         torch.tensor(xr), torch.tensor(ur))
    for b in range(2):
        jP, jq = JM.build_cost(4, _Q, _R, _Q * 10, xr[b], ur[b])
        np.testing.assert_array_equal(P.numpy(), np.asarray(jP))
        np.testing.assert_allclose(q[b].numpy(), jq, rtol=1e-6, atol=1e-6)


def test_join_split_roundtrip():
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.normal(size=(2, 5, 7)), dtype=torch.float32)
    U = torch.tensor(rng.normal(size=(2, 4, 3)), dtype=torch.float32)
    z = join_z(X, U)
    X2, U2 = split_z(z, 4, 7, 3)
    torch.testing.assert_close(X2, X)
    torch.testing.assert_close(U2, U)
    _, Uj = jax_split_z(jnp.asarray(z[0].numpy()), 4, 7, 3)
    np.testing.assert_array_equal(U[0].numpy(), Uj)


def _diag_rows_qp(seed, n=12, m=18):
    """random_qp whose first n rows are diagonal (as the condensed QP's
    control-bound rows are)."""
    rng = np.random.default_rng(seed)
    data = random_qp(rng, n=n, m=m, eq_rows=4)
    A = np.array(data.A)
    A[:n] = np.diag(1.0 + 0.5 * rng.random(n))
    return data.replace(A=jnp.asarray(A, jnp.float32))


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_solve_with_declared_structure_matches_jax_off(mode):
    """A declared ("diag", 12) + ("dense", 6) structure: the port's streamed
    loop and its chunk (plain version on the CPU) both match the JAX
    streamed solve with the same declaration, at the full-solve bound."""
    segs = (("diag", 12), ("dense", 6))
    datas = [_diag_rows_qp(s) for s in range(4)]
    jcfg = JA.ADMMConfig(max_iter=100, use_pallas="off", infeas_certs=False,
                         adaptive_rho=False, row_structure=segs)
    tcfg = convert.admm_config_from_fields(_fields(jcfg)).replace(use_pallas=mode)
    assert tcfg.row_structure == segs
    ts = TA.solve(_stack(datas), config=tcfg)
    js = [JA.solve(d, config=jcfg) for d in datas]
    np.testing.assert_allclose(ts.x.numpy(), np.stack([s.x for s in js]), atol=5e-4)
    np.testing.assert_array_equal(ts.status.numpy(), [int(s.status) for s in js])


def test_solve_hands_the_declared_structure_to_the_chunk(monkeypatch):
    """solve() passes the main path's declared row structure, the 60
    identity control rows as ("diag", 60), to the chunk kernel's wrapper."""
    from gpmpc_tpu_torch.main_path import main_path
    from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg

    cfg = _condensed_admm_cfg(main_path("cpu").config.base)
    assert cfg.row_structure == (("diag", 60),) and cfg.use_pallas == "auto"
    calls = []
    real = TA.chunk_kernel.admm_chunk

    def record(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(TA.chunk_kernel, "admm_chunk", record)
    rng = np.random.default_rng(0)
    n = 60
    G = rng.normal(size=(2, n, n))
    T = lambda a: torch.tensor(a, dtype=torch.float32)
    data = QPData(P=T(G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)), q=T(rng.normal(size=(2, n))),
                  A=torch.eye(n).expand(2, n, n).clone(), l=-torch.ones(2, n), u=torch.ones(2, n))
    sol = TA.solve(data, config=cfg)
    assert len(calls) == cfg.max_iter // cfg.check_interval
    assert all(kw["row_structure"] == (("diag", 60),) for kw in calls)
    assert bool(torch.isfinite(sol.x).all())


# -- every row-segment kind ---------------------------------------------------

_SEGS = {
    "blt": (("blt", 3, 2, 4),),
    "blockdiag": (("blockdiag", 3, 2, 4),),
    "blockdiag_shared": (("blockdiag_shared", 3, 2, 4),),
    "diag_after_blt": (("blt", 3, 2, 4), ("diag", 12)),
    "condensed_order": (("blt", 3, 2, 4), ("diag", 12), ("blt", 3, 1, 4),
                        ("blockdiag_shared", 3, 2, 4)),
}


def _segment_rows(rng, seg, n):
    kind = seg[0]
    if kind == "diag":
        return np.diag(1.0 + 0.5 * rng.random(seg[1]))[:, :n]
    _, nb, h, w = seg
    A = np.zeros((nb * h, n))
    shared = rng.normal(size=(h, w))
    for i in range(nb):
        if kind == "blt":
            A[i * h:(i + 1) * h, :(i + 1) * w] = rng.normal(size=(h, (i + 1) * w))
        else:
            A[i * h:(i + 1) * h, i * w:(i + 1) * w] = (
                shared if kind == "blockdiag_shared" else rng.normal(size=(h, w)))
    return A


def _structured(seed, segs, n=12, extra=3):
    """A QP whose A really has the declared structure, plus ``extra``
    undeclared dense rows."""
    rng = np.random.default_rng(seed)
    A = np.concatenate([_segment_rows(rng, s, n) for s in segs] + [rng.normal(size=(extra, n))])
    m = A.shape[0]
    G = rng.normal(size=(n, n))
    x_feas = rng.normal(size=n)
    lo = A @ x_feas - rng.random(m) - 0.1
    hi = A @ x_feas + rng.random(m) + 0.1
    hi[-1] = lo[-1]  # one equality row
    return JA.QPData(*[jnp.asarray(a, jnp.float32) for a in
                       (G @ G.T + 0.1 * np.eye(n), rng.normal(size=n), A, lo, hi)])


@pytest.mark.parametrize("mode,jax_mode", [("off", "off"), ("auto", "lanes_interpret")])
@pytest.mark.parametrize("name", list(_SEGS))
def test_row_segments_match_jax(name, mode, jax_mode):
    """Every row-segment kind, alone and in the condensed QP's row order,
    Ruiz scaling on: the port's streamed loop against the JAX streamed solve
    with the same declaration, and the port's chunk (its plain version here)
    against the JAX lanes kernel in interpret mode, which reads A densely.
    Tolerance: the full-solve bound of test_solve_matches_jax_off; the
    termination test is put out of reach so that no lane freezes a chunk
    earlier in one package than in the other."""
    segs = _SEGS[name]
    datas = [_structured(s, segs) for s in range(3)]
    jcfg = JA.ADMMConfig(max_iter=100, use_pallas=jax_mode, infeas_certs=False,
                         adaptive_rho=False, row_structure=segs, eps_abs=1e-9, eps_rel=1e-9)
    tcfg = convert.admm_config_from_fields(_fields(jcfg)).replace(use_pallas=mode)
    ts = TA.solve(_stack(datas), config=tcfg)
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    js = jax.vmap(lambda d: JA.solve(d, config=jcfg))(batch)
    np.testing.assert_allclose(ts.x.numpy(), js.x, atol=5e-4)
    np.testing.assert_allclose(ts.z.numpy(), js.z, atol=5e-4)
    # and the structure is the dense operator: same answer with none declared
    dense = TA.solve(_stack(datas), config=tcfg.replace(row_structure=None))
    torch.testing.assert_close(ts.x, dense.x, rtol=0, atol=5e-4)


@pytest.mark.parametrize("name", list(_SEGS))
def test_compacted_ops_apply_the_dense_operator(name):
    """A_apply / AT_apply of the compacted operands against the dense
    products, with Ruiz scalings E, D (which "blockdiag_shared" needs)."""
    segs = _SEGS[name]
    data = _stack([_structured(s, segs) for s in range(2)])
    sd, sc = TR.ruiz_equilibrate(data, 5)
    ops = TA.compact_structure(sd.A, segs, E=sc.E, D=sc.D)
    A_apply, AT_apply = TA.make_A_ops(ops, data.n)
    rng = np.random.default_rng(0)
    v = torch.tensor(rng.normal(size=(2, data.n)), dtype=torch.float32)
    t = torch.tensor(rng.normal(size=(2, data.m)), dtype=torch.float32)
    torch.testing.assert_close(A_apply(v), TA._mv(sd.A, v), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(AT_apply(t), TA._mv(sd.A.transpose(1, 2), t), rtol=1e-5, atol=1e-5)


# -- infeasibility certificates -----------------------------------------------

def _cert_qps():
    inf = 1e20
    f = lambda *a: JA.QPData(*[jnp.asarray(x, jnp.float32) for x in a])
    return {
        # x ≥ 1 and x ≤ −1 at once
        "primal_infeasible": f(np.eye(2), np.zeros(2), [[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]],
                               [1.0, -inf, -1.0], [inf, -1.0, 1.0]),
        # no curvature along x₁, cost falling, only a lower bound on it
        "dual_infeasible": f(np.diag([1.0, 0.0]), [0.0, -1.0], np.eye(2)[[0, 1, 1]],
                             [-1.0, 0.0, 0.0], [1.0, inf, inf]),
        "feasible": f(np.eye(2), [1.0, -1.0], np.eye(2)[[0, 1, 1]],
                      [-1.0, 0.0, 0.0], [1.0, 2.0, 2.0]),
    }


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_infeasibility_certificates_match_jax(mode):
    """An infeasible, an unbounded and a solvable QP in one batch: the status
    codes equal the JAX solver's lane by lane (and are the certificates'),
    and frozen lanes keep the iteration count and residuals they stopped at."""
    qps = _cert_qps()
    jcfg = JA.ADMMConfig(max_iter=500, use_pallas="off", infeas_certs=True)
    tcfg = convert.admm_config_from_fields(_fields(jcfg)).replace(use_pallas=mode)
    ts = TA.solve(_stack(list(qps.values())), config=tcfg)
    js = [JA.solve(d, config=jcfg) for d in qps.values()]
    np.testing.assert_array_equal(ts.status.numpy(), [int(s.status) for s in js])
    np.testing.assert_array_equal(ts.iterations.numpy(), [int(s.iterations) for s in js])
    assert ts.status.tolist() == [TA.PRIMAL_INFEASIBLE, TA.DUAL_INFEASIBLE, TA.SOLVED]
    assert int(ts.iterations.max()) < 500  # every lane froze before the budget
    np.testing.assert_allclose(ts.x[2].numpy(), js[2].x, atol=5e-4)
    # without the certificates the same lanes run out of iterations
    off = TA.solve(_stack(list(qps.values())), config=tcfg.replace(infeas_certs=False))
    assert off.status.tolist() == [TA.MAX_ITER, TA.MAX_ITER, TA.SOLVED]


# -- polish ---------------------------------------------------------------------

def test_polish_matches_jax():
    """_polish on the same unscaled ADMM exit point, lane by lane. Tolerance:
    both solve the same f32 KKT system by Cholesky plus six refinement steps."""
    datas = [random_qp(np.random.default_rng(s)) for s in range(4)]
    jcfg = JA.ADMMConfig(max_iter=50, use_pallas="off", infeas_certs=False)
    js = [JA.solve(d, config=jcfg) for d in datas]
    T = lambda k: torch.tensor(np.stack([np.asarray(getattr(s, k)) for s in js]))
    xp, yp, zp = TA._polish(_stack(datas), T("x"), T("y"), T("z"), TA.ADMMConfig())
    for b, (d, s) in enumerate(zip(datas, js)):
        jx, jy, jz = JA._polish(d, s.x, s.y, s.z, JA.ADMMConfig())
        np.testing.assert_allclose(xp[b].numpy(), jx, atol=1e-4)
        np.testing.assert_allclose(zp[b].numpy(), jz, atol=1e-4)
        np.testing.assert_allclose(yp[b].numpy(), jy, atol=1e-3)


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_polished_solve_matches_jax_and_upgrades_status(mode):
    """A budget too short to converge: polish lands on the optimum anyway
    and turns MAX_ITER into SOLVED, in both packages."""
    datas = [random_qp(np.random.default_rng(s)) for s in range(4)]
    jcfg = JA.ADMMConfig(max_iter=50, use_pallas="off", polish=True)
    tcfg = convert.admm_config_from_fields(_fields(jcfg)).replace(use_pallas=mode)
    ts = TA.solve(_stack(datas), config=tcfg)
    raw = TA.solve(_stack(datas), config=tcfg.replace(polish=False))
    js = [JA.solve(d, config=jcfg) for d in datas]
    np.testing.assert_allclose(ts.x.numpy(), np.stack([s.x for s in js]), atol=2e-4)
    np.testing.assert_array_equal(ts.status.numpy(), [int(s.status) for s in js])
    assert bool((ts.status == TA.SOLVED).all()) and bool((raw.status == TA.MAX_ITER).any())
    assert float(ts.dua_res.max()) < float(raw.dua_res.max())


def test_polish_keeps_the_admm_point_on_a_lane_it_cannot_improve():
    """A lane whose polished KKT system is singular (NaN) keeps its ADMM
    iterate; the other lane is still polished."""
    datas = [random_qp(np.random.default_rng(s)) for s in range(2)]
    data = _stack(datas)
    data.P[1] = float("nan")
    x = torch.zeros(2, 12)
    xp, yp, zp = TA._polish(data, x, torch.zeros(2, 18), torch.zeros(2, 18), TA.ADMMConfig())
    assert bool(torch.isfinite(xp).all()) and bool((xp[1] == 0).all()) and bool((xp[0] != 0).any())
