"""The port's GP-free RTI cycle (gpmpc_tpu_torch/mpc/rti.py) and its
reference profiles against the JAX package on the CPU: same initial states
from NumPy, the JAX cycle ``vmap``-ed over the lanes, the port batch-first,
compared cycle by cycle in closed loop at a small horizon."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.dynamics import Rocket3DoFParams as JaxParams, rocket3dof as jr
from gpmpc_tpu.mpc import rti as JR
from gpmpc_tpu.ops.qp import ADMMConfig as JaxADMMConfig
from gpmpc_tpu.reference import cubic_descent_reference as jax_cubic, pad_reference as jax_pad
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as tr
from gpmpc_tpu_torch.mpc import rti as TR
from gpmpc_tpu_torch.ops.kernels import admm_chunk as K
from gpmpc_tpu_torch.ops.qp import ADMMConfig as TA_ADMMConfig
from gpmpc_tpu_torch.reference import cubic_descent_reference, pad_reference

torch.set_num_threads(1)  # the suite's xdist workers share the cores

DT = 0.1
N = 6
XT = np.array([2.0, 0, 0, 0, 0, 0, 0], np.float32)

jF = lambda x, u: jr.step(JaxParams(), x, u, DT)
_TP = Rocket3DoFParams(device="cpu")
tF = lambda x, u: tr.step(_TP, x, u, DT)
jF_true = lambda x, u: jr.step(JaxParams().replace(rho=1.0, C_D=1.0, A_ref=0.1), x, u, DT)
tF_true = lambda x, u: tr.step(_TP.replace(rho=1.0, C_D=1.0, A_ref=0.1), x, u, DT)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def port_config(jcfg, use_pallas="auto"):
    d = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in _fields(jcfg).items()}
    d["admm"] = _fields(jcfg.admm)
    cfg = convert.rti_config_from_fields(d, device="cpu")
    return cfg.replace(admm=cfg.admm.replace(use_pallas=use_pallas))


def jax_config(form, **kw):
    """condensed: the secondary bench metric's settings (bench.py: chunks of
    25, certificates on, no polish, fixed ρ, two Ruiz passes) with the
    altitude and descent-rate bound rows kept, so the row order is blt + diag,
    and four chunks, which those rows need to get below accept_pri_tol;
    sparse: the default settings (polish, adaptive ρ, certificates)."""
    if form == "condensed":
        admm = JaxADMMConfig(max_iter=100, check_interval=25, polish=False, adaptive_rho=False,
                             scaling=2, use_pallas="off")
        return JR.RTIConfig(N=N, condensed=True, accept_pri_tol=5e-3, admm=admm,
                            x_bound_mask=(False, True, False, False, True, False, False)
                            ).replace(**kw)
    admm = JaxADMMConfig(max_iter=100, polish=True, use_pallas="off")
    return JR.RTIConfig(N=N, admm=admm).replace(**kw)


def _x0s(B=4):
    x0s = np.tile(np.array([2.0, 12.0, 0.5, -0.5, -3.0, 0.2, 0.0], np.float32), (B, 1))
    x0s[:, 1] += np.linspace(0.0, 3.0, B, dtype=np.float32)
    return x0s


def _jax_state(js):
    return {f: np.asarray(getattr(js, f)) for f in
            ("X_lin", "U_lin", "X_prev", "U_prev", "y_prev", "rho", "x_ref")}


@pytest.mark.parametrize("form", ["condensed", "sparse"])
def test_rti_init_matches_jax(form):
    jcfg = jax_config(form)
    x0s = _x0s(3)
    ts = TR.rti_init(port_config(jcfg), x0s, XT)
    js = jax.vmap(lambda x: JR.rti_init(jcfg, x, jnp.asarray(XT)))(jnp.asarray(x0s))
    for f, ref in _jax_state(js).items():
        np.testing.assert_allclose(getattr(ts, f).numpy(), ref, rtol=1e-6, atol=1e-6, err_msg=f)
    # and the state carried over through NumPy is the same state
    tc = convert.rti_state_from_numpy(_jax_state(js), device="cpu")
    for f in _jax_state(js):
        torch.testing.assert_close(getattr(tc, f), getattr(ts, f), rtol=1e-6, atol=1e-6)


def _closed_loop(jcfg, use_pallas, cycles, x0s):
    cfg = port_config(jcfg, use_pallas)
    js = jax.vmap(lambda x: JR.rti_init(jcfg, x, jnp.asarray(XT)))(jnp.asarray(x0s))
    ts = TR.rti_init(cfg, x0s, XT)
    jstep = jax.jit(jax.vmap(lambda s, x: JR.rti_step(jF, jcfg, s, x)))
    xj, xt = jnp.asarray(x0s), torch.tensor(x0s)
    out = []
    for _ in range(cycles):
        sj, js = jstep(js, xj)
        st, ts = TR.rti_step(tF, cfg, ts, xt)
        out.append((sj, st, js, ts))
        xj = jax.vmap(jF_true)(xj, sj.u0)
        xt = tF_true(xt, st.u0)
    return out


@pytest.mark.parametrize("use_pallas", ["auto", "off"])
@pytest.mark.parametrize("form", ["condensed", "sparse"])
def test_rti_closed_loop_matches_jax(form, use_pallas):
    """Five closed-loop cycles on the dispersed plant, four lanes, the last
    one forced onto the fallback: its descent rate is outside the state box,
    so its QP is infeasible every cycle and it flies the shifted previous
    plan. Tolerance 5e-4 on u0 and X_opt: two f32 Cholesky implementations
    under 50-100 ADMM iterations (5e-4 is the full-solve bound of
    tests/test_torch_qp.py), carried through five cycles of a closed loop;
    the sparse form's polish brings both to the same KKT point."""
    x0s = _x0s(4)
    x0s[3, 4] = -60.0
    before = K.LAUNCHES
    runs = _closed_loop(jax_config(form), use_pallas, 5, x0s)
    for k, (sj, st, js, ts) in enumerate(runs):
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success), err_msg=f"cycle {k}")
        np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=5e-4, err_msg=f"cycle {k}")
        np.testing.assert_allclose(st.X_opt.numpy(), sj.X_opt, atol=5e-4, err_msg=f"cycle {k}")
        ok = np.asarray(sj.success)
        np.testing.assert_allclose(st.cost.numpy()[ok], np.asarray(sj.cost)[ok], rtol=2e-3)
        assert bool(torch.isinf(st.cost[~torch.tensor(ok)]).all())
        np.testing.assert_allclose(ts.X_prev.numpy(), js.X_prev, atol=5e-4)
    succ = np.stack([np.asarray(r[0].success) for r in runs])
    assert succ[:, :3].all() and not succ[:, 3].any()
    # the fallback lane's plan is its shifted previous plan, held exactly
    st0, ts0 = runs[0][1], TR.rti_init(port_config(jax_config(form)), x0s, XT)
    torch.testing.assert_close(st0.U_opt[3], ts0.U_prev[3], rtol=0, atol=0)
    assert K.LAUNCHES == before  # CPU tensors run the plain version


@pytest.mark.parametrize("kw", [
    {"reanchor": False},
    {"warm_start_duals": False},
    {"x_bound_mask": None},
    {"x_bound_mask": (False,) * 7},
])
def test_rti_cycle_variants_match_jax(kw):
    """The condensed cycle without re-anchoring, without dual warm starts and
    with state-bound rows elided (the last is the bench's configuration):
    two cycles each, same tolerance reasoning as the closed-loop test."""
    for sj, st, _, _ in _closed_loop(jax_config("condensed", **kw), "auto", 2, _x0s(3)):
        np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=5e-4)
        np.testing.assert_allclose(st.X_opt.numpy(), sj.X_opt, atol=5e-4)
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))


@pytest.mark.parametrize("form", ["condensed", "sparse"])
def test_rti_facet_rows_match_jax(form):
    """Gx and Gu facet rows in both formulations (a loose glideslope-like
    state facet and a thrust-cone-like control facet), one cycle."""
    Gx = np.array([[0, -1, 1, 0, 0, 0, 0], [0, -1, 0, 1, 0, 0, 0]], np.float32)
    Gu = np.array([[-1, 1, 0], [-1, 0, 1]], np.float32)
    kw = dict(Gx=jnp.asarray(Gx), gx_l=jnp.full(2, -1e20), gx_u=jnp.full(2, 1.0),
              Gu=jnp.asarray(Gu), gu_l=jnp.full(2, -1e20), gu_u=jnp.zeros(2))
    (sj, st, js, ts), = _closed_loop(jax_config(form, **kw), "auto", 1, _x0s(3))
    assert ts.y_prev.shape == js.y_prev.shape
    np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=5e-4)
    np.testing.assert_allclose(st.X_opt.numpy(), sj.X_opt, atol=5e-4)
    np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))


def test_condensed_row_structure_is_declared():
    cfg = port_config(jax_config("condensed"))
    assert TR._condensed_admm_cfg(cfg).row_structure == (("blt", 3, 4, 6), ("diag", 18))
    Gu = torch.eye(3)[:2]
    cfg = cfg.replace(Gu=Gu, gu_l=-torch.ones(2), gu_u=torch.ones(2),
                      x_bound_mask=(False,) * 7)
    assert TR._condensed_admm_cfg(cfg).row_structure == (
        ("diag", 18), ("blockdiag_shared", 6, 2, 3))


def test_prepare_then_feedback_is_the_step():
    jcfg = jax_config("condensed", reanchor=False)
    cfg = port_config(jcfg)
    x0s = _x0s(3)
    state = TR.rti_init(cfg, x0s, XT)
    x = torch.tensor(x0s)
    sol_a, st_a = TR.rti_step(tF, cfg, state, x)
    sol_b, st_b = TR.rti_feedback(cfg, state, TR.rti_prepare(tF, cfg, state), x)
    torch.testing.assert_close(sol_a.U_opt, sol_b.U_opt, rtol=0, atol=0)
    torch.testing.assert_close(st_a.y_prev, st_b.y_prev, rtol=0, atol=0)
    js = JR.rti_init(jcfg, jnp.asarray(x0s[0]), jnp.asarray(XT))
    sj, _ = JR.rti_feedback(jcfg, js, JR.rti_prepare(jF, jcfg, js), jnp.asarray(x0s[0]))
    np.testing.assert_allclose(sol_b.u0[0].numpy(), sj.u0, atol=5e-4)


def test_simple_rti_step_matches_jax():
    """The QP-free gradient-descent step: autograd through the rollout
    against jax.grad, 15 clipped descent steps. Tolerance: f32 gradients of
    a 6-step rollout, accumulated over 15 steps."""
    jcfg = jax_config("sparse")
    cfg = port_config(jcfg)
    x0s = _x0s(3)
    ts = TR.rti_init(cfg, x0s, XT)
    u_t, ts2 = TR.simple_rti_step(tF, cfg, ts, torch.tensor(x0s))
    for b in range(3):
        js = JR.rti_init(jcfg, jnp.asarray(x0s[b]), jnp.asarray(XT))
        u_j, js2 = JR.simple_rti_step(jF, jcfg, js, jnp.asarray(x0s[b]))
        np.testing.assert_allclose(u_t[b].numpy(), u_j, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ts2.U_lin[b].numpy(), js2.U_lin, rtol=1e-4, atol=1e-4)


def test_controller_with_reference_matches_jax():
    """make_rti_controller tracking a per-lane cubic descent reference: the
    receding window rides in the controller state; three steps."""
    jcfg = jax_config("condensed")
    cfg = port_config(jcfg)
    x0s = _x0s(3)
    jci, jcs = JR.make_rti_controller(
        jF, jcfg, jnp.asarray(XT), reference_fn=lambda x0: jax_cubic(x0, jnp.asarray(XT), 8, DT),
        ref_horizon=10)
    tci, tcs = TR.make_rti_controller(
        tF, cfg, torch.tensor(XT),
        reference_fn=lambda x0: cubic_descent_reference(x0, torch.tensor(XT), 8, DT),
        ref_horizon=10)
    jc = jax.vmap(jci)(jnp.asarray(x0s))
    tc = tci(torch.tensor(x0s))
    np.testing.assert_allclose(tc[1].numpy(), jc[1], rtol=1e-5, atol=1e-5)
    xj, xt = jnp.asarray(x0s), torch.tensor(x0s)
    for k in range(3):
        uj, jc = jax.jit(jax.vmap(jcs, in_axes=(0, 0, None)))(jc, xj, jnp.asarray(k))
        ut, tc = tcs(tc, xt, k)
        np.testing.assert_allclose(ut.numpy(), uj, atol=5e-4, err_msg=f"step {k}")
        np.testing.assert_allclose(tc[0].x_ref.numpy(), jc[0].x_ref, rtol=1e-5, atol=1e-5)
        xj, xt = jax.vmap(jF_true)(xj, uj), tF_true(xt, ut)
    # without a reference the state is the bare RTIState
    tci2, tcs2 = TR.make_rti_controller(tF, cfg, torch.tensor(XT))
    u, st = tcs2(tci2(torch.tensor(x0s)), torch.tensor(x0s), 0)
    assert isinstance(st, TR.RTIState) and u.shape == (3, 3)


def test_closed_loop_matches_jax_and_freezes_landed_lanes():
    """rti_closed_loop over 8 steps with a reference: lane 0 starts just
    above the landing altitude and freezes after its first step."""
    jcfg = jax_config("condensed")
    cfg = port_config(jcfg)
    x0s = _x0s(3)
    x0s[0, 1], x0s[0, 4] = 0.3, -2.5
    ref = np.asarray(jax_pad(jax_cubic(jnp.asarray(x0s[1]), jnp.asarray(XT), 8, DT), N + 8))
    jout = jax.jit(jax.vmap(lambda x: JR.rti_closed_loop(
        jF, jcfg, x, jnp.asarray(XT), 8, sim_step_fn=jF_true, X_ref_full=jnp.asarray(ref))))(
            jnp.asarray(x0s))
    tout = TR.rti_closed_loop(tF, cfg, x0s, XT, 8, sim_step_fn=tF_true,
                              X_ref_full=torch.tensor(ref)[None])
    np.testing.assert_array_equal(tout["landed"].numpy(), np.asarray(jout["landed"]))
    np.testing.assert_array_equal(tout["steps"].numpy(), np.asarray(jout["steps"]))
    assert tout["landed"].tolist() == [True, False, False] and int(tout["steps"][0]) == 1
    # eight closed-loop cycles: the 5e-4 per-cycle bound, doubled
    np.testing.assert_allclose(tout["X"].numpy(), jout["X"], atol=1e-3)
    np.testing.assert_allclose(tout["U"].numpy(), jout["U"], atol=1e-3)
    np.testing.assert_array_equal(tout["solver_success"].numpy(), np.asarray(jout["solver_success"]))
    assert bool((tout["U"][0, 1:] == 0).all())


@pytest.mark.parametrize("kw", [{"solver": "ipm", "condensed": True}, {"warm_kkt": True}])
def test_rti_options_not_ported_raise(kw):
    """Both options are ported now. ``solver="ipm"`` on the condensed QP
    runs and leaves the ADMM carry (ρ, duals) as it was
    (``tests/test_torch_ipm.py`` holds it against JAX); it refuses
    ``warm_kkt``, as JAX does. ``warm_kkt`` needs ``step_fn`` at init
    (``ValueError`` without, as in JAX) and then carries the refreshed KKT
    inverse: three cycles of the default sparse form against JAX (its
    adaptive ρ refactors per lane on discrete decisions that f32 noise may
    flip, so the carried inverse is compared in the fixed-ρ tests below)."""
    cfg = TR.RTIConfig(N=N, device="cpu", **kw)
    if cfg.solver == "ipm":
        st = TR.rti_init(cfg, _x0s(2), XT)
        sol, st2 = TR.rti_step(tF, cfg, st, torch.tensor(_x0s(2)))
        assert bool(torch.isfinite(sol.u0).all())
        assert torch.equal(st2.rho, st.rho)
        assert torch.equal(st2.y_prev, st.y_prev)
        warm = cfg.replace(warm_kkt=True)
        with pytest.raises(ValueError, match="warm_kkt"):
            TR.rti_step(tF, warm, TR.rti_init(warm, _x0s(1), XT, step_fn=tF),
                        torch.tensor(_x0s(1)))
        return
    with pytest.raises(ValueError, match="step_fn"):
        TR.rti_init(cfg, _x0s(1), XT)
    jcfg = JR.RTIConfig(N=N, warm_kkt=True, admm=JaxADMMConfig(max_iter=100, polish=True,
                                                               use_pallas="off"))
    for sj, st, js, ts in _warm_closed_loop(jcfg, "auto", 3, _x0s(3)):
        np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=5e-4)
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success))
        assert ts.kkt_inv.shape == js.kkt_inv.shape and bool(torch.isfinite(ts.kkt_inv).all())


def _warm_closed_loop(jcfg, use_pallas, cycles, x0s):
    """``_closed_loop`` with the warm-KKT carry: both packages initialized
    with ``step_fn``."""
    cfg = port_config(jcfg, use_pallas)
    js = jax.vmap(lambda x: JR.rti_init(jcfg, x, jnp.asarray(XT), step_fn=jF))(jnp.asarray(x0s))
    ts = TR.rti_init(cfg, x0s, XT, step_fn=tF)
    jstep = jax.jit(jax.vmap(lambda s, x: JR.rti_step(jF, jcfg, s, x)))
    xj, xt = jnp.asarray(x0s), torch.tensor(x0s)
    out = []
    for _ in range(cycles):
        sj, js = jstep(js, xj)
        st, ts = TR.rti_step(tF, cfg, ts, xt)
        out.append((sj, st, js, ts))
        xj = jax.vmap(jF_true)(xj, sj.u0)
        xt = tF_true(xt, st.u0)
    return out


def _assert_kkt_carry_close(ts, js):
    """The carried KKT inverse within 1e-4 of its largest entry (two f32
    factorizations and refreshes), the frozen scaling within a few ulps."""
    for b in range(ts.kkt_inv.shape[0]):
        ref = np.asarray(js.kkt_inv[b])
        np.testing.assert_allclose(ts.kkt_inv[b].numpy(), ref, atol=1e-4 * np.abs(ref).max())
    for f in ("scal_D", "scal_E", "scal_c"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), getattr(js, f), rtol=1e-5, err_msg=f)


WARM_ADMM = dict(max_iter=50, polish=False, adaptive_rho=False, scaling=3)


@pytest.mark.parametrize("form", ["condensed", "sparse"])
def test_warm_kkt_init_matches_jax(form):
    """``rti_init(..., step_fn=)``: the frozen Ruiz scaling and the KKT
    inverse of the QP the first cycle sees, per lane, against JAX; and the
    same state carried across from NumPy (``convert``)."""
    jcfg = JR.RTIConfig(N=N, warm_kkt=True, accept_pri_tol=5e-3, condensed=form == "condensed",
                        admm=JaxADMMConfig(**WARM_ADMM, use_pallas="off"))
    x0s = _x0s(3)
    ts = TR.rti_init(port_config(jcfg), x0s, XT, step_fn=tF)
    js = jax.vmap(lambda x: JR.rti_init(jcfg, x, jnp.asarray(XT), step_fn=jF))(jnp.asarray(x0s))
    _assert_kkt_carry_close(ts, js)
    d = {f: np.asarray(getattr(js, f)) for f in
         ("X_lin", "U_lin", "X_prev", "U_prev", "y_prev", "rho", "x_ref",
          "kkt_inv", "scal_D", "scal_E", "scal_c")}
    tc = convert.rti_state_from_numpy(d, device="cpu")
    for f, v in d.items():
        np.testing.assert_array_equal(getattr(tc, f).numpy(), v)
    # without warm_kkt the JAX state's zero-size placeholders become None
    jcold = jax.vmap(lambda x: JR.rti_init(jcfg.replace(warm_kkt=False), x, jnp.asarray(XT)))(
        jnp.asarray(x0s))
    tcold = convert.rti_state_from_numpy(
        {f: np.asarray(getattr(jcold, f)) for f in d}, device="cpu")
    assert tcold.kkt_inv is None and tcold.scal_c is None


@pytest.mark.parametrize("use_pallas", ["auto", "off"])
@pytest.mark.parametrize("form", ["condensed", "sparse"])
def test_warm_kkt_closed_loop_matches_jax(form, use_pallas):
    """Five closed-loop cycles of the warm-KKT cycle (frozen scaling,
    Newton–Schulz refresh, the inverse carried) on the dispersed plant,
    four lanes, against JAX: u0 and X_opt at the closed-loop test's 5e-4,
    the carried inverse at 1e-4 of its scale."""
    jcfg = JR.RTIConfig(N=N, warm_kkt=True, accept_pri_tol=5e-3, condensed=form == "condensed",
                        admm=JaxADMMConfig(**WARM_ADMM, use_pallas="off"))
    for k, (sj, st, js, ts) in enumerate(_warm_closed_loop(jcfg, use_pallas, 5, _x0s(4))):
        np.testing.assert_array_equal(st.success.numpy(), np.asarray(sj.success), err_msg=f"cycle {k}")
        np.testing.assert_allclose(st.u0.numpy(), sj.u0, atol=5e-4, err_msg=f"cycle {k}")
        np.testing.assert_allclose(st.X_opt.numpy(), sj.X_opt, atol=5e-4, err_msg=f"cycle {k}")
        _assert_kkt_carry_close(ts, js)


def test_prepare_feedback_carries_warm_kkt():
    """The twin of ``tests/test_mpc.py``'s: the split phases carry the
    refreshed inverse as the fused step does (bitwise, the same refresh
    chain), and the inverse moves off the init-time factorization."""
    cfg = TR.RTIConfig(N=N, reanchor=False, warm_kkt=True, accept_pri_tol=5e-3,
                       admm=TA_ADMMConfig(**WARM_ADMM), device="cpu")
    x0 = torch.tensor([[2.0, 25.0, 0.3, 0.0, -3.0, 0.0, 0.0]])
    st = TR.rti_init(cfg, x0, XT, step_fn=tF)
    st_fused, x = st, x0
    for _ in range(3):
        sol, st = TR.rti_feedback(cfg, st, TR.rti_prepare(tF, cfg, st), x)
        sol_f, st_fused = TR.rti_step(tF, cfg, st_fused, x)
        x = tF(x, sol_f.u0)
    torch.testing.assert_close(st.kkt_inv, st_fused.kkt_inv, rtol=0, atol=0)
    assert not torch.allclose(st.kkt_inv, TR.rti_init(cfg, x0, XT, step_fn=tF).kkt_inv)


@pytest.mark.parametrize("form", ["sparse", "condensed"])
def test_warm_kkt_matches_cholesky_path_closed_loop(form):
    """The twins of ``tests/test_mpc.py::TestWarmKKT`` on the port (N = 20,
    four lanes, 110 steps along cubic references): every lane lands,
    touchdown under 1 m/s, solver success above 0.99 in both paths, and the
    touchdown states of the warm and the Cholesky path within the JAX
    test's 0.05 (sparse, real-time settings) and 1e-5 (condensed at tight
    tolerance: both reach the same QP optimum)."""
    x0s = torch.tensor([2.0, 30.0, 0.0, 0.0, -3.0, 0.0, 0.0]).repeat(4, 1)
    x0s[:, 1] += torch.linspace(-3, 3, 4)
    x0s[:, 2] += torch.linspace(-1, 1, 4)
    F = lambda x, u: tr.step(_TP, x, u, 0.1)
    xT = torch.tensor(XT)
    ref = pad_reference(cubic_descent_reference(x0s, xT, 100, 0.1), 40)
    results = {}
    for warm in (False, True):
        if form == "sparse":
            cfg = TR.RTIConfig(N=20, warm_kkt=warm, accept_pri_tol=5e-3,
                               admm=TA_ADMMConfig(**WARM_ADMM), device="cpu")
        else:
            cfg = TR.RTIConfig(N=20, warm_kkt=warm, condensed=True, accept_pri_tol=0.0,
                               admm=TA_ADMMConfig(max_iter=250, polish=True, adaptive_rho=False,
                                                  scaling=3, ns_iters=8), device="cpu")
        out = TR.rti_closed_loop(F, cfg, x0s, xT, 110, X_ref_full=ref)
        assert bool(out["landed"].all()), f"warm={warm}"
        assert float(torch.linalg.vector_norm(out["x_final"][:, 4:7], dim=1).max()) < 1.0
        assert float(out["solver_success"].float().mean()) > 0.99, f"warm={warm}"
        results[warm] = out["x_final"]
    torch.testing.assert_close(results[True], results[False], rtol=0,
                               atol=0.05 if form == "sparse" else 1e-5)


@pytest.mark.parametrize("kw,match", [
    ({"stage_rows_fn": lambda X: None, "n_stage_rows": 1}, "requires condensed=True"),
    ({"Gx": np.zeros((N, 1, 7), np.float32), "gx_l": np.zeros(1, np.float32),
      "gx_u": np.zeros(1, np.float32)}, "requires condensed=True"),
])
def test_sparse_form_rejects_condensed_only_rows(kw, match):
    cfg = TR.RTIConfig(N=N, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        TR.rti_step(tF, cfg, TR.rti_init(cfg, _x0s(1), XT), torch.tensor(_x0s(1)))


@pytest.mark.parametrize("n_x", [7, 14])
def test_cubic_descent_reference_matches_jax(n_x):
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, n_x)).astype(np.float32)
    xT = rng.normal(size=n_x).astype(np.float32)
    ref = cubic_descent_reference(torch.tensor(x0), torch.tensor(xT), 12, DT)
    assert ref.shape == (3, 13, n_x)
    for b in range(3):
        np.testing.assert_allclose(ref[b].numpy(), jax_cubic(jnp.asarray(x0[b]), jnp.asarray(xT), 12, DT),
                                   rtol=1e-5, atol=1e-5)
    one = cubic_descent_reference(torch.tensor(x0[0]), torch.tensor(xT), 12, DT)
    torch.testing.assert_close(one, ref[0])
    np.testing.assert_allclose(pad_reference(ref, 4)[1].numpy(),
                               jax_pad(jnp.asarray(ref[1].numpy()), 4), rtol=0, atol=0)
