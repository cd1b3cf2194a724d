"""The port's 6-DoF GP-MPC cycle (Path D) against the benchmark's plain
float64 reference (``portbench/reference/``: ``dynamics6dof``, ``gp6dof``,
``gpmpc6dof``) on the CPU, at 4 lanes: the nominal step and the dispersed
plant, the step's Jacobians, the structured GP's gated mean and variances
from seeded random weights (data, inducing inputs, hyperparameters), and
one whole ``gp_mpc_solve`` cycle with its reference window. The reference
computed in float32 with its products' operands rounded to TF32 fails at
least one of the same tolerances. The GP the benchmark's cell flies is made
by the reference (features, targets, k-means, tuning): the program's own
fit of the same flown data, run in float64, agrees with it."""

import contextlib
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from gpmpc_tpu_torch.dynamics import rocket6dof as r6
from gpmpc_tpu_torch.dynamics import trajectory_jacobians
from gpmpc_tpu_torch.gp import StructuredGPConfig, StructuredRocketGP
from gpmpc_tpu_torch.gp.kernels import SquaredExponentialARD
from gpmpc_tpu_torch.gp.sparse_gp import refit_sparse_multi
from gpmpc_tpu_torch.learning import gp_fns
from gpmpc_tpu_torch.main_path import sixdof_path
from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import dynamics6dof as dyn, gp6dof, gpmpc6dof  # noqa: E402
from portbench.reference.prec import F64, TF32  # noqa: E402

torch.set_num_threads(1)  # the suite's xdist workers share the cores

CFG = json.loads((ROOT / "portbench" / "configs" / "gpmpc6dof.json").read_text())
B = 4
# each gap is |Δ| / (1 + |ref|), the largest entry (the duals: over 1 + the
# lane's largest |y|); each tolerance with its reason
TOL = {
    # float32 RK4 of states of size ~20: a few ulp of the largest entry
    "step": 2e-6,
    "plant": 2e-6,
    # forward-mode AD of the float32 step: products of entries up to ~10
    "jacobians": 2e-5,
    # the FITC posterior from f32 factors of well-posed random weights (noise
    # std 0.05, 16 inducing inputs): the variance 1 − ‖v‖² + ‖w‖² cancels
    "gp_mean": 1e-4,
    "gp_var": 1e-4,
    # the cycle: its QP is built from f32 Jacobians and GP, and 60 ADMM
    # iterations carry their rounding; the answer moves 10× the inputs'
    "u0": 1e-3,
    "plan": 1e-3,
    "duals": 1e-2,  # ADMM's duals converge slower than its primal
    "rho": 0.0,  # carried unchanged: no adaptive ρ
    "sigma": 1e-4,  # Σ over its largest entry: twenty f32 products A Σ Aᵀ
    "window": 1e-6,  # the cubic profile in f32
}


def weights(gp) -> dict:
    """A fitted StructuredRocketGP's weights, as the reference takes them."""
    def sub(g):
        k = g.kernels
        return {name: t.detach().clone() for name, t in (
            ("X", g.X), ("Y", g.Y), ("Z", g.Z), ("log_lengthscales", k.log_lengthscales),
            ("log_variance", k.log_variance), ("log_noise", g.log_noise))}

    return {"trans": sub(gp.trans_gp), "rot": sub(gp.rot_gp)}


@contextlib.contextmanager
def counted_chunks():
    """Counts the calls of the ADMM chunk inside the block (``.n``); on the
    CPU no kernel launches, so ``admm_chunk.LAUNCHES`` stays put."""
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    inner, count = K.admm_chunk, type("Count", (), {"n": 0})()

    def counted(*args, **kw):
        count.n += 1
        return inner(*args, **kw)

    K.admm_chunk = counted
    try:
        yield count
    finally:
        K.admm_chunk = inner


def _rel(a, b):
    a, b = a.double().flatten(1), b.double().flatten(1)
    return float(((a - b).abs() / (1.0 + b.abs())).amax())


def _rel_lane(a, b):
    a, b = a.double().flatten(1), b.double().flatten(1)
    return float(((a - b).abs().amax(1) / (1.0 + b.abs().amax(1))).amax())


def _states(g, n):
    """Descent states, tilted by up to a few degrees and turning slowly, and
    thrusts around hover."""
    x = torch.zeros(n, 14)
    x[:, 0] = 1.6 + 0.4 * torch.rand(n, generator=g)
    x[:, 1] = 8.0 + 12.0 * torch.rand(n, generator=g)
    x[:, 2:4] = torch.randn(n, 2, generator=g)
    x[:, 4] = -3.0 + 0.5 * torch.randn(n, generator=g)
    x[:, 5:7] = 0.3 * torch.randn(n, 2, generator=g)
    x[:, 7] = 1.0
    x[:, 8:11] = 0.04 * torch.randn(n, 3, generator=g)
    x[:, 7:11] = x[:, 7:11] / x[:, 7:11].norm(dim=1, keepdim=True)
    x[:, 11:14] = 0.05 * torch.randn(n, 3, generator=g)
    u = torch.stack([2.0 + 0.5 * torch.rand(n, generator=g),
                     0.2 * torch.randn(n, generator=g), 0.2 * torch.randn(n, generator=g)], 1)
    return x, u


def _random_gp(g, n=64, M=16):
    """A StructuredRocketGP with seeded random weights: training states and
    controls, residual targets, inducing inputs near the data, and each
    output's lengthscales, signal variance and noise."""
    X, U = _states(g, n)
    res = 0.1 * torch.randn(n, 6, generator=g)
    gp = StructuredRocketGP.create(StructuredGPConfig(max_data_points=n, n_inducing=M),
                                   device="cpu").add_data_batch(X, U, res)

    def sub(buf):
        Fx = buf.X
        d = Fx.shape[1]
        Z = Fx[torch.randperm(n, generator=g)[:M]] + 0.05 * torch.randn(M, d, generator=g)
        ls = (Fx.std(0) * d ** 0.5).clamp_min(0.1) * (0.5 + torch.rand(3, d, generator=g))
        k = SquaredExponentialARD(log_variance=-0.5 * torch.rand(3, generator=g),
                                  log_lengthscales=torch.log(ls))
        log_noise = torch.log(0.05 * (1.0 + torch.rand(3, generator=g)))
        return refit_sparse_multi(k, Z, Fx, buf.Y.T.contiguous(), buf.mask, log_noise)

    return dataclasses.replace(gp, trans_gp=sub(gp.trans_buffer), rot_gp=sub(gp.rot_buffer),
                               is_fitted=True)


@pytest.fixture(scope="module")
def case():
    g = torch.Generator().manual_seed(17)
    sp = sixdof_path("cpu")
    gp = _random_gp(g)
    x, u = _states(g, B)
    return sp, gp, x, u, g


def _port(sp, gp, x, u, g):
    """The port's answers: step, plant, Jacobians along a rollout, the GP at
    the knots, and one cycle from a perturbed warm start at step k = 7."""
    cfg = sp.config
    mean_fn, var_fn = gp_fns(gp)
    U = u[:, None] + 0.05 * torch.randn(B, cfg.base.N, 3, generator=g)
    X = r6.simulate(sp.params, x, U, cfg.base.dt)
    A, Bm, c = trajectory_jacobians(sp.F, X, U)
    x_start = x.clone()
    x_start[:, 1] += 1.5
    state = gp_mpc_init(cfg, x_start, sp.x_target, device="cpu")
    state = state.replace(U_lin=U, X_lin=X)
    k, N = 7, cfg.base.N
    full = sp.reference_fn(x_start)
    state = state.replace(x_ref=full[:, k:k + N + 1])
    with counted_chunks() as chunks:
        sol, new = gp_mpc_solve(sp.F, mean_fn, var_fn, cfg, state, x)
    mean, var = gp.predict_gated(X[:, :-1], U)[0], gp.predict(X[:, :-1], U)[1]
    return {"inputs": {"U": U, "X": X, "state": state, "x_start": x_start, "k": k,
                       "chunks": chunks.n},
            "step": sp.F(x, u), "plant": sp.F_true(x, u), "A": A, "B": Bm, "c": c,
            "gp_mean": mean, "gp_var": var, "u0": sol.u0, "X_shift": new.X_lin,
            "U_shift": new.U_lin, "y": new.y_prev, "rho": new.rho, "Sigmas": sol.Sigmas,
            "window": state.x_ref}


def _reference(P, gp, x, u, inp):
    """The same answers from the plain reference in precision P."""
    t = lambda v: v.to(P.dtype)
    w = gp6dof.from_weights(P, weights(gp), "cpu")
    nom = gpmpc6dof.nominal(CFG)
    X, U = t(inp["X"]), t(inp["U"])
    A, Bm, c = dyn.jacobians(P, nom, X, U, CFG["dt"])
    st = inp["state"]
    carry = {"X_lin": t(st.X_lin), "U_lin": t(st.U_lin), "rho": t(st.rho), "y": t(st.y_prev)}
    k = torch.full((B,), inp["k"])
    out = gpmpc6dof.cycle(P, CFG, w, carry, t(x), t(inp["x_start"]), k)
    v = out["v60"] if inp["chunks"] == 2 else out["v30"]
    mean = w.gated_mean(X[:, :-1], U)
    return {"step": dyn.step(nom, t(x), t(u), CFG["dt"]),
            "plant": gpmpc6dof.plant_step(CFG, t(x), t(u)), "A": A, "B": Bm, "c": c,
            "gp_mean": torch.cat([mean[..., 4:7], mean[..., 11:14]], -1),
            "gp_var": w.variance(X[:, :-1], U), "u0": v["u0"], "X_shift": v["X_shift"],
            "U_shift": v["U_shift"], "y": v["y"], "rho": v["rho"], "Sigmas": out["Sigmas"],
            "window": out["x_ref"]}


def _gaps(ans, ref):
    Sig = lambda s: s.double().flatten(1)
    return {
        "step": _rel(ans["step"], ref["step"]), "plant": _rel(ans["plant"], ref["plant"]),
        "jacobians": max(_rel(ans[k], ref[k]) for k in ("A", "B", "c")),
        "gp_mean": _rel(ans["gp_mean"], ref["gp_mean"]),
        "gp_var": _rel(ans["gp_var"], ref["gp_var"]),
        "u0": _rel(ans["u0"], ref["u0"]),
        "plan": max(_rel(ans["X_shift"], ref["X_shift"]), _rel(ans["U_shift"], ref["U_shift"])),
        "duals": _rel_lane(ans["y"], ref["y"]),
        "rho": _rel(ans["rho"][:, None], ref["rho"][:, None]),
        "sigma": float(((Sig(ans["Sigmas"]) - Sig(ref["Sigmas"])).abs().amax(1)
                        / Sig(ref["Sigmas"]).abs().amax(1)).amax()),
        "window": _rel(ans["window"], ref["window"]),
    }


@pytest.fixture(scope="module")
def answers(case):
    sp, gp, x, u, g = case
    port = _port(sp, gp, x, u, g)
    return port, _reference(F64, gp, x, u, port["inputs"])


@pytest.mark.parametrize("part", [["step", "plant"], ["jacobians"], ["gp_mean", "gp_var"],
                                  ["u0", "plan", "duals", "rho", "sigma", "window"]],
                         ids=["step_and_plant", "jacobians", "gp", "cycle"])
def test_port_matches_the_float64_reference(answers, part):
    port, ref = answers
    gaps = _gaps(port, ref)
    assert all(gaps[k] <= TOL[k] for k in part), {k: (gaps[k], TOL[k]) for k in part}


def test_the_cycle_is_the_configured_one(answers):
    """The cycle ran the configured QP: two chunks of 30 (no lane of these
    four passes the test after 30), and the GP's correction is live."""
    port, ref = answers
    assert port["inputs"]["chunks"] == 2
    assert float(port["gp_mean"].abs().max()) > 1e-2
    assert port["y"].shape == (B, CFG["qp_m"]) and bool(torch.isfinite(port["Sigmas"]).all())


def test_tf32_reference_fails_a_tolerance(case, answers):
    sp, gp, x, u, _ = case
    port, ref = answers
    tf32 = _reference(TF32, gp, x, u, port["inputs"])
    gaps = _gaps(tf32, ref)
    assert any(gaps[k] > TOL[k] for k in TOL), gaps


def test_pretrained_gp_posterior_is_float64_against_the_reference():
    """Path D's fitted GP holds its factors in float64 and answers in the
    states' dtype: its gated mean and variances lie within the features'
    float32 rounding of the reference's posterior from its own weights
    (which float32 factors of a tuned, near-singular K_uu do not)."""
    from gpmpc_tpu_torch.learning import pretrain_gp_6dof

    sp = sixdof_path("cpu")
    gp, mean_fn, var_fn = pretrain_gp_6dof(torch.Generator().manual_seed(4), sp.params,
                                           sp.F_true, 0.1, 2, 6, n_inducing=8, tune_steps=3,
                                           device="cpu")
    assert gp.trans_gp.Luu_inv.dtype == gp.rot_gp.LB_inv.dtype == torch.float64
    x, u = _states(torch.Generator().manual_seed(8), 6)
    x[:, 1] = gp.trans_buffer.X[:6, 11]  # altitudes the data holds
    mean, var = mean_fn(x, u), var_fn(x, u)
    assert mean.dtype == var.dtype == torch.float32
    ref = gp6dof.from_weights(F64, weights(gp), "cpu")
    # the features are computed from f32 states in f32 (~1e-7 of their size)
    assert _rel(mean, ref.gated_mean(x.double(), u.double())) <= 1e-6
    assert _rel(var, ref.variance(x.double(), u.double())) <= 1e-6


@pytest.mark.parametrize("part", ["trans", "rot"])
def test_reference_gp_fit_is_the_programs_fit_in_float64(part):
    """The reference makes the cell's GP from flown states and controls. The
    program's targets of the same transitions (its plant and nominal steps
    in float32, ``ResidualCollector``) lie within their float32 cancellation
    of the reference's (states ~20, one ulp 2e-6, over dt 0.1); on the
    reference's targets, the program's own pipeline run in float64 gives
    the same features, the same k-means centroids from the same start rows,
    the same initial hyperparameters and, after 20 Adam steps of its
    ``tune_mle``, the same tuned ones: each to a few hundred ulps of float64
    (the two sum their distances in another order)."""
    from gpmpc_tpu_torch.gp.online_update import ResidualCollector
    from gpmpc_tpu_torch.gp.sparse_gp import init_inducing_points
    from gpmpc_tpu_torch.gp.structured_gp import _data_lengthscales
    from gpmpc_tpu_torch.learning.hyperparameter_tuner import HyperparameterConfig, tune_mle

    g = torch.Generator().manual_seed(29)
    sp = sixdof_path("cpu")
    n, M, steps = 48, 12, 20
    X, U = _states(g, n)
    X[:3, 1] = 0.05  # three touched-down rows: the flight froze them
    X64, U64 = X.double(), U.double()
    cfg = dict(CFG, gp=dict(CFG["gp"], tune_steps=steps))
    idx = (torch.randperm(n, generator=g)[:M], torch.randperm(n, generator=g)[:M])
    ref = gp6dof.make_weights(F64, cfg, X, U, idx)[part]
    x_next = torch.where((X[:, 1] <= 0.1)[:, None], X, sp.F_true(X, U))
    res32 = ResidualCollector(dt=CFG["dt"]).collect_batch(sp.F, X, U, x_next)
    res = gp6dof.targets(F64, CFG, X, U)
    assert _rel(res32, res) <= 1e-4
    gp = StructuredRocketGP.create(StructuredGPConfig(max_data_points=n, n_inducing=M),
                                   device="cpu")
    ex, cols, start = ((gp.trans_extractor, slice(0, 3), idx[0]) if part == "trans"
                       else (gp.rot_extractor, slice(3, 6), idx[1]))
    F, Y = ex.extract(X64, U64), res[:, cols].T.contiguous()
    mask = torch.ones(n, dtype=torch.bool)
    Z = init_inducing_points(F, M, mask=mask, init_idx=start)
    d = F.shape[1]
    k0 = SquaredExponentialARD(log_variance=torch.zeros(3, dtype=torch.float64),
                               log_lengthscales=torch.log(_data_lengthscales(F, mask))
                               .expand(3, d).contiguous())
    ln0 = torch.full((3,), math.log(CFG["gp"]["noise_std"]), dtype=torch.float64)
    k, ln, _ = tune_mle(HyperparameterConfig(steps=steps), k0, Z, F, Y, mask, ln0)
    gaps = {"Y": _rel(Y, ref["Y"]), "X": _rel(F, ref["X"]), "Z": _rel(Z, ref["Z"]),
            "log_lengthscales": _rel(k.log_lengthscales, ref["log_lengthscales"]),
            "log_variance": _rel(k.log_variance[:, None], ref["log_variance"][:, None]),
            "log_noise": _rel(ln[:, None], ref["log_noise"][:, None])}
    assert all(v <= 1e-10 for v in gaps.values()), gaps
    # the tuning moved the hyperparameters: the comparison is of a real fit
    assert _rel(k.log_lengthscales, k0.log_lengthscales) > 1e-2


def test_the_reference_factors_in_the_gps_own_precision():
    """A near-singular K_uu factors plainly in float64 and takes the retry
    jitter in float32, as the program's ``robust_cholesky`` decides it."""
    z = torch.linspace(0.0, 1.0, 24, dtype=torch.float64)[:, None]
    K = torch.exp(-0.5 * (z - z.T) ** 2 / 4.0) + 1e-9 * torch.eye(24, dtype=torch.float64)
    _, bad64 = gp6dof.factor(K[None])
    _, bad32 = gp6dof.factor(K[None].float())
    assert not bool(bad64.any()) and bool(bad32.all())
