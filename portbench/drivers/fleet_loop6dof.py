"""The real-time lockstep loop of the 6-DoF fleet (Path D): every cycle sets
each lane's receding window of its cubic descent reference as the
campaign's controller step does (``make_gp_mpc_controller``), solves every
lane with ``gp_mpc_solve``, reads each lane's u0 to the host (the
actuation), then steps the dispersed plant on the device; landed lanes
freeze; the fleet restarts from new seeded states every ``episode_cycles``
cycles. Each cycle is timed on the host clock from the start of the solve
until u0 is in host memory; cycles under the profiler are left out of the
percentile.

The path is the program's own (``sixdof_path``), every setting the
configuration file states checked against it. Its GP's data are flown by
the program (``collect_residuals_6dof``: the sparse-form 6-DoF RTI
controller's episodes on the dispersed plant); the GP's weights (features,
targets, inducing inputs, tuned hyperparameters) are made from those
states and controls by the plain reference in float64
(``reference/gp6dof.py::make_weights``) and loaded into the program's
``StructuredRocketGP``, which factors them itself. All of this is set-up.

Each sampled cycle's record carries the ADMM chunks the program launched
(``admm_chunk.LAUNCHES``); a CPU run launches no kernel and records 0."""

from __future__ import annotations

import dataclasses
import inspect
import time

import torch

from ..core import draws
from ..core.cell import Cell, Outcome
from ..core.stats import percentile
from ..reference import gp6dof
from ..reference.prec import F64
from .common import _expect


def states(gen: torch.Generator, dist: dict, n: int) -> torch.Tensor:
    """(n, 14) initial states, drawn in the campaign's order (mass, altitude,
    horizontal offsets, vertical velocity, horizontal velocities, each for
    all n at once), the mass and altitude floored; identity attitude, zero
    rates."""
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=gen.device)
    m = (dist["mass"][0] + dist["mass"][1] * randn(n)).clamp_min(dist["mass_floor"])
    h = (dist["altitude"][0] + dist["altitude"][1] * randn(n)).clamp_min(dist["altitude_floor"])
    r = dist["horizontal"] * randn(n, 2)
    vv = dist["vertical_velocity"][0] + dist["vertical_velocity"][1] * randn(n)
    vh = dist["horizontal_velocity"] * randn(n, 2)
    att = torch.zeros(n, 7, device=gen.device)
    att[:, 0] = 1.0
    return torch.cat([m[:, None], h[:, None], r, vv[:, None], vh, att], 1)


def _check_path(c: dict, sp) -> None:
    """Every setting of the configuration file against the program's path."""
    from gpmpc_tpu_torch import main_path as paths
    from gpmpc_tpu_torch.dynamics import rocket6dof as r6
    from gpmpc_tpu_torch.learning.hyperparameter_tuner import HyperparameterConfig
    from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg, _n_rows
    from gpmpc_tpu_torch.ops.kmeans import kmeans

    cfg, base = sp.config, sp.config.base
    a, ca = base.admm, c["admm"]
    _expect("horizon", base.N, c["N"])
    _expect("time step", base.dt, c["dt"])
    _expect("state and control sizes", (base.n_x, base.n_u), (c["n_x"], c["n_u"]))
    _expect("SCP iterations", cfg.scp_iterations, c["scp_iterations"])
    _expect("GP tape and tightening",
            (cfg.augment_rollout, cfg.rollout_gp_tape, cfg.tighten, cfg.beta_method,
             cfg.tighten_mask, cfg.warm_kkt), (True, True, True, "quantile", None, False))
    _expect("confidence and Σ₀", (cfg.confidence, cfg.sigma0_scale),
            (c["confidence"], c["sigma0"]))
    _expect("trust regions", (cfg.trust_region_x, cfg.trust_region_u),
            (c["trust_x"], c["trust_u"]))
    _expect("ADMM schedule", (a.max_iter, a.check_interval, a.early_exit),
            (ca["iterations"], ca["chunk"], True))
    _expect("ADMM settings",
            (a.scaling, a.rho, a.sigma, a.alpha, a.eps_abs, a.eps_rel, a.polish, a.adaptive_rho,
             a.infeas_certs, base.solver),
            (ca["scaling"], ca["rho"], ca["sigma"], ca["alpha"], ca["eps"], ca["eps"],
             ca["polish"], ca["adaptive_rho"], ca["infeas_certs"], "admm"))
    _expect("precision", (a.matvec_dtype, torch.backends.cuda.matmul.allow_tf32),
            ("f32" if c["precision"] == "float32" else c["precision"], c["tf32"]))
    _expect("acceptance tolerance", base.accept_pri_tol, c["accept_pri_tol"])
    _expect("condensed QP", base.condensed, True)
    _expect("state-bound rows", list(base.x_bound_mask), c["x_bound_mask"])
    _expect("declared rows", _condensed_admm_cfg(base).row_structure,
            tuple(tuple(s) for s in c["row_structure"]))
    _expect("QP size", (base.N * base.n_u, _n_rows(base)), (c["qp_n"], c["qp_m"]))
    Q = torch.diag(torch.tensor(c["Q_diag"]))
    _expect("weights", (base.Q.cpu().tolist(), base.Qf.cpu().tolist(), base.R.cpu().tolist()),
            (Q.tolist(), (c["Qf_scale"] * Q).tolist(), (c["R"] * torch.eye(3)).tolist()))
    _expect("control box", (base.u_min.tolist(), base.u_max.tolist()), (c["u_min"], c["u_max"]))
    _expect("state box", (base.x_min.tolist(), base.x_max.tolist()), (c["x_min"], c["x_max"]))
    _expect("target", sp.x_target.tolist(), c["x_target"])
    p, v = sp.params, c["vehicle"]
    _expect("vehicle", (p.I_sp, p.g0, p.J_B.tolist(), p.r_T_B.tolist(), p.r_cp_B.tolist(),
                        p.g_I.tolist(), p.S_ref, p.integrator, p.rho),
            (v["I_sp"], v["g0"], torch.diag(torch.tensor(v["J_B"])).tolist(), v["r_T_B"],
             v["r_cp_B"], v["g_I"], v["S_ref"], v["integrator"], 0.0))
    g, h = c["gp"], HyperparameterConfig()
    _expect("GP fit", (inspect.signature(kmeans).parameters["iters"].default, h.learning_rate,
                       [h.log_lower, h.log_upper]),
            (g["kmeans_iters"], g["tune_step_size"], g["log_bounds"]))
    ref = c["descent_reference"]
    _expect("descent reference", (paths.SIXDOF_REF_STEPS, paths.SIXDOF_STEPS),
            (ref["steps"], ref["ref_horizon"]))
    # the steps as closures: the nominal model and the plant on a probe state
    dev = sp.x_target.device
    x = sp.x_target.clone()
    x[1:7] = torch.tensor([12.0, 0.5, -0.3, -2.0, 0.2, 0.1])
    x[7:14] = torch.tensor([0.99, 0.05, -0.08, 0.1, 0.02, -0.03, 0.01])
    x = r6.normalize_quaternion(x)[None]
    u = torch.tensor([[2.1, 0.1, -0.05]], device=dev)
    pl = c["plant"]
    plant = p.replace(rho=pl["rho"], C_A=torch.diag(torch.tensor(pl["C_A"])))
    wind = torch.tensor(pl["wind"], device=dev)
    _expect("nominal step", torch.equal(sp.F(x, u), r6.step(p, x, u, c["dt"])), True)
    _expect("plant", torch.equal(sp.F_true(x, u), r6.step(plant, x, u, c["dt"]) + c["dt"] * wind),
            True)
    _expect("descent reference rows", sp.reference_fn(x).shape[1], ref["steps"] + 1)


def program_gp(c: dict, weights: dict, dev):
    """The program's structured GP holding ``weights``, its factors computed
    by the program in the configured precision."""
    from gpmpc_tpu_torch.gp import StructuredGPConfig, StructuredRocketGP
    from gpmpc_tpu_torch.gp.kernels import SquaredExponentialARD
    from gpmpc_tpu_torch.gp.sparse_gp import refit_sparse_multi

    g = c["gp"]
    dtype = getattr(torch, g["factors"])
    n, M = weights["trans"]["X"].shape[0], weights["trans"]["Z"].shape[0]
    gp = StructuredRocketGP.create(
        StructuredGPConfig(max_data_points=n, n_inducing=M, kernel=g["kernel"],
                           method=g["method"], noise=g["noise_std"]), device=dev)

    def sub(w):
        t = lambda k: w[k].to(device=dev, dtype=dtype)
        k = SquaredExponentialARD(log_variance=t("log_variance"),
                                  log_lengthscales=t("log_lengthscales"))
        return refit_sparse_multi(k, t("Z"), t("X"), t("Y"),
                                  torch.ones(n, dtype=torch.bool, device=dev), t("log_noise"),
                                  g["method"])

    return dataclasses.replace(gp, trans_gp=sub(weights["trans"]), rot_gp=sub(weights["rot"]),
                               is_fitted=True)


def sixdof_path(cell: Cell):
    """Path D checked against the configuration file, its data flown from
    the seed and its GP made from them. Returns (path, mean_fn, var_fn,
    generator, the GP's data, k-means starts and weights)."""
    from gpmpc_tpu_torch import learning
    from gpmpc_tpu_torch import main_path as paths

    c, dev = cell.config, cell.device
    sp = getattr(paths, c["program_path"])(dev)
    _check_path(c, sp)
    gen = draws.generator(cell.seed, dev)
    g = c["gp"]
    X, U, _ = getattr(learning, c["data_path"])(
        gen, sp.params, sp.F_true, dt=c["dt"], n_episodes=g["episodes"],
        episode_len=g["episode_len"], excitation=g["excitation"], device=dev)
    n = X.shape[0]
    M = min(g["inducing"], n)
    init_idx = tuple(torch.randperm(n, generator=gen, device=gen.device)[:M] for _ in range(2))
    weights = gp6dof.make_weights(F64, c, X, U, init_idx)
    gp = program_gp(c, weights, dev)
    mean_fn, var_fn = learning.gp_fns(gp, g["gated"])
    _expect("GP", (g["kernel"], gp.trans_gp.method, gp.trans_extractor.n_features,
                   gp.rot_extractor.n_features, n, str(gp.trans_gp.Luu_inv.dtype),
                   str(gp.rot_gp.LB_inv.dtype)),
            ("se_ard", g["method"], g["trans_features"], g["rot_features"],
             g["episodes"] * g["episode_len"], f"torch.{g['factors']}", f"torch.{g['factors']}"))
    return sp, mean_fn, var_fn, gen, {"X": X, "U": U, "init_idx": init_idx, "gp": weights}


def run(cell: Cell) -> Outcome:
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    t, c, dev = cell.traffic, cell.config, cell.device
    sp, mean_fn, var_fn, gen, inputs = sixdof_path(cell)
    L, E, episodes = t["lanes"], t["episode_cycles"], t["episodes"]
    x0s = states(gen, t["state_dist"], episodes * L).reshape(episodes, L, 14)
    warm = states(gen, t["state_dist"], L)
    cfg, floor = sp.config, t["landing_altitude"]
    N, horizon = cfg.base.N, c["descent_reference"]["ref_horizon"]

    def start(x):
        """The carry and the padded reference of an episode from x, as the
        controller's init makes them."""
        full = sp.reference_fn(x)
        need = horizon + N + 1
        pad = full[:, -1:].repeat(1, max(need - full.shape[1], 1), 1)
        return gp_mpc_init(cfg, x, sp.x_target, device=dev), torch.cat([full, pad], 1)[:, :need]

    def solve(state, ref, x, k):
        kk = min(k, horizon - 1)
        state = state.replace(x_ref=ref[:, kk:kk + N + 1])
        sol, new_state = gp_mpc_solve(sp.F, mean_fn, var_fn, cfg, state, x)
        return state, sol, new_state

    def plant(x, u0, landed):
        xn = torch.where(landed[:, None], x, sp.F_true(x, u0))
        return xn, landed | (xn[:, 1] < floor)

    (state, ref), x = start(warm), warm
    landed = torch.zeros(L, dtype=torch.bool, device=dev)
    for k in range(t["warmup_cycles"]):
        _, sol, state = solve(state, ref, x, k)
        sol.u0.cpu()
        x, landed = plant(x, sol.u0, landed)

    cg = draws.check_generator(cell.seed)
    ck = t["check"]
    sampled = [0] + draws.sample(cg, ck["cycles"], ck["first_cycle"], ck["last_cycle"])
    lanes = {k: torch.tensor(draws.sample(cg, ck["lanes"], 0, L), device=dev) for k in sampled}
    records = []

    cell.mark_setup_end()
    tracer = cell.tracer
    cycle_s = []
    t0 = time.perf_counter()
    n = 0
    while True:
        k = n % E
        if k == 0:
            x = x_start = x0s[(n // E) % episodes]
            state, ref = start(x)
            landed = torch.zeros(L, dtype=torch.bool, device=dev)
        tracer.before_unit()
        profiled = tracer.active
        launches = K.LAUNCHES
        ts = time.perf_counter()
        solved, sol, new_state = solve(state, ref, x, k)
        sol.u0.cpu()
        if not profiled:
            cycle_s.append(time.perf_counter() - ts)
        x_next, landed_next = plant(x, sol.u0, landed)
        tracer.after_unit()
        if n in lanes:
            records.append({"cycle": n, "k": k, "start": k == 0, "lanes": lanes[n],
                            "state": solved, "x": x, "x_start": x_start, "u0": sol.u0,
                            "new_state": new_state, "Sigmas": sol.Sigmas, "landed": landed,
                            "x_next": x_next, "chunks": K.LAUNCHES - launches})
        state, x, landed = new_state, x_next, landed_next
        n += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    elapsed = time.perf_counter() - t0
    tracer.stop()
    return Outcome(e2e={"cycle_ms_p95": 1e3 * percentile(cycle_s, 95),
                        "lane_cycles_per_s": L * n / elapsed},
                   units=n, records=records, inputs=inputs)
