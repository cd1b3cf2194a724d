"""Set-up shared by the drivers: the program's configured path, checked
against the configuration's file, and its inputs made from the seed."""

from __future__ import annotations

import torch

from ..core import draws
from ..core.cell import Cell


def _expect(what: str, got, want) -> None:
    if got != want:
        raise SystemExit(f"the program's {what} is {got!r}, the configuration file says {want!r}")


def gpmpc_path(cell: Cell):
    """The main path and its exploration GP made from the seed. Returns
    (path, mean_fn, var_fn, generator, the GP's draws)."""
    from gpmpc_tpu_torch import main_path as paths
    from gpmpc_tpu_torch.learning import explore_gp_3dof

    c, dev = cell.config, cell.device
    mp = getattr(paths, c["program_path"])(dev)
    base = mp.config.base
    _expect("horizon", base.N, c["N"])
    _expect("time step", base.dt, c["dt"])
    _expect("SCP iterations", mp.config.scp_iterations, c["scp_iterations"])
    _expect("ADMM iterations", (base.admm.max_iter, base.admm.check_interval),
            (c["admm"]["iterations"],) * 2)
    _expect("Ruiz passes", base.admm.scaling, c["admm"]["scaling"])
    _expect("acceptance tolerance", base.accept_pri_tol, c["accept_pri_tol"])
    _expect("state-bound rows", any(base.x_bound_mask or (True,)), False)
    gen = draws.generator(cell.seed, dev)
    g = c["gp"]
    excitation, init_idx = draws.exploration(gen, g["points"], g["inducing"])
    _, mean_fn, var_fn = explore_gp_3dof(None, None, mp.params, mp.F_true, dt=c["dt"],
                                         n_points=g["points"], n_inducing=g["inducing"],
                                         device=dev, excitation=excitation, init_idx=init_idx)
    return mp, mean_fn, var_fn, gen, {"excitation": excitation, "init_idx": init_idx}


def scvx_path(cell: Cell, dts_key: str):
    """The SCVX library path with the configuration's settings, and the
    candidate time steps the traffic names."""
    from gpmpc_tpu_torch import main_path as paths

    c, dev = cell.config, cell.device
    lp = getattr(paths, c["program_path"])(dev)
    cfg = lp.config.replace(iterations=c["iterations"],
                            admm=lp.config.admm.replace(max_iter=c["admm"]["max_iter"]))
    _expect("horizon", cfg.N, c["N"])
    _expect("ADMM chunk", cfg.admm.check_interval, c["admm"]["check_interval"])
    _expect("Ruiz passes", cfg.admm.scaling, c["admm"]["scaling"])
    _expect("acceptance tolerance", cfg.accept_pri_tol, c["accept_pri_tol"])
    lo, hi, count = c[dts_key]
    count = cell.traffic.get("dts_count", count)
    dts = torch.linspace(lo, hi, count, device=dev)
    return lp._replace(config=cfg, dt_candidates=dts), dts
