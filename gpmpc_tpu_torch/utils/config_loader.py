"""YAML → config-object loader (counterpart of
``gpmpc_tpu/utils/config_loader.py``): reads the four ``config/*.yaml``
schemas and builds the port's configuration dataclasses, with dot-path
overrides for command-line flags.

The YAML is read by :func:`load_yaml`, a reader of the subset of YAML those
files use — nested block maps by indentation, plain and quoted scalars
(YAML 1.1 core resolution: null, booleans, ints, floats, strings), flow
lists of scalars, comments — so the port needs no YAML package. Anything
outside that subset raises ``ValueError``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device

# YAML 1.1 plain-scalar resolution as PyYAML's safe loader does it
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                               "OFF")}}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|^[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")


def _strip_comment(line: str) -> str:
    """The line without a comment: '#' at its start or after a space, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str) -> Any:
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if _NULL.match(s):
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s[0] == "-" else float("inf")
    if _NAN.match(s):
        return float("nan")
    if s[:1] in "[{&*!|>%@`":
        raise ValueError(f"YAML outside the supported subset: {s!r}")
    return s


def _value(text: str) -> Any:
    s = text.strip()
    if s.startswith("["):
        if not s.endswith("]") or "[" in s[1:] or "{" in s:
            raise ValueError(f"only flow lists of scalars are supported: {s!r}")
        body = s[1:-1].strip()
        return [] if not body else [_scalar(v) for v in body.split(",")]
    return _scalar(s)


# a mapping line: key (plain or quoted), colon, value
_KEY = re.compile(r"^('[^']*'|\"[^\"]*\"|[^:'\"][^:]*?):(?:\s+(.*))?$")


def _block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Dict[str, Any], int]:
    """The map whose keys stand at ``indent`` from line i on; returns it and
    the index of the first line after it."""
    node: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] >= indent:
        ind, line = lines[i]
        if ind != indent:
            raise ValueError(f"bad indentation at {line!r}")
        if line.startswith("- ") or line == "-":
            raise ValueError(f"block sequences are not supported: {line!r}")
        m = _KEY.match(line)
        if not m:
            raise ValueError(f"not a mapping line: {line!r}")
        key, rest = _scalar(m.group(1)), m.group(2)
        i += 1
        if rest:
            node[key] = _value(rest)
        elif i < len(lines) and lines[i][0] > indent:
            node[key], i = _block(lines, i, lines[i][0])
        else:
            node[key] = None
    return node, i


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse the supported subset of YAML (see the module docstring)."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        line = _strip_comment(raw)
        if line.strip() in ("", "---"):
            continue
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return {}
    root, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return root


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_yaml(f.read())


def apply_overrides(cfg: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Apply {'a.b.c': value} dot-path overrides (command-line flags)."""
    out = dict(cfg)
    for path, value in overrides.items():
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return out


def build_rocket_params(cfg: Dict[str, Any], device: DeviceLike = "cuda"):
    """rocket_params.yaml → Rocket3DoFParams / Rocket6DoFParams."""
    from ..dynamics import Rocket3DoFParams, Rocket6DoFParams

    model = cfg.get("model", "3dof")
    common = dict(
        m_dry=cfg.get("m_dry", 1.0),
        m_wet=cfg.get("m_wet", 2.0),
        I_sp=cfg.get("I_sp", 30.0),
        g0=cfg.get("g0", 1.0),
        T_min=cfg.get("T_min", 0.3 if model == "3dof" else 1.5),
        T_max=cfg.get("T_max", 5.0 if model == "3dof" else 6.5),
        device=device,
    )
    if model == "3dof":
        if "g_I" in cfg:
            common["gravity"] = tuple(float(v) for v in cfg["g_I"])
        return Rocket3DoFParams(**common)
    for key in ("g_I", "J_B", "r_T_B"):
        if key in cfg:
            common[key] = cfg[key]
    return Rocket6DoFParams(**common)


def build_mpc_config(cfg: Dict[str, Any], gp_raw: Optional[Dict[str, Any]] = None,
                     device: DeviceLike = "cuda"):
    """mpc_params.yaml → RTIConfig / GPMPCConfig. ``gp_raw`` (the parsed
    gp_params.yaml) supplies the uncertainty β block for GP-MPC tightening."""
    from ..mpc import GPMPCConfig, RTIConfig
    from ..ops.qp import ADMMConfig

    solver = cfg.get("solver", {})
    admm = ADMMConfig(
        max_iter=solver.get("max_iter", 100),
        eps_abs=solver.get("eps_abs", 1e-4),
        eps_rel=solver.get("eps_rel", 1e-4),
        polish=solver.get("polish", True),
    )
    kw = {}
    if "Q_diag" in cfg:
        Q = torch.diag(torch.tensor(cfg["Q_diag"], dtype=torch.float32))
        kw["Q"] = Q
        kw["Qf"] = Q * cfg.get("terminal_scale", 10.0)
    if "R_diag" in cfg:
        kw["R"] = torch.diag(torch.tensor(cfg["R_diag"], dtype=torch.float32))
    if cfg.get("x_bound_mask") is not None:
        kw["x_bound_mask"] = tuple(bool(b) for b in cfg["x_bound_mask"])
    base = RTIConfig(N=cfg.get("N", 15), dt=cfg.get("dt", 0.1), admm=admm, device=device, **kw)
    if cfg.get("use_gp", False):
        cc = cfg.get("chance_constraints", {})
        return GPMPCConfig(
            base=base,
            scp_iterations=cfg.get("rti", {}).get("scp_iterations", 3),
            tighten=cc.get("enabled", True),
            confidence=cc.get("confidence", 0.95),
            **build_uncertainty_kwargs(gp_raw or {}),
        )
    return base


def build_gp_config(cfg: Dict[str, Any]):
    """gp_params.yaml → (StructuredGPConfig, OnlineUpdateConfig)."""
    from ..gp import OnlineUpdateConfig, StructuredGPConfig

    hyp = cfg.get("hyperparameters", {}) or {}
    ls = hyp.get("lengthscales", {}) or {}
    as_tuple = lambda v: tuple(float(x) for x in v) if v is not None else None
    gp = StructuredGPConfig(
        max_data_points=cfg.get("max_data_points", 512),
        n_inducing=cfg.get("n_inducing", 100),
        kernel=cfg.get("kernel", "se_ard"),
        method=cfg.get("approximation", "fitc"),
        noise=cfg.get("noise", 1e-4),
        novelty_threshold=cfg.get("novelty_threshold", 0.3),
        trans_lengthscales=as_tuple(ls.get("translational")),
        rot_lengthscales=as_tuple(ls.get("rotational")),
        signal_variance=hyp.get("signal_variance", 1.0),
    )
    online = cfg.get("online", {})
    return gp, OnlineUpdateConfig(
        capacity=online.get("capacity", 512),
        update_interval=online.get("update_interval", 10),
        refit_interval=online.get("refit_interval", 100),
        min_distance=online.get("min_distance", 1e-3),
    )


def build_training_config(cfg: Dict[str, Any]):
    """gp_params.yaml ``training:`` block → HyperparameterConfig."""
    from ..learning import HyperparameterConfig

    tr = cfg.get("training", {}) or {}
    return HyperparameterConfig(
        steps=tr.get("steps", 150),
        learning_rate=tr.get("learning_rate", 0.05),
        retrain_every_episodes=tr.get("retrain_every_episodes", 5),
        method=tr.get("method", "mle"),
    )


def build_uncertainty_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """gp_params.yaml ``uncertainty:`` block → GPMPCConfig β kwargs."""
    un = cfg.get("uncertainty", {}) or {}
    return {
        "beta_method": un.get("beta_method", "quantile"),
        "beta_fixed": un.get("beta_fixed", 2.0),
        "beta_calibration": un.get("beta_calibration", 1.0),
    }


def build_safety_config(cfg: Dict[str, Any], device: DeviceLike = "cuda"):
    """safety_params.yaml → SafetyFilterConfig (with the recovery-policy
    block)."""
    from ..safety import SafetyFilterConfig

    kw = {k: cfg[k] for k in ("u_min", "u_max") if k in cfg}
    filt = cfg.get("filter", {})
    rec = cfg.get("recovery", {}) or {}
    return SafetyFilterConfig(
        N=filt.get("N", 10),
        dt=filt.get("dt", 0.1),
        alpha_margin=filt.get("alpha_margin", 0.9),
        soft=filt.get("soft", True),
        max_consecutive=rec.get("max_consecutive", 10),
        after_max=rec.get("after_max", "continue"),
        device=device,
        **kw,
    )


def build_tube_config(cfg: Dict[str, Any]):
    """safety_params.yaml ``tube:`` block → TubeMPCConfig."""
    from ..safety import TubeMPCConfig

    tube = cfg.get("tube", {}) or {}
    return TubeMPCConfig(
        n_sigma=tube.get("n_sigma", 2.0),
        dt=cfg.get("filter", {}).get("dt", 0.1),
        quantile=tube.get("quantile", 0.95),
    )


def backup_kind(cfg: Dict[str, Any]) -> str:
    """safety_params.yaml ``backup.type`` → create_backup_controller kind."""
    kind = (cfg.get("backup", {}) or {}).get("type", "lqr")
    if kind not in ("lqr", "pd", "braking"):
        raise ValueError(f"unknown backup type {kind!r}")
    return kind


def load_experiment_config(directory: str, overrides: Optional[Dict[str, Any]] = None,
                           device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Load the config directory (rocket/mpc/gp/safety YAML files) into the
    port's configuration objects, their tensors on ``device``."""
    dev = resolve_device(device)
    paths = {"rocket": "rocket_params.yaml", "mpc": "mpc_params.yaml",
             "gp": "gp_params.yaml", "safety": "safety_params.yaml"}
    raw = {}
    for key, fname in paths.items():
        p = os.path.join(directory, fname)
        raw[key] = load_yaml(p) if os.path.exists(p) else {}
    if overrides:
        raw = apply_overrides(raw, overrides)
    out: Dict[str, Any] = {}
    out["rocket_params"] = build_rocket_params(raw["rocket"], dev)
    out["mpc_config"] = build_mpc_config(raw["mpc"], gp_raw=raw["gp"], device=dev)
    out["gp_config"], out["online_config"] = build_gp_config(raw["gp"])
    out["training_config"] = build_training_config(raw["gp"])
    out["safety_config"] = build_safety_config(raw["safety"], dev)
    out["tube_config"] = build_tube_config(raw["safety"])
    out["backup_kind"] = backup_kind(raw["safety"])
    out["raw"] = raw
    return out
