"""Statistical analysis and result export (counterpart of
``gpmpc_tpu/experiments/analysis.py``): ``PerformanceMetrics`` with Wilson
intervals and fuel percentiles, the two-proportion z-test and Welch's t-test
with Cohen's d, and the LaTeX / CSV / JSON / prose exporters. Statistics are
taken on the host in NumPy from the campaign's per-lane results. The normal
tail comes from the float32 ``erf`` that the JAX package evaluates (its
rational approximation, clamped where it saturates at 1 − 1.79e-7), bit for
bit, so the p-values and the exports read the same: a z-test at z = 7.166
gives p = 1.79e-7, which the script's export rounds to 0.0.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from .monte_carlo import SUCCESS, wilson_interval


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# the float32 erf of the JAX package's CPU backend: x clamped to
# ±erfinv(1 − 2⁻²³), then an odd/even rational approximation evaluated by
# fused multiply-adds (emulated here in float64, which rounds as one FMA)
_ERF_CLAMP = 3.7439211627767994
_ERF_P = (0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
          0.18520832239976145, 1.128379143519084)
_ERF_Q = (-1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
          0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0)


def _erf32(x: torch.Tensor) -> torch.Tensor:
    f32 = torch.float32
    fma = lambda a, b, c: (a.double() * b.double() + c).to(f32)
    x = x.to(f32).clamp(-_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    p = torch.full_like(x, _ERF_P[0])
    for c in _ERF_P[1:]:
        p = fma(x2, p, torch.tensor(c, dtype=f32).double())
    q = torch.full_like(x, _ERF_Q[0])
    for c in _ERF_Q[1:]:
        q = fma(x2, q, torch.tensor(c, dtype=f32).double())
    return (x * p) / q


def _norm_sf(z: float) -> float:
    """Upper normal tail of |z| in float32, as the JAX package takes it."""
    z32 = torch.tensor(abs(z), dtype=torch.float32)
    return float(0.5 * (1.0 - _erf32(z32 / torch.tensor(math.sqrt(2.0), dtype=torch.float32))))


@dataclass
class PerformanceMetrics:
    """Per-controller campaign metrics."""

    name: str
    n_runs: int
    successes: int
    success_rate: float
    ci_low: float
    ci_high: float
    fuel_mean: float
    fuel_std: float
    fuel_median: float
    fuel_iqr: float
    landing_speed_mean: float
    landing_error_mean: float
    extras: dict = field(default_factory=dict)

    @classmethod
    def from_results(cls, name: str, results: Dict) -> "PerformanceMetrics":
        """From a campaign's per-lane results (tensors on any device, or
        arrays); a campaign without a success has NaN touchdown metrics and
        zero fuel statistics."""
        outcome = _np(results["outcome"])
        ok = outcome == SUCCESS
        n = outcome.shape[0]
        succ = int(ok.sum())
        lo, hi = wilson_interval(float(succ), float(n))
        fuel = _np(results["fuel_used"])[ok] if succ else np.zeros(1)
        q1, med, q3 = np.percentile(fuel, [25, 50, 75]) if succ else (0, 0, 0)
        return cls(
            name=name,
            n_runs=n,
            successes=succ,
            success_rate=succ / max(n, 1),
            ci_low=float(lo),
            ci_high=float(hi),
            fuel_mean=float(fuel.mean()),
            fuel_std=float(fuel.std()),
            fuel_median=float(med),
            fuel_iqr=float(q3 - q1),
            landing_speed_mean=float(_np(results["landing_speed"])[ok].mean())
            if succ else float("nan"),
            landing_error_mean=float(_np(results["landing_error"])[ok].mean())
            if succ else float("nan"),
        )


def two_proportion_z_test(s1: int, n1: int, s2: int, n2: int) -> dict:
    """Success-rate comparison of two campaigns."""
    p1, p2 = s1 / max(n1, 1), s2 / max(n2, 1)
    p = (s1 + s2) / max(n1 + n2, 1)
    se = np.sqrt(max(p * (1 - p) * (1 / max(n1, 1) + 1 / max(n2, 1)), 1e-12))
    z = (p1 - p2) / se
    pval = 2.0 * _norm_sf(float(z))
    return {"z": float(z), "p_value": pval, "significant_05": pval < 0.05, "p1": p1, "p2": p2}


def welch_t_test(a, b) -> dict:
    """Welch's t-test and Cohen's d, with the normal approximation for the
    p-value (campaign samples are large)."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    na, nb = len(a), len(b)
    va, vb = a.var(ddof=1) if na > 1 else 0.0, b.var(ddof=1) if nb > 1 else 0.0
    se = np.sqrt(max(va / max(na, 1) + vb / max(nb, 1), 1e-12))
    t = (a.mean() - b.mean()) / se
    pooled = np.sqrt(max((va * (na - 1) + vb * (nb - 1)) / max(na + nb - 2, 1), 1e-12))
    d = (a.mean() - b.mean()) / pooled
    pval = 2.0 * _norm_sf(float(t))
    return {"t": float(t), "p_value": pval, "cohens_d": float(d), "significant_05": pval < 0.05}


def compute_improvement(base: PerformanceMetrics, new: PerformanceMetrics) -> dict:
    """Relative deltas of ``new`` against ``base``."""
    def rel(a, b):
        return (b - a) / abs(a) if a else float("inf")

    return {
        "success_rate_delta": new.success_rate - base.success_rate,
        "fuel_rel_change": rel(base.fuel_mean, new.fuel_mean),
        "landing_error_rel_change": rel(base.landing_error_mean, new.landing_error_mean),
    }


class StatisticalAnalyzer:
    """Facade over the metrics and the tests."""

    def metrics(self, name: str, results: Dict) -> PerformanceMetrics:
        return PerformanceMetrics.from_results(name, results)

    def compare_success(self, m1: PerformanceMetrics, m2: PerformanceMetrics) -> dict:
        return two_proportion_z_test(m1.successes, m1.n_runs, m2.successes, m2.n_runs)

    def compare_fuel(self, r1: Dict, r2: Dict) -> dict:
        ok1 = _np(r1["outcome"]) == SUCCESS
        ok2 = _np(r2["outcome"]) == SUCCESS
        return welch_t_test(_np(r1["fuel_used"])[ok1], _np(r2["fuel_used"])[ok2])


class ResultsExporter:
    """LaTeX / CSV / JSON / prose exporters."""

    def to_latex(self, metrics: list) -> str:
        rows = [
            r"\begin{tabular}{lrrrrr}",
            r"\toprule",
            r"Controller & Runs & Success & 95\% CI & Fuel & Err [m] \\",
            r"\midrule",
        ]
        for m in metrics:
            rows.append(
                f"{m.name} & {m.n_runs} & {m.success_rate:.1%} & "
                f"[{m.ci_low:.2f}, {m.ci_high:.2f}] & "
                f"{m.fuel_mean:.3f}$\\pm${m.fuel_std:.3f} & "
                f"{m.landing_error_mean:.3f} \\\\"
            )
        rows += [r"\bottomrule", r"\end{tabular}"]
        return "\n".join(rows).replace("%", r"\%")

    def to_csv(self, metrics: list) -> str:
        hdr = ("name,n_runs,successes,success_rate,ci_low,ci_high,"
               "fuel_mean,fuel_std,fuel_median,fuel_iqr,"
               "landing_speed_mean,landing_error_mean")
        rows = [hdr] + [
            f"{m.name},{m.n_runs},{m.successes},{m.success_rate:.6f},"
            f"{m.ci_low:.6f},{m.ci_high:.6f},{m.fuel_mean:.6f},{m.fuel_std:.6f},"
            f"{m.fuel_median:.6f},{m.fuel_iqr:.6f},{m.landing_speed_mean:.6f},"
            f"{m.landing_error_mean:.6f}"
            for m in metrics
        ]
        return "\n".join(rows)

    def to_json(self, metrics: list) -> str:
        return json.dumps([m.__dict__ for m in metrics], indent=2, default=str)

    def to_prose(self, metrics: list) -> str:
        return "\n".join(
            f"{m.name}: {m.successes}/{m.n_runs} landings succeeded "
            f"({m.success_rate:.1%}, 95% CI [{m.ci_low:.1%}, {m.ci_high:.1%}]); "
            f"successful runs used {m.fuel_mean:.3f}±{m.fuel_std:.3f} fuel "
            f"and landed {m.landing_error_mean:.2f} m from the pad at "
            f"{m.landing_speed_mean:.2f} m/s."
            for m in metrics
        )


def generate_summary_report(metrics: list) -> str:
    """Prose and CSV summary."""
    exp = ResultsExporter()
    return exp.to_prose(metrics) + "\n\n" + exp.to_csv(metrics)
