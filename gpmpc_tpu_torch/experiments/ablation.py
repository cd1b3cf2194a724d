"""Ablation studies and hyperparameter sweeps over controller components
(counterpart of ``gpmpc_tpu/experiments/ablation.py``): the component
flags, factory-kwargs controller creation, the full → leave-one-out →
pairwise → minimal sweeps, impact and interaction tables, the LaTeX table,
the hyperparameter grid sweep and the quick with/without-GP comparison.
Every configuration is one lanes-first ``run_campaign`` over the same
initial states.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations, product
from typing import Callable, Dict, Optional, Sequence

from .analysis import PerformanceMetrics, compute_improvement
from .monte_carlo import LandingCriteria, SimulationConfig, run_campaign

# component flags
GP_MODEL = "gp_model"
SAFETY_FILTER = "safety_filter"
TERMINAL_SET = "terminal_set"
ONLINE_LEARNING = "online_learning"
UNCERTAINTY_PROP = "uncertainty_prop"
WARM_START = "warm_start"

ALL_COMPONENTS = (
    GP_MODEL, SAFETY_FILTER, TERMINAL_SET, ONLINE_LEARNING,
    UNCERTAINTY_PROP, WARM_START,
)


@dataclass
class AblationResult:
    config_name: str
    enabled: tuple
    metrics: PerformanceMetrics


class AblationStudy:
    """Runs a controller factory under different component subsets.

    ``controller_factory(**{component: bool}) → (cinit, cstep)`` — the
    factory decides what each flag means.
    """

    def __init__(
        self,
        controller_factory: Callable,
        plant_step: Callable,
        sim: SimulationConfig,
        criteria: Optional[LandingCriteria] = None,
        components: Sequence[str] = ALL_COMPONENTS,
    ):
        self.factory = controller_factory
        self.plant_step = plant_step
        self.sim = sim
        self.criteria = criteria or LandingCriteria()
        self.components = tuple(components)

    def _run(self, name: str, enabled: Sequence[str], x0s) -> AblationResult:
        flags = {c: (c in enabled) for c in self.components}
        cinit, cstep = self.factory(**flags)
        res = run_campaign(cinit, cstep, self.plant_step, x0s, self.sim, self.criteria)
        return AblationResult(
            config_name=name,
            enabled=tuple(enabled),
            metrics=PerformanceMetrics.from_results(name, res),
        )

    def run_full(self, x0s) -> AblationResult:
        return self._run("full", self.components, x0s)

    def run_leave_one_out(self, x0s) -> Dict[str, AblationResult]:
        """Drop each component in turn."""
        out = {}
        for drop in self.components:
            enabled = tuple(c for c in self.components if c != drop)
            out[f"no_{drop}"] = self._run(f"no_{drop}", enabled, x0s)
        return out

    def run_minimal(self, x0s) -> AblationResult:
        return self._run("minimal", (), x0s)

    def run_pairwise(self, x0s) -> Dict[str, AblationResult]:
        """Drop each PAIR of components (interaction effects)."""
        out = {}
        for c1, c2 in combinations(self.components, 2):
            enabled = tuple(c for c in self.components if c not in (c1, c2))
            name = f"no_{c1}+{c2}"
            out[name] = self._run(name, enabled, x0s)
        return out

    def run(self, x0s, pairwise: Optional[bool] = None) -> Dict[str, AblationResult]:
        """Full sweep. ``pairwise=None`` runs the pair sweep only with ≤ 4
        components (C(k,2) campaigns get expensive past that); True/False
        forces it."""
        out = {"full": self.run_full(x0s)}
        out.update(self.run_leave_one_out(x0s))
        if pairwise or (pairwise is None and len(self.components) <= 4):
            out.update(self.run_pairwise(x0s))
        out["minimal"] = self.run_minimal(x0s)
        return out

    @staticmethod
    def impact_table(results: Dict[str, AblationResult]) -> Dict[str, dict]:
        """Per-component impact vs the full configuration."""
        full = results["full"].metrics
        return {
            name: compute_improvement(full, r.metrics)
            for name, r in results.items()
            if name != "full"
        }

    @staticmethod
    def interaction_table(results: Dict[str, AblationResult]) -> Dict[str, dict]:
        """Pairwise interaction effects: for each ``no_{a}+{b}`` config, the
        success-rate delta beyond what the two single ablations predict
        additively (positive superadditive = the components back each other
        up)."""
        full_sr = results["full"].metrics.success_rate
        out = {}
        for name, r in results.items():
            if not name.startswith("no_") or "+" not in name:
                continue
            a, b = name[3:].split("+", 1)
            da = results[f"no_{a}"].metrics.success_rate - full_sr
            db = results[f"no_{b}"].metrics.success_rate - full_sr
            dab = r.metrics.success_rate - full_sr
            out[name] = {
                "pair_delta": dab,
                "additive_prediction": da + db,
                "interaction": dab - (da + db),
            }
        return out

    @staticmethod
    def to_latex_table(results: Dict[str, AblationResult]) -> str:
        """Publication LaTeX table."""
        rows = []
        for name, r in results.items():
            m = r.metrics
            esc = name.replace("_", "\\_")
            rows.append(
                f"{esc} & {100 * m.success_rate:.1f} & "
                f"{m.fuel_mean:.3f} & {m.landing_error_mean * 1e3:.1f} & "
                f"{m.landing_speed_mean:.2f} \\\\"
            )
        return "\n".join(
            [
                r"\begin{table}[h]",
                r"\centering",
                r"\caption{Ablation Study Results}",
                r"\label{tab:ablation}",
                r"\begin{tabular}{lcccc}",
                r"\toprule",
                r"Configuration & Success Rate (\%) & Fuel (kg) & "
                r"Error (mm) & Touchdown (m/s) \\",
                r"\midrule",
                *rows,
                r"\bottomrule",
                r"\end{tabular}",
                r"\end{table}",
            ]
        )


class HyperparameterSweep:
    """Grid sweep over controller hyperparameters.
    ``make_controller(**params) → (cinit, cstep)``."""

    def __init__(self, make_controller: Callable, plant_step: Callable,
                 sim: SimulationConfig, criteria: Optional[LandingCriteria] = None):
        self.make_controller = make_controller
        self.plant_step = plant_step
        self.sim = sim
        self.criteria = criteria or LandingCriteria()

    def run(self, grid: Dict[str, Sequence], x0s) -> list:
        names = list(grid)
        results = []
        for values in product(*(grid[n] for n in names)):
            params = dict(zip(names, values))
            cinit, cstep = self.make_controller(**params)
            res = run_campaign(cinit, cstep, self.plant_step, x0s, self.sim, self.criteria)
            results.append(
                {"params": params,
                 "metrics": PerformanceMetrics.from_results(str(params), res)}
            )
        return results


def run_simple_ablation(
    make_with_gp: Callable, make_without_gp: Callable, plant_step: Callable,
    x0s, sim: SimulationConfig, criteria: Optional[LandingCriteria] = None,
) -> Dict[str, PerformanceMetrics]:
    """Quick with/without-GP comparison."""
    out = {}
    for name, make in (("with_gp", make_with_gp), ("without_gp", make_without_gp)):
        cinit, cstep = make()
        res = run_campaign(cinit, cstep, plant_step, x0s, sim, criteria or LandingCriteria())
        out[name] = PerformanceMetrics.from_results(name, res)
    return out
