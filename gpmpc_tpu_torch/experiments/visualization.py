"""Publication plotting: trajectories, Monte-Carlo scatter, GP diagnostics
(counterpart of ``gpmpc_tpu/experiments/visualization.py``): the
publication matplotlib style and colorblind palette, 2D/3D trajectory and
state-history plots, the landing scatter with its dispersion ellipse, the
outcome histogram and fuel distribution, GP prediction bands and learning
curves, the 4-panel summary figure and the ablation figure.

Every plot takes tensors (on any device) or arrays and moves them to NumPy
on the host. Matplotlib is imported inside ``_plt()``, so headless campaign
jobs never pay for it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

# Okabe-Ito colorblind-safe hues, ordered so adjacent pairs differ in
# both hue and lightness; the very light pink is excluded from the cycle
# (insufficient contrast on a white publication surface).
COLORBLIND_PALETTE = [
    "#0173B2", "#DE8F05", "#029E73", "#D55E00",
    "#CC78BC", "#CA9161", "#949494",
]

# Semantic assignment: color follows the CONTROLLER identity, in fixed order
# (never repainted when a subset is plotted).
COLORS = {
    "gp_mpc": "#0173B2",     # blue
    "nominal": "#DE8F05",    # orange
    "lqr": "#029E73",        # green
    "tube_mpc": "#CC78BC",   # pink
    "safety": "#D55E00",     # vermillion
    "reference": "#949494",  # gray
    "success": "#0173B2",
    "failure": "#D55E00",
}


def publication_style() -> dict:
    """The publication rcParams:
    serif text, 300-dpi savefig, recessive grid, thin lines, plus the
    colorblind cycle. Returns the dict so callers can tweak before applying;
    ``_plt()`` applies it for every figure in this module."""
    import matplotlib

    return {
        "font.family": "serif",
        "font.size": 10,
        "axes.labelsize": 11,
        "axes.titlesize": 12,
        "legend.fontsize": 9,
        "xtick.labelsize": 9,
        "ytick.labelsize": 9,
        "figure.dpi": 150,
        "savefig.dpi": 300,
        "savefig.bbox": "tight",
        "axes.grid": True,
        "grid.alpha": 0.3,
        "lines.linewidth": 1.5,
        "axes.prop_cycle": matplotlib.cycler(color=COLORBLIND_PALETTE),
    }


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update(publication_style())
    return plt


class TrajectoryVisualizer:
    """2D/3D trajectory and state-history plots."""

    def plot_trajectory_2d(self, X, ax=None, label=None):
        plt = _plt()
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 4))
        X = _np(X)
        ax.plot(X[:, 2], X[:, 1], label=label)
        ax.plot(X[0, 2], X[0, 1], "o", color="k", ms=4)
        ax.plot(0, 0, "x", color="r", ms=8)
        ax.set_xlabel("crossrange y [m]")
        ax.set_ylabel("altitude [m]")
        if label:
            ax.legend()
        return ax

    def plot_trajectory_3d(self, X, ax=None):
        plt = _plt()
        if ax is None:
            fig = plt.figure(figsize=(5, 4))
            ax = fig.add_subplot(projection="3d")
        X = _np(X)
        ax.plot(X[:, 2], X[:, 3], X[:, 1])
        ax.scatter([0], [0], [0], color="r", marker="x")
        ax.set_xlabel("y")
        ax.set_ylabel("z")
        ax.set_zlabel("altitude")
        return ax

    def plot_state_history(self, X, U=None, dt: float = 0.1, fig=None):
        plt = _plt()
        X = _np(X)
        t = np.arange(X.shape[0]) * dt
        n = 4 if U is not None else 3
        fig, axes = plt.subplots(n, 1, figsize=(5, 2 * n), sharex=True)
        axes[0].plot(t, X[:, 1]); axes[0].set_ylabel("altitude [m]")
        axes[1].plot(t, X[:, 4:7]); axes[1].set_ylabel("velocity [m/s]")
        axes[2].plot(t, X[:, 0]); axes[2].set_ylabel("mass")
        if U is not None:
            U = _np(U)
            axes[3].plot(t[: U.shape[0]], U); axes[3].set_ylabel("thrust")
        axes[-1].set_xlabel("time [s]")
        return fig


class MonteCarloVisualizer:
    """Campaign plots."""

    def plot_landing_scatter(self, results: Dict, ax=None):
        plt = _plt()
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 4))
        xf = _np(results["x_final"])
        outcome = _np(results["outcome"])
        ok = outcome == 0
        ax.scatter(xf[ok, 2], xf[ok, 3], s=8, label="success")
        ax.scatter(xf[~ok, 2], xf[~ok, 3], s=8, marker="x", label="failure")
        # 3σ dispersion ellipse over successful landings
        if ok.sum() > 2:
            pts = xf[ok][:, 2:4]
            mu = pts.mean(0)
            cov = np.cov(pts.T)
            evals, evecs = np.linalg.eigh(cov)
            theta = np.linspace(0, 2 * np.pi, 100)
            circ = np.stack([np.cos(theta), np.sin(theta)])
            ell = mu[:, None] + evecs @ (3.0 * np.sqrt(np.maximum(evals, 0))[:, None] * circ)
            ax.plot(ell[0], ell[1], "--", color="k", lw=1, label="3σ")
        ax.set_xlabel("y [m]"); ax.set_ylabel("z [m]"); ax.legend()
        ax.set_aspect("equal")
        return ax

    def plot_outcome_histogram(self, results: Dict, ax=None):
        plt = _plt()
        from .monte_carlo import OUTCOME_NAMES

        if ax is None:
            _, ax = plt.subplots(figsize=(4, 3))
        outcome = _np(results["outcome"])
        names, counts = [], []
        for code, name in OUTCOME_NAMES.items():
            names.append(name)
            counts.append(int((outcome == code).sum()))
        ax.bar(names, counts)
        ax.tick_params(axis="x", rotation=45)
        ax.set_ylabel("runs")
        return ax

    def plot_fuel_distribution(self, results: Dict, ax=None):
        plt = _plt()
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 3))
        ok = _np(results["outcome"]) == 0
        ax.hist(_np(results["fuel_used"])[ok], bins=20)
        ax.set_xlabel("fuel used"); ax.set_ylabel("runs")
        return ax


class GPVisualizer:
    """GP prediction-band and learning-curve plots."""

    def plot_prediction_band(self, x, mean, std, y_true=None, ax=None):
        plt = _plt()
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 3))
        x, mean, std = map(_np, (x, mean, std))
        ax.plot(x, mean, label="GP mean")
        ax.fill_between(x, mean - 2 * std, mean + 2 * std, alpha=0.25, label="±2σ")
        if y_true is not None:
            ax.plot(x, _np(y_true), "--", label="truth")
        ax.legend()
        return ax

    def plot_learning_curve(self, episode_costs: Sequence[float], ax=None):
        plt = _plt()
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 3))
        ax.plot(np.arange(len(episode_costs)), episode_costs, "-o", ms=3)
        ax.set_xlabel("episode"); ax.set_ylabel("episode cost")
        return ax


def create_summary_figure(results: Dict, X_example=None, dt: float = 0.1,
                          path: Optional[str] = None):
    """4-panel campaign summary."""
    plt = _plt()
    fig = plt.figure(figsize=(9, 7))
    mc = MonteCarloVisualizer()
    ax1 = fig.add_subplot(2, 2, 1)
    mc.plot_landing_scatter(results, ax1)
    ax2 = fig.add_subplot(2, 2, 2)
    mc.plot_outcome_histogram(results, ax2)
    ax3 = fig.add_subplot(2, 2, 3)
    mc.plot_fuel_distribution(results, ax3)
    ax4 = fig.add_subplot(2, 2, 4)
    if X_example is not None:
        TrajectoryVisualizer().plot_trajectory_2d(X_example, ax4)
    fig.tight_layout()
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def create_ablation_figure(results: Dict, path: Optional[str] = None):
    """Two-panel ablation figure: horizontal
    success-rate bars (the magnitude-comparison form) and fuel-used bars with
    spread, one row per configuration. ``results`` is the dict returned by
    :meth:`AblationStudy.run` (name → AblationResult).

    The full configuration keeps the primary series hue; every ablated
    configuration wears the neutral comparison hue (color marks the ENTITY
    class — full vs ablated — not the bar's rank)."""
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8.0, 0.45 * max(len(results), 6) + 1.5))
    names = list(results)
    ms = [results[n].metrics for n in names]
    colors = [COLORS["gp_mpc"] if n == "full" else COLORS["reference"]
              for n in names]
    y = np.arange(len(names))[::-1]  # full on top

    rates = [100.0 * m.success_rate for m in ms]
    ax1.barh(y, rates, color=colors, height=0.62)
    for yi, v in zip(y, rates):
        ax1.text(min(v + 1.5, 97.0), yi, f"{v:.0f}", va="center", fontsize=8)
    ax1.set_yticks(y, names)
    ax1.set_xlim(0, 105)
    ax1.set_xlabel("success rate [%]")
    ax1.set_title("(a) Ablation: success")
    ax1.grid(axis="y", visible=False)

    fuels = [m.fuel_mean for m in ms]
    stds = [m.fuel_std for m in ms]
    ax2.barh(y, fuels, xerr=stds, color=colors, height=0.62,
             error_kw={"elinewidth": 1.0, "capsize": 2.0})
    ax2.set_yticks(y, ["" for _ in names])
    ax2.set_xlabel("fuel used [kg]")
    ax2.set_title("(b) Ablation: fuel")
    ax2.grid(axis="y", visible=False)

    fig.tight_layout()
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig
