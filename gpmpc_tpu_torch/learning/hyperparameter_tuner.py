"""GP hyperparameter tuning (counterpart of the maximum-likelihood part of
``gpmpc_tpu/learning/hyperparameter_tuner.py``): Adam in log space on the
analytic sparse-GP marginal likelihood, gradients by autograd.

The kernel parameters may carry a leading output axis (the stacked kernels of
a multi-output GP): every output is then tuned on its own objective with its
own optimizer state, as the JAX package does by ``vmap``-ing ``tune_mle``
over the outputs. ``tune_map``, ``tune_cv_random`` and the scheduler classes
are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..gp.kernels import SquaredExponentialARD
from ..gp.sparse_gp import sparse_lml


@dataclass(frozen=True)
class HyperparameterConfig:
    """Field names and defaults are those of the JAX ``HyperparameterConfig``."""

    steps: int = 150
    learning_rate: float = 0.05
    retrain_every_episodes: int = 5
    method: str = "mle"
    # MAP log-normal prior on each log-hyperparameter
    prior_mean: float = 0.0
    prior_std: float = 1.0
    # bounds in log space (applied by clipping after each step)
    log_lower: float = -6.0
    log_upper: float = 6.0


def tune_mle(config: HyperparameterConfig, kernel: SquaredExponentialARD, Z, X, y, mask,
             log_noise, method: str = "fitc"
             ) -> Tuple[SquaredExponentialARD, torch.Tensor, torch.Tensor]:
    """Maximum-likelihood tuning. One output (``y`` (cap,), scalar
    ``log_noise``, unstacked kernel) or several (``y`` (n_out, cap),
    ``log_noise`` (n_out,), stacked kernel). Returns (kernel, log_noise,
    negative log marginal likelihood) in the shape given."""
    return _tune(config, kernel, Z, X, y, mask, log_noise, method, map_prior=False)


def _tune(config, kernel, Z, X, y, mask, log_noise, method, map_prior):
    if map_prior:
        raise NotImplementedError("MAP tuning (tune_map) is not ported yet")
    single = y.dim() == 1
    lv0 = kernel.log_variance.detach().reshape(-1)
    ll0 = kernel.log_lengthscales.detach().reshape(lv0.shape[0], -1)
    ln0 = log_noise.detach().reshape(-1)
    Y = y.reshape(lv0.shape[0], -1)
    n_out = lv0.shape[0]

    def loss_fn(lv, ll, ln):
        """Negative LML of every output, (n_out,)."""
        k = SquaredExponentialARD(log_variance=lv, log_lengthscales=ll)
        return -sparse_lml(k, Z, X, Y, mask, ln, method)

    # one leaf per output and parameter: Adam keeps a step count per leaf,
    # so an output whose step is rejected below keeps its whole state
    leaves = [[t[o].clone().requires_grad_(True) for t in (lv0, ll0, ln0)]
              for o in range(n_out)]
    opt = torch.optim.Adam([p for out in leaves for p in out], lr=config.learning_rate)
    stacked = lambda: [torch.stack([out[i] for out in leaves]) for i in range(3)]
    for _ in range(config.steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(*stacked())
        loss.sum().backward()
        # the LML Cholesky can fail (NaN) at aggressive hyperparameters in
        # f32: reject a non-finite step for that output and go on from its
        # last good iterate (Adam skips a leaf without a gradient)
        grads_ok = torch.stack([
            torch.stack([torch.isfinite(p.grad).all() for p in out]).all() for out in leaves])
        for out, ok in zip(leaves, (torch.isfinite(loss.detach()) & grads_ok).tolist()):
            if not ok:
                for p in out:
                    p.grad = None
        opt.step()
        with torch.no_grad():
            for out in leaves:
                for p in out:
                    p.clamp_(config.log_lower, config.log_upper)

    # never return a tuning that is worse (or non-finite) than the init
    with torch.no_grad():
        lv, ll, ln = [t.detach() for t in stacked()]
        loss_tuned = loss_fn(lv, ll, ln)
        loss_init = loss_fn(lv0, ll0, ln0)
        better = torch.isfinite(loss_tuned) & (loss_tuned <= loss_init)
        lv = torch.where(better, lv, lv0)
        ll = torch.where(better[:, None], ll, ll0)
        ln = torch.where(better, ln, ln0)
        nll = torch.where(better, loss_tuned, loss_init)
    if single:
        lv, ll, ln, nll = lv[0], ll[0], ln[0], nll[0]
    return SquaredExponentialARD(log_variance=lv, log_lengthscales=ll), ln, nll
