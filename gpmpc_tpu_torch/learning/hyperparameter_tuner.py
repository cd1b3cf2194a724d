"""GP hyperparameter tuning (counterpart of
``gpmpc_tpu/learning/hyperparameter_tuner.py``): maximum likelihood and MAP
with a log-normal prior by Adam in log space on the analytic sparse-GP
marginal likelihood (gradients by autograd), random-search "CV", the
retrain trigger and the error-driven scheduler.

The kernel parameters may carry leading axes: an output axis (the stacked
kernels of a multi-output GP) and, ahead of it, a lane axis (a GP per lane),
with data, mask and noise shaped to match (Y ([B,] n_out, cap), log_noise
([B,] n_out)). Every (lane, output) group is then tuned on its own objective
with its own Adam state, as the JAX package does by ``vmap``-ing over
outputs and lanes, in one batched Adam run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch

from ..gp.sparse_gp import sparse_lml

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults (torch's too)


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


def tune_mle(config: HyperparameterConfig, kernel, Z, X, y, mask, log_noise,
             method: str = "fitc") -> Tuple[object, torch.Tensor, torch.Tensor]:
    """Maximum-likelihood tuning. One output (``y`` (cap,), scalar
    ``log_noise``, unstacked kernel), several (``y`` (n_out, cap),
    ``log_noise`` (n_out,), stacked kernel) or several per lane (a lane axis
    first everywhere). Returns (kernel, log_noise, negative log marginal
    likelihood) in the shape given."""
    return _tune(config, kernel, Z, X, y, mask, log_noise, method, map_prior=False)


def tune_map(config: HyperparameterConfig, kernel, Z, X, y, mask, log_noise,
             method: str = "fitc") -> Tuple[object, torch.Tensor, torch.Tensor]:
    """MAP tuning: the negative LML plus a Gaussian prior (``prior_mean``,
    ``prior_std``) on every log-hyperparameter."""
    return _tune(config, kernel, Z, X, y, mask, log_noise, method, map_prior=True)


def _groups(kernel, log_noise) -> Tuple[torch.Size, List[torch.Tensor]]:
    """The group shape (the leading dims of log_noise) and every parameter
    flattened to (G, k)."""
    lead = log_noise.shape
    leaves = [p.detach().reshape(math.prod(lead), -1) for p in kernel.params()]
    return lead, leaves + [log_noise.detach().reshape(-1, 1)]


def _tune(config, kernel, Z, X, y, mask, log_noise, method, map_prior):
    lead, p0 = _groups(kernel, log_noise)
    shapes = [p.shape for p in kernel.params()]

    def loss_fn(ps):
        """Negative LML (plus the prior) of every group, (G,)."""
        k = kernel.with_params([p.reshape(s) for p, s in zip(ps[:-1], shapes)])
        nll = -sparse_lml(k, Z, X, y, mask, ps[-1].reshape(lead), method).reshape(-1)
        if map_prior:
            for p in ps:
                nll = nll + 0.5 * (((p - config.prior_mean) / config.prior_std) ** 2).sum(-1)
        return nll

    # Adam per group, in one batch: a group whose loss or gradient is not
    # finite (the LML Cholesky can fail at aggressive hyperparameters in f32)
    # keeps its parameters and Adam state, and goes on from its last good
    # iterate, as the JAX package rejects such a step
    ps = [p.clone() for p in p0]
    m1 = [torch.zeros_like(p) for p in ps]
    m2 = [torch.zeros_like(p) for p in ps]
    t = torch.zeros(ps[-1].shape[0], dtype=ps[-1].dtype, device=ps[-1].device)
    for _ in range(config.steps):
        req = [p.requires_grad_(True) for p in ps]
        loss = loss_fn(req)
        grads = torch.autograd.grad(loss.sum(), req)
        ok = torch.isfinite(loss.detach())
        for g in grads:
            ok = ok & torch.isfinite(g).all(-1)
        t = t + ok.to(t.dtype)
        bc1, bc2 = (1.0 - _B1 ** t)[:, None], (1.0 - _B2 ** t)[:, None]
        okc = ok[:, None]
        with torch.no_grad():
            for i, g in enumerate(grads):
                g = torch.where(okc, g, torch.zeros_like(g))
                m1[i] = torch.where(okc, _B1 * m1[i] + (1 - _B1) * g, m1[i])
                m2[i] = torch.where(okc, _B2 * m2[i] + (1 - _B2) * g * g, m2[i])
                step = config.learning_rate * (m1[i] / bc1) / (torch.sqrt(m2[i] / bc2) + _EPS)
                new = (ps[i] - step).clamp(config.log_lower, config.log_upper)
                ps[i] = torch.where(okc, new, ps[i].detach())

    # never return a tuning that is worse (or non-finite) than the init
    with torch.no_grad():
        loss_tuned, loss_init = loss_fn(ps), loss_fn(p0)
        better = torch.isfinite(loss_tuned) & (loss_tuned <= loss_init)
        ps = [torch.where(better[:, None], p, q) for p, q in zip(ps, p0)]
        nll = torch.where(better, loss_tuned, loss_init)
    k = kernel.with_params([p.reshape(s) for p, s in zip(ps[:-1], shapes)])
    return k, ps[-1].reshape(lead), nll.reshape(lead)


def tune_cv_random(config: HyperparameterConfig, generator: Optional[torch.Generator],
                   kernel, Z, X, y, mask, log_noise, n_candidates: int = 16,
                   perturb_scale: float = 0.5, method: str = "fitc",
                   candidates: Optional[list] = None):
    """Random search: ``n_candidates`` log-space perturbations of the current
    hyperparameters (N(0, perturb_scale²) drawn from ``generator``), each
    scored by its in-sample marginal likelihood; the best is kept if it beats
    the incumbent. ``candidates`` (a list of per-leaf (n_candidates, …)
    perturbations, kernel leaves then log_noise) replaces the draw. One
    output. Returns (kernel, log_noise, the best LML)."""
    leaves = kernel.params() + [log_noise]
    if candidates is None:
        gdev = Z.device if generator is None else generator.device
        candidates = [perturb_scale * torch.randn((n_candidates, *p.shape), generator=generator,
                                                  device=gdev).to(p.device) for p in leaves]
    cands = [p[None] + d for p, d in zip(leaves, candidates)]
    n_k = len(leaves) - 1
    # the candidates score as the outputs of one stacked GP on the same data
    lmls = sparse_lml(kernel.with_params(cands[:n_k]), Z, X,
                      y.expand(cands[-1].shape[0], y.shape[-1]), mask, cands[-1], method)
    inc = sparse_lml(kernel, Z, X, y, mask, log_noise, method)
    best = int(lmls.argmax())
    take = bool(lmls[best] > inc)
    out = [c[best] if take else p for c, p in zip(cands, leaves)]
    return kernel.with_params(out[:n_k]), out[-1], torch.maximum(lmls[best], inc)


class HyperparameterTuner:
    """Retrain-trigger bookkeeping and dispatch on ``config.method``."""

    def __init__(self, config: Optional[HyperparameterConfig] = None):
        self.config = config or HyperparameterConfig()
        self.episodes_since = 0

    def should_retrain(self, episodes_done: int) -> bool:
        return episodes_done > 0 and episodes_done % self.config.retrain_every_episodes == 0

    def tune(self, kernel, Z, X, y, mask, log_noise, method: str = "fitc",
             generator: Optional[torch.Generator] = None):
        if self.config.method == "mle":
            return tune_mle(self.config, kernel, Z, X, y, mask, log_noise, method)
        if self.config.method == "map":
            return tune_map(self.config, kernel, Z, X, y, mask, log_noise, method)
        if self.config.method == "cv":
            gen = generator or torch.Generator(device=Z.device).manual_seed(0)
            return tune_cv_random(self.config, gen, kernel, Z, X, y, mask, log_noise,
                                  method=method)
        raise ValueError(f"unknown tuning method {self.config.method!r}")


@dataclass(frozen=True)
class AdaptiveHyperparameterScheduler:
    """Error-increase trigger: running long- and short-horizon averages of
    the prediction error; a retrain is flagged once more than 10 errors are
    in and the recent average exceeds ``ratio`` times the long one.
    ``observe`` returns (scheduler, trigger)."""

    long_avg: float = 0.0
    recent_avg: float = 0.0
    n: int = 0
    ratio: float = 1.5
    long_decay: float = 0.995
    recent_decay: float = 0.9

    def observe(self, error: float) -> Tuple["AdaptiveHyperparameterScheduler", bool]:
        e = float(error)
        first = self.n == 0
        long_avg = e if first else self.long_decay * self.long_avg + (1 - self.long_decay) * e
        recent_avg = (e if first else
                      self.recent_decay * self.recent_avg + (1 - self.recent_decay) * e)
        trigger = self.n > 10 and recent_avg > self.ratio * long_avg
        return replace(self, long_avg=long_avg, recent_avg=recent_avg, n=self.n + 1), trigger
