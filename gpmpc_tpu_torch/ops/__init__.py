"""Numerical building blocks: QP solvers, hand-written kernels, linear algebra."""

from . import qp

__all__ = ["qp"]
