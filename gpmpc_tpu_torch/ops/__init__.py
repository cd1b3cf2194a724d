"""Numerical building blocks: QP solvers, hand-written kernels, linear algebra."""
