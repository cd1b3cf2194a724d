"""The yardstick of the ADMM chunk: the least time its work can take on the
card, counted from the QP's own inputs and the iteration count alone — never
from the kernel's variant, the declared rows or its internal layout.

Bytes: M⁻¹ (n×n a lane) once, A's nonzero entries in this launch's inputs
once, the seven input vectors (q, l, u, ρ, x, z, y) once and the three
outputs (x, z, y) once, at 4 bytes each. Operations, per iteration: the n×n
matvec with M⁻¹, the products with A and Aᵀ at A's nonzeros, and 11m + 5n
for the vector updates. The least time is the larger of bytes over the HBM
rate and operations over the float32 rate.
"""

from __future__ import annotations

# published peaks of one card (the data sheet's SXM part, dense, no sparsity),
# by the name torch.cuda.get_device_name() gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def work(B: int, n: int, m: int, nnz: int, iters: int):
    """(bytes, operations) of one launch over B lanes: nnz is the count of
    A's nonzero entries over every lane."""
    bytes_moved = 4 * (B * n * n + nnz + B * (2 * n + 5 * m) + B * (n + 2 * m))
    ops = iters * (2 * B * n * n + 4 * nnz + B * (11 * m + 5 * n))
    return bytes_moved, ops


def least_seconds(device_name: str, B: int, n: int, m: int, nnz: int, iters: int):
    """(seconds, "bytes" or "operations") on the named card, or None for a
    card the table does not hold."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    b, ops = work(B, n, m, nnz, iters)
    tb, to = b / peak["hbm_bytes_per_s"], ops / peak["f32_flops_per_s"]
    return (tb, "bytes") if tb >= to else (to, "operations")
