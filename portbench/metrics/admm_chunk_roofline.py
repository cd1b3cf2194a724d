"""The ADMM chunk kernel's share of its roofline, in percent: the least time
of the traced launches' work (portbench/core/roofline.py, from each launch's
QP inputs and iteration count) over the profiler's device time of the
``admm_chunk*`` kernels."""

from portbench.core.roofline import least_seconds


def read(data):
    kernels = [e - s for name, s, e in data.device if "admm_chunk" in name]
    if not kernels or len(kernels) != len(data.launches):
        return None
    least = [least_seconds(data.device_name, L["B"], L["n"], L["m"], L["nnz"], L["iters"])
             for L in data.launches]
    if any(x is None for x in least):
        return None
    return 100.0 * sum(t for t, _ in least) / (sum(kernels) / 1e6)
