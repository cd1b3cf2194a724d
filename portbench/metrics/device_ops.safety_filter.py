"""Device ops a cycle issued inside the span safety.filter: the CUDA
runtime's launch, copy and memset calls whose host interval starts inside
it. An exact count."""

from portbench.core.spans import is_launch
from portbench.core.trace import union

SPANS = ("safety.filter",)


def read(data):
    if not data.device or not data.units:
        return None
    inside = union([iv for iv in data.host if iv[0] in SPANS])
    if not inside:
        return None
    starts = sorted(s for name, s, _ in data.host if is_launch(name))
    count, i = 0, 0
    for lo, hi in inside:
        while i < len(starts) and starts[i] < lo:
            i += 1
        while i < len(starts) and starts[i] <= hi:
            count += 1
            i += 1
    return count / data.units
