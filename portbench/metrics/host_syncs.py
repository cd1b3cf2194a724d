"""Host-to-device waits a unit (cycle, campaign step, library build or
query) in the traced window: the CUDA runtime's synchronize calls and
synchronous copies (``portbench/core/spans.py``), the tracer's own closing
synchronize left out. An exact count."""

from portbench.core.spans import sync_calls


def read(data):
    if not data.device or not data.units:
        return None
    return len(sync_calls(data)) / data.units
