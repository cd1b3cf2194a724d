"""Host milliseconds a cycle inside the span safety.filter (one whole
``filter_control`` call: the backup rollout and its gradient, every SCP
iteration's QP, the selection), under the profiler (which inflates host
time)."""

SPANS = ("safety.filter",)


def read(data):
    if not data.units or not any(name in SPANS for name, _, _ in data.host):
        return None
    return 1e3 * data.span_seconds(*SPANS) / data.units
