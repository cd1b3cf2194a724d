"""Host milliseconds a cycle inside the span(s) gpmpc.propagate_tighten (the
covariance propagation and the chance back-offs), under the profiler (which
inflates host time)."""

SPANS = ('gpmpc.propagate_tighten',)


def read(data):
    if not data.units or not any(name in SPANS for name, _, _ in data.host):
        return None
    return 1e3 * data.span_seconds(*SPANS) / data.units
