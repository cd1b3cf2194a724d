"""Host milliseconds a cycle inside the span(s) gpmpc.gp_rot, the rotational
sub-GP of the 6-DoF structured GP (its features and posterior, at every
evaluation: the residual tape's and the two in gpmpc.gp_posterior), under
the profiler (which inflates host time)."""

SPANS = ('gpmpc.gp_rot',)


def read(data):
    if not data.units or not any(name in SPANS for name, _, _ in data.host):
        return None
    return 1e3 * data.span_seconds(*SPANS) / data.units
