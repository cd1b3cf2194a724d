"""Host milliseconds inside the ADMM solver's spans (admm.factor, admm.chunk,
admm.residuals, admm.polish) per trajectory delivered, under the profiler; a
planning query delivers one."""

SPANS = ("admm.factor", "admm.chunk", "admm.residuals", "admm.polish")


def read(data):
    if not data.trajectories or not any(name in SPANS for name, _, _ in data.host):
        return None
    return 1e3 * data.span_seconds(*SPANS) / data.trajectories
