"""Host milliseconds a cycle inside the span rti.step (one whole
``rti_step``: the re-anchored rollout, the Jacobians, the QP's build and its
ADMM solve), under the profiler (which inflates host time)."""

SPANS = ("rti.step",)


def read(data):
    if not data.units or not any(name in SPANS for name, _, _ in data.host):
        return None
    return 1e3 * data.span_seconds(*SPANS) / data.units
