"""Share of the traced window's evaluations of the safety filter's backup
value and gradient that ran on the backup-value kernel: ``safety.value.kernel``
spans over ``safety.value.kernel`` plus ``safety.value.autograd`` spans, in
percent. A window whose evaluations all ran on the autograd route reads 0; a
window with neither span, from a program that does not name the route,
reads nothing."""

KERNEL = "safety.value.kernel"
ROUTES = (KERNEL, "safety.value.autograd")


def read(data):
    names = [name for name, _, _ in data.host if name in ROUTES]
    if not names:
        return None
    return 100.0 * names.count(KERNEL) / len(names)
