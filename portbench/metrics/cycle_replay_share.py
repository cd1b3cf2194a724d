"""Share of the traced window's units (cycles, campaign steps) whose GP-MPC
cycle was replayed from its CUDA-graph segments: ``gpmpc.replay`` spans over
units, in percent. A window whose cycles all ran eagerly (``gpmpc.eager``)
reads 0; a window with neither span, from a program that does not route its
cycles so, reads nothing."""

REPLAY = "gpmpc.replay"
ROUTED = (REPLAY, "gpmpc.eager", "gpmpc.capture")


def read(data):
    if not data.units:
        return None
    names = [name for name, _, _ in data.host if name in ROUTED]
    if not names:
        return None
    return 100.0 * names.count(REPLAY) / data.units
