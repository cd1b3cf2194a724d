"""Device ops (kernels, copies and memsets) a cycle in the traced window:
an exact count."""


def read(data):
    if not data.device or not data.units:
        return None
    return len(data.device) / data.units
