"""The device's idle share: 1 − the union of the device ops' intervals over
the traced window, in percent."""


def read(data):
    if not data.device:
        return None
    return 100.0 * (1.0 - data.busy_seconds() / data.window_s)
