"""Reference-trajectory layer (counterpart of ``gpmpc_tpu/reference``): the
analytic descent profiles. SCVX and the trajectory library are not ported."""

from .profiles import cubic_descent_reference, pad_reference

__all__ = ["cubic_descent_reference", "pad_reference"]
