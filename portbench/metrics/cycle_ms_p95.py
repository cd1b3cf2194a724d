"""95th percentile of the real-time loop's cycle times on the host clock
(start of the solve until u0 is in host memory), the profiled cycles left
out. The reference project's 50 Hz rule is p95 < 20 ms: recorded beside,
it decides nothing."""


def read(data):
    return data.host_clock.get("cycle_ms_p95")
