"""Host milliseconds a trajectory inside the SCVX subproblem's build
(spans scvx.rollout, scvx.linearize and scvx.qp_build: the exact rollout,
the torch.func Jacobians, the trust-region bounds, constraint rows and cost),
under the profiler; a planning query delivers one trajectory."""

SPANS = ("scvx.rollout", "scvx.linearize", "scvx.qp_build")


def read(data):
    if not data.trajectories or not any(name in SPANS for name, _, _ in data.host):
        return None
    return 1e3 * data.span_seconds(*SPANS) / data.trajectories
