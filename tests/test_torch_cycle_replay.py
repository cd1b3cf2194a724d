"""The GP-MPC cycle's replay on the CPU (``mpc/cycle_replay.py``,
``utils/graph_segments.py``): the rule that decides which cycles are
replayed, the callables that declare a frozen posterior, the tightening's κ
made once on the device, the ADMM schedule's host reads, the chunk
wrapper's output buffers, the recorder's segments on a stand-in for CUDA
graphs, and the eager route's span. The replay itself runs in
tests/test_torch_cuda.py."""

import contextlib
import gc
import warnings

import pytest
import torch

from gpmpc_tpu_torch.learning import batched_learner, explore_gp_3dof, gp_fns, online_gp_mpc
from gpmpc_tpu_torch.main_path import (main_path, online_flight_path, online_flight_x0,
                                       sixdof_path, with_gust_variance)
from gpmpc_tpu_torch.mpc import box_tightening, gp_mpc_init, gp_mpc_solve, normal_quantile
from gpmpc_tpu_torch.mpc import cycle_replay as R
from gpmpc_tpu_torch._device import device_constant
from gpmpc_tpu_torch.mpc.constraints import quantile_constant
from gpmpc_tpu_torch.mpc.gp_mpc import fused_rollout
from gpmpc_tpu_torch.mpc.nominal import _zero_gp
from gpmpc_tpu_torch.ops.kernels import admm_chunk as K
from gpmpc_tpu_torch.ops.qp import ADMMConfig
from gpmpc_tpu_torch.ops.qp.admm import host_reads
from gpmpc_tpu_torch.utils import graph_segments as G
from gpmpc_tpu_torch.utils import profiler

torch.set_num_threads(1)  # the suite's xdist workers share the cores

CUDA = torch.device("cuda", 0)


def _main_config(**kw):
    return main_path("cpu").config.replace(**kw)


def _base(**kw):
    cfg = main_path("cpu").config
    return cfg.replace(base=cfg.base.replace(**kw))


def _admm(**kw):
    cfg = main_path("cpu").config
    return cfg.replace(base=cfg.base.replace(admm=cfg.base.admm.replace(**kw)))


# (configuration, device, fused, frozen) → the rule's answer
RULE_CASES = {
    "main_path_on_cuda": (_main_config, CUDA, True, True, None),
    "cpu_tensors": (_main_config, torch.device("cpu"), True, True, "device"),
    "path_d": (lambda: sixdof_path("cpu").config, CUDA, True, True, "admm_host_reads"),
    "ipm": (lambda: _base(solver="ipm"), CUDA, True, True, "solver"),
    "warm_kkt": (lambda: _main_config(warm_kkt=True), CUDA, True, True, "warm_kkt"),
    "sparse_form": (lambda: _base(condensed=False), CUDA, True, True, "sparse_form"),
    "stage_rows_fn": (lambda: _base(stage_rows_fn=lambda X: None), CUDA, True, True,
                      "stage_rows_fn"),
    "tighten_mask_on_host": (lambda: _main_config(tighten_mask=torch.ones(7)), CUDA, True, True,
                             "tighten_mask"),
    "two_chunks_with_exit_read": (lambda: _admm(max_iter=100, check_interval=50), CUDA, True,
                                  True, "admm_host_reads"),
    "two_chunks_without_exit": (lambda: _admm(max_iter=100, check_interval=50,
                                              early_exit=False), CUDA, True, True, None),
    "gp_in_the_rollout_loop": (lambda: _main_config(rollout_gp_tape=False), CUDA, False, True,
                               "rollout"),
    "online_learner": (_main_config, CUDA, True, False, "posterior"),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_replay_rule(case):
    make, device, fused, frozen, want = RULE_CASES[case]
    assert R.replay_rule(make(), device, fused, frozen) == want


@pytest.mark.parametrize("tape,fused", [(True, True), (False, False)])
def test_rollout_route_the_rule_reads(tape, fused):
    """The GP in the rollout loop takes the eager rollout: no replay."""
    mp = main_path("cpu")
    cfg = mp.config.replace(rollout_gp_tape=tape)
    assert fused_rollout(mp.F, cfg, torch.zeros(2, 7)) is fused


@pytest.mark.parametrize("kw,reads", [
    (dict(max_iter=50, check_interval=50), False),
    (dict(max_iter=100, check_interval=50, adaptive_rho=False), True),
    (dict(max_iter=100, check_interval=50), False),  # chunk 2 still adapts ρ: no read
    (dict(max_iter=100, check_interval=50, adaptive_rho=False, early_exit=False), False),
    (dict(max_iter=100, check_interval=25, adaptive_rho=True, rho_adapt_chunks=4), False),
    (dict(max_iter=125, check_interval=25, adaptive_rho=True, rho_adapt_chunks=4), True),
    (dict(max_iter=50, check_interval=50, matvec_dtype="bf16", use_pallas="off",
          tail_f32_iters=10), True),
    (dict(max_iter=50, check_interval=50, matvec_dtype="bf16", use_pallas="off"), False),
])
def test_admm_host_reads_follow_the_solver_schedule(kw, reads):
    assert host_reads(ADMMConfig(**kw)) is reads


def test_fitted_gp_callables_declare_a_frozen_posterior():
    mp = main_path("cpu")
    g = torch.Generator().manual_seed(0)
    gp, mean_fn, var_fn = explore_gp_3dof(g, g, mp.params, mp.F_true, dt=0.1, n_points=16,
                                          n_inducing=4, device="cpu")
    assert R.is_frozen(mean_fn) and R.is_frozen(var_fn)
    assert all(R.is_frozen(f) for f in gp_fns(gp, gated=False))
    assert R.is_frozen(with_gust_variance(var_fn))
    assert all(R.is_frozen(f) for f in _zero_gp(7))


def test_refitted_gp_callables_do_not():
    """The lane-batched learner's callables and a wrapper of an unknown
    callable carry no frozen posterior."""
    mean_fn, var_fn = batched_learner._gated_fns(None, torch.zeros(2, dtype=torch.bool), 7)
    assert not R.is_frozen(mean_fn) and not R.is_frozen(var_fn)
    assert not R.is_frozen(with_gust_variance(lambda x, u: x[..., :3]))


def test_online_learner_solves_with_unfrozen_callables(monkeypatch):
    seen = []
    inner = online_gp_mpc.gp_mpc_solve

    def spy(step_fn, mean_fn, var_fn, *args):
        seen.append(R.is_frozen(mean_fn) or R.is_frozen(var_fn))
        return inner(step_fn, mean_fn, var_fn, *args)

    monkeypatch.setattr(online_gp_mpc, "gp_mpc_solve", spy)
    op = online_flight_path("3dof", "cpu")
    x0 = online_flight_x0("3dof", torch.Generator().manual_seed(0), 2, "cpu")
    cinit, cstep = op.controller()
    st, x = cinit(x0), x0
    for k in range(2):
        u, st = cstep(st, x, k)
        x = op.F_true(x, u)
    assert seen == [False, False]


@pytest.mark.parametrize("confidence", [0.9, 0.95, 0.99])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_kappa_is_the_device_ndtri_bit_for_bit(confidence, dtype):
    want = normal_quantile(torch.tensor(confidence, dtype=dtype))
    got = quantile_constant(confidence, dtype, torch.device("cpu"))
    assert got.dtype == dtype and torch.equal(got, want)
    assert quantile_constant(confidence, dtype, torch.device("cpu")) is got  # made once
    S = torch.diag_embed(torch.rand(3, 4, 7, dtype=dtype))
    assert torch.equal(box_tightening(S, confidence),
                       want * torch.sqrt(torch.diagonal(S, dim1=-2, dim2=-1)))
    assert torch.equal(device_constant(confidence, dtype, torch.device("cpu")),
                       torch.tensor(confidence, dtype=dtype))


def test_chunk_wrapper_writes_into_given_buffers():
    g = torch.Generator().manual_seed(0)
    B, n, m = 3, 5, 4
    M = torch.randn(B, n, n, generator=g)
    Minv = torch.linalg.inv(M @ M.transpose(1, 2) + n * torch.eye(n))
    A = torch.randn(B, m, n, generator=g)
    q, x = torch.randn(B, n, generator=g), torch.randn(B, n, generator=g)
    l, u = -torch.ones(B, m), torch.ones(B, m)
    rho, z, y = torch.full((B, m), 0.1), torch.randn(B, m, generator=g), torch.zeros(B, m)
    args = (Minv, A, q, l, u, rho, x, z, y)
    want = K.admm_chunk(*args, iters=5, sigma=1e-6, alpha=1.6)
    out = tuple(torch.empty_like(t) for t in (x, z, y))
    got = K.admm_chunk(*args, iters=5, sigma=1e-6, alpha=1.6, out=out)
    assert all(a is b for a, b in zip(got, out))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="out's z"):
        K.admm_chunk(*args, iters=5, sigma=1e-6, alpha=1.6,
                     out=(out[0], torch.empty(B, m + 1), out[2]))


# -- the recorder on a stand-in for CUDA graphs ---------------------------------

class _FakeGraph:
    """Captures the calls made to ``_FakeGraph.work`` between capture_begin
    and capture_end, and makes them again at replay; warns as torch does when
    nothing was captured."""

    log: list = []
    capturing = None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls, self.stream, _FakeGraph.capturing = [], _FakeStream.current, self

    def capture_end(self):
        if _FakeStream.current is not self.stream:  # as torch refuses it
            raise RuntimeError("Capture must end on the same stream it began on.")
        _FakeGraph.capturing = None
        if not self.calls:
            warnings.warn(G._EMPTY + ". This usually means ...")

    def replay(self):
        for c in self.calls:
            _FakeGraph.log.append(c)

    @staticmethod
    def work(tag):
        if _FakeGraph.capturing is not None:
            _FakeGraph.capturing.calls.append(tag)
        else:
            _FakeGraph.log.append(tag)


class _FakeStream:
    current = None  # the stream work goes to

    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _on(stream):
    before, _FakeStream.current = _FakeStream.current, stream
    try:
        yield
    finally:
        _FakeStream.current = before


@pytest.fixture
def fake_cuda(monkeypatch):
    side = _FakeStream()
    _FakeStream.current = _FakeStream()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream.current)
    monkeypatch.setattr(torch.cuda, "stream", _on)
    monkeypatch.setattr(G, "_side_stream", lambda device: side)
    _FakeGraph.log, _FakeGraph.capturing = [], None
    return _FakeGraph


def _body(bufs):
    """A recorded function: work in and between spans, an empty span, an
    eager call and a count."""
    work = _FakeGraph.work
    with profiler.span("gpmpc.rollout"):
        work("rollout")
    with profiler.span("gpmpc.linearize"):
        pass
    with profiler.span("gpmpc.admm_solve"):
        work("scale")
        with profiler.span("admm.chunk"):
            out = G.eager_call(lambda o: work(("chunk", o is not None)), (torch.zeros(2),))
        work("unscale")
    G.tally(lambda: bufs.append("counted"))
    work("tail")
    return out


def test_recorder_cuts_at_spans_and_eager_calls(fake_cuda):
    counted, collecting = [], []
    graph = G.SegmentedGraph("cpu")
    out = graph.record(lambda: (collecting.append(gc.isenabled()), _body(counted))[1])
    assert collecting == [True, False] and gc.isenabled()  # no collection while recording
    # the warm run made every call once, eagerly; the recording made none
    assert fake_cuda.log == ["rollout", "scale", ("chunk", False), "unscale", "tail"]
    assert counted == ["counted"]
    assert isinstance(out, tuple) and out[0].shape == (2,)
    labels = [(names, "graph" if isinstance(s, _FakeGraph) else "eager")
              for names, s in graph.steps]
    assert labels == [(("gpmpc.rollout",), "graph"), (("gpmpc.admm_solve",), "graph"),
                      (("gpmpc.admm_solve", "admm.chunk"), "eager"),
                      (("gpmpc.admm_solve",), "graph"), ((), "graph")]
    assert len(graph._empty) == 6  # the gaps between spans, the empty span, the chunk's
    fake_cuda.log.clear()
    graph.replay()
    assert fake_cuda.log == ["rollout", "scale", ("chunk", True), "unscale", "tail"]
    assert counted == ["counted", "counted"]  # the warm run's, then the replay's


def test_replay_opens_the_recorded_spans_under_a_profiler(fake_cuda):
    graph = G.SegmentedGraph("cpu")
    graph.record(lambda: _body([]))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        graph.replay()
    names = [e.name for e in prof.events() if e.name.startswith(("gpmpc.", "admm."))]
    assert sorted(names) == ["admm.chunk", "gpmpc.admm_solve", "gpmpc.rollout"]


def test_a_failed_recording_ends_its_capture(fake_cuda):
    graph = G.SegmentedGraph("cpu")
    calls = [0]

    def body():
        calls[0] += 1
        with profiler.span("gpmpc.rollout"):
            _FakeGraph.work("x")
            if calls[0] == 2:
                raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graph.record(body)
    assert fake_cuda.capturing is None and G.recording() is None and gc.isenabled()


def test_a_cycle_that_cannot_be_recorded_runs_eagerly(fake_cuda, monkeypatch):
    """A host read the rule does not see fails the recording: the key warns
    once and runs eagerly from then on, with the same answers."""
    from gpmpc_tpu_torch.mpc.gp_mpc import _cycle

    def cycle(*args):
        if G.recording() is not None:
            raise RuntimeError("Cannot copy between CPU and CUDA tensors during CUDA graph "
                               "capture unless the CPU tensor is pinned.")
        return _cycle(*args)

    monkeypatch.setattr(R, "replay_rule", lambda *args: None)
    mp = main_path("cpu")
    mean_fn, var_fn = _zero_gp(7)
    xs = online_flight_x0("3dof", torch.Generator().manual_seed(1), 2, "cpu")
    state = gp_mpc_init(mp.config, xs, mp.x_target, device="cpu")
    args = (mp.F, mean_fn, var_fn, mp.config, state, xs)
    want = _cycle(*args)[0].u0
    failed, captures = R.EAGER.get(R.CAPTURE_FAILED, 0), R.CAPTURES
    with pytest.warns(UserWarning, match="could not be recorded"):
        for _ in range(2):  # the first call, then the recording
            assert torch.equal(R.run(cycle, *args, True)[0].u0, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(R.run(cycle, *args, True)[0].u0, want)
    assert R.EAGER[R.CAPTURE_FAILED] == failed + 2 and R.CAPTURES == captures
    assert fake_cuda.capturing is None and G.recording() is None


def test_eager_cycles_run_inside_their_span():
    mp = main_path("cpu")
    g = torch.Generator().manual_seed(0)
    _, mean_fn, var_fn = explore_gp_3dof(g, g, mp.params, mp.F_true, dt=0.1, n_points=16,
                                         n_inducing=4, device="cpu")
    xs = online_flight_x0("3dof", torch.Generator().manual_seed(1), 2, "cpu")
    state = gp_mpc_init(mp.config, xs, mp.x_target, device="cpu")
    before = R.EAGER.get("device", 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, xs)
    assert R.EAGER["device"] == before + 1
    names = [e.name for e in prof.events()]
    assert names.count("gpmpc.eager") == 1 and "gpmpc.replay" not in names
