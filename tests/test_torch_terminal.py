"""The port's terminal-set layer (``gpmpc_tpu_torch/terminal``) against the
JAX package on the CPU: the safe set's fields after inserts (the ring wrap
and the saturating ``written`` included), lane-ordered fleet inserts, every
pruning strategy, merging, trimming, the ``.npz`` files in both directions,
the streaming store; the lanes-first KNN queries with the fuel filter and
its fallback, adaptive K and Q interpolation; the hull rows and the hull
projection; the Q-functions. Inputs come from a numpy seed; a JAX store
is carried across by ``convert.safe_set_from_numpy``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu import terminal as JT
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch import terminal as TT
from gpmpc_tpu_torch.terminal.safe_set import _LEAVES

torch.set_num_threads(1)  # the suite's xdist workers share the cores

T = lambda a: torch.tensor(np.asarray(a))
INT_FIELDS = ("iterations", "traj_ids", "head", "count", "n_trajectories", "written")


def _trajectories(seed, n_traj=3, T_len=20, n_x=7):
    """Descending trajectories (burning fuel, one lateral offset each) with
    positive stage costs, float32."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_traj):
        X = np.zeros((T_len, n_x), np.float32)
        X[:, 0] = np.linspace(2.0, 1.5, T_len) + 0.01 * rng.normal(size=T_len)
        X[:, 1] = np.linspace(20.0 - 2 * t, 0.0, T_len)
        X[:, 2] = 0.1 * t + 0.05 * rng.normal(size=T_len)
        X[:, 4] = -2.0 + 0.1 * rng.normal(size=T_len)
        U = np.tile([2.0, 0, 0], (T_len, 1)).astype(np.float32) + 0.1 * rng.normal(
            size=(T_len, 3)).astype(np.float32)
        c = (np.linspace(2.0, 0.1, T_len) ** 2 + 0.1 * rng.random(T_len)).astype(np.float32)
        out.append((X, U, c))
    return out


def _both(trajs, capacity, valid=None, n_x=7):
    """The same inserts into a JAX store and a port store."""
    jss = JT.SafeSet.create(capacity, n_x)
    tss = TT.SafeSet.create(capacity, n_x, device="cpu")
    for i, (X, U, c) in enumerate(trajs):
        v = None if valid is None else valid[i]
        jss = jss.add_trajectory(jnp.asarray(X), jnp.asarray(U), jnp.asarray(c),
                                 valid=None if v is None else jnp.asarray(v))
        tss = tss.add_trajectory(T(X), T(U), T(c), valid=None if v is None else torch.tensor(v))
    return jss, tss


def assert_same_store(tss, jss, rtol=1e-6):
    """Field by field: integer fields exactly, float fields to rtol (the
    cost-to-go is a reversed cumulative sum, summed in another order)."""
    for name, jv in zip(_LEAVES, jax.tree.flatten(jss)[0]):
        tv = getattr(tss, name)
        tv = tv.numpy() if isinstance(tv, torch.Tensor) else np.asarray(tv)
        if name in INT_FIELDS:
            np.testing.assert_array_equal(tv, np.asarray(jv), err_msg=name)
        else:
            np.testing.assert_allclose(tv, np.asarray(jv), rtol=rtol, atol=1e-6, err_msg=name)


def test_cost_to_go_matches_jax():
    c = np.random.default_rng(0).random(12).astype(np.float32)
    np.testing.assert_allclose(TT.cost_to_go(T(c)).numpy(), JT.cost_to_go(jnp.asarray(c)),
                               rtol=1e-6)


def test_inserts_match_jax_field_by_field():
    jss, tss = _both(_trajectories(0), 128)
    assert_same_store(tss, jss)
    js, ts = jss.get_statistics(), tss.get_statistics()
    for k in ("n_states", "n_trajectories", "best_cost", "mean_q", "fill_fraction"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6)
    np.testing.assert_array_equal(tss.states_from_iteration(1).numpy(),
                                  np.asarray(jss.states_from_iteration(1)))
    for fa in (0.2, 0.45):
        np.testing.assert_array_equal(tss.feasible_mask(torch.tensor(fa)).numpy(),
                                      np.asarray(jss.feasible_mask(jnp.asarray(fa))))


def test_ring_wrap_and_written_saturation_match_jax():
    """Capacity 32 and 5 × 20 rows: the ring wraps (head mod capacity,
    count saturated) and ``written`` saturates at capacity + 1; a masked
    insert in the middle changes nothing."""
    trajs = _trajectories(1, n_traj=5)
    jss, tss = _both(trajs, 32, valid=[True, True, False, True, True])
    assert int(tss.written) == 33 and int(tss.head) == (80 % 32)
    assert_same_store(tss, jss)


@pytest.mark.parametrize("cap,valid", [(4096, [True, False, True, True]),
                                       (64, [True, True, False, True]),
                                       (64, [False, False, False, False])])
def test_fleet_insert_in_lane_order_matches_sequential_jax(cap, valid):
    """``add_trajectories`` (one scatter, the slots from the lanes that
    pass) against the JAX package's scan of single inserts, the ring wrap
    inside one call included (capacity 64 < 3 × 30 + the 20 rows before)."""
    first = _trajectories(2, n_traj=1)
    lanes = _trajectories(3, n_traj=4, T_len=30)
    jss, tss = _both(first, cap)
    for (X, U, c), v in zip(lanes, valid):
        jss = jss.add_trajectory(jnp.asarray(X), jnp.asarray(U), jnp.asarray(c),
                                 valid=jnp.asarray(v))
    tss = tss.add_trajectories(T(np.stack([t[0] for t in lanes])),
                               T(np.stack([t[1] for t in lanes])),
                               T(np.stack([t[2] for t in lanes])), valid=torch.tensor(valid))
    assert_same_store(tss, jss)


@pytest.mark.parametrize("strategy,keep,cap", [("quality", 10, 128), ("fifo", 20, 128),
                                               ("fifo", 10, 32), ("diversity", 15, 128),
                                               ("diversity", 64, 256)])
def test_prune_matches_jax(strategy, keep, cap):
    """Each strategy marks the same rows inactive (FIFO across a wrapped
    ring at capacity 32; diversity on near-duplicate copies of one
    trajectory beside a distinct one)."""
    if strategy == "diversity" and cap == 256:
        base = np.zeros((16, 7), np.float32)
        base[:, 0] = np.linspace(2.0, 1.8, 16)
        base[:, 1] = np.linspace(20.0, 0.0, 16)
        trajs = [(base, np.zeros((16, 3), np.float32),
                  (np.linspace(2.0, 0.1, 16) ** 2 + 0.01 * t).astype(np.float32))
                 for t in range(8)]
        trajs.append((base + np.float32(5.0), np.zeros((16, 3), np.float32),
                      np.full(16, 3.0, np.float32)))
    else:
        trajs = _trajectories(4)
    jss, tss = _both(trajs, cap)
    jp, tp = JT.prune(jss, keep, strategy=strategy), TT.prune(tss, keep, strategy=strategy)
    np.testing.assert_array_equal(tp.traj_ids.numpy(), np.asarray(jp.traj_ids))
    assert int(tp.count) == int(jp.count)
    with pytest.raises(ValueError):
        TT.prune(tss, keep, strategy="nope")


def test_merge_matches_jax():
    ja, ta = _both(_trajectories(5, n_traj=2), 64)
    jb, tb = _both(_trajectories(6, n_traj=2), 64)
    jm, tm = JT.merge_safe_sets([ja, jb], capacity=64), TT.merge_safe_sets([ta, tb], capacity=64)
    assert tm.states.shape[0] == 64
    assert_same_store(tm, jm)


def test_trim_and_bucket_match_jax():
    jss, tss = _both(_trajectories(7, n_traj=6), 512)
    for w, cap, floor in ((int(tss.written), 512, 32), (0, 1 << 21, 4096), (4097, 1 << 21, 4096),
                          (2 ** 20 + 1, 1 << 21, 4096), (600, 512, 16)):
        assert TT.knn_bucket(w, cap, floor) == JT.knn_bucket(w, cap, floor)
    b = TT.knn_bucket(int(tss.written), 512, floor=32)
    assert_same_store(TT.trim(tss, b), JT.trim(jss, b))


def test_npz_files_cross_both_ways(tmp_path):
    """The port reads the JAX package's ``.npz`` (the leaves in pytree
    order) and the JAX package reads the port's."""
    jss, tss = _both(_trajectories(8), 64)
    jss.save(str(tmp_path / "jax.npz"))
    assert_same_store(tss.load(str(tmp_path / "jax.npz")), jss)
    tss.save(str(tmp_path / "port.npz"))
    assert_same_store(tss, jss.load(str(tmp_path / "port.npz")))
    assert_same_store(convert.safe_set_from_numpy(jax.tree.flatten(jss)[0], "cpu"), jss)


def test_streaming_safe_set_matches_jax():
    """Five adds then a flush (a padded pseudo-trajectory), then a buffer of
    4 that flushes itself when full."""
    js = JT.StreamingSafeSet.create(JT.SafeSet.create(64, 7), buffer_size=8)
    ts = TT.StreamingSafeSet.create(TT.SafeSet.create(64, 7, device="cpu"), buffer_size=8)
    for i in range(5):
        js = js.add(jnp.full(7, float(i)), jnp.arange(3.0), jnp.asarray(1.0 + i))
        ts = ts.add(torch.full((7,), float(i)), torch.arange(3.0), torch.tensor(1.0 + i))
    assert int(ts.safe_set.count) == 0
    js, ts = js.flush(), ts.flush()
    assert_same_store(ts.safe_set, js.safe_set)
    assert int(ts.buf_count) == 0
    js4 = JT.StreamingSafeSet.create(js.safe_set, buffer_size=4)
    ts4 = TT.StreamingSafeSet.create(ts.safe_set, buffer_size=4)
    for i in range(4):
        js4 = js4.add(jnp.full(7, -float(i)), jnp.zeros(3), jnp.asarray(2.0))
        ts4 = ts4.add(torch.full((7,), -float(i)), torch.zeros(3), torch.tensor(2.0))
    assert int(ts4.safe_set.count) == 12
    assert_same_store(ts4.safe_set, js4.safe_set)


# -- KNN queries -------------------------------------------------------------------

def _queries(tss, seed, B=5):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, int(tss.count), size=B)
    return (tss.states[rows].numpy() + 0.05 * rng.normal(size=(B, 7))).astype(np.float32)


def _jax_knn(jss, xs, K, fuel=None, fallback=False):
    if fuel is None:
        return jax.vmap(lambda x: JT.knn_query(jss, x, K))(jnp.asarray(xs))
    return jax.vmap(lambda x, f: JT.knn_query(jss, x, K, fuel_available=f,
                                              fallback_unfiltered=fallback))(
        jnp.asarray(xs), jnp.asarray(fuel))


def _rows(r, b):
    """Lane b's valid neighbours as rows [q, state…, distance], sorted by
    (q, state): exact ties in distance (copies of one state) may come in
    another order from torch.topk than from XLA's top-k."""
    v = np.asarray(r.valid[b]).astype(bool)
    rows = np.concatenate([np.asarray(r.q_values[b])[v, None], np.asarray(r.states[b])[v],
                           np.asarray(r.distances[b])[v, None]], axis=1)
    return rows[np.lexsort(rows[:, :-1].T[::-1])]


def assert_same_neighbours(tr, jr):
    """Per lane the same valid neighbours, compared by their Q-values,
    states and distances, not their indices. Distances at
    tests/test_terminal.py:173's rtol 1e-4, with an absolute 2e-4 for the
    f32 cancellation of ‖a‖²+‖b‖²−2a·b (both packages' form) at states of
    norm ~20 and distances under 0.1, whose products the two frameworks sum
    in different orders."""
    np.testing.assert_array_equal(tr.valid.numpy().sum(-1), np.asarray(jr.valid).sum(-1))
    for b in range(tr.valid.shape[0]):
        t, j = _rows(tr, b), _rows(jr, b)
        np.testing.assert_allclose(t[:, :-1], j[:, :-1], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t[:, -1], j[:, -1], rtol=1e-4, atol=2e-4)


def test_weighted_sq_dists_matches_jax():
    from gpmpc_tpu.ops.linalg import weighted_sq_dists as jwsd
    from gpmpc_tpu_torch.ops.linalg import weighted_sq_dists

    rng = np.random.default_rng(9)
    X, Z = rng.normal(size=(6, 7)).astype(np.float32), rng.normal(size=(40, 7)).astype(np.float32)
    w = np.asarray(JT.default_state_weights(7))
    np.testing.assert_allclose(weighted_sq_dists(T(X), T(Z), T(w)).numpy(),
                               jwsd(jnp.asarray(X), jnp.asarray(Z), jnp.asarray(w)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(TT.default_state_weights(14).numpy(),
                                  np.asarray(JT.default_state_weights(14)))


def test_knn_query_matches_jax_and_numpy():
    jss, tss = _both(_trajectories(10), 128)
    xs = _queries(tss, 0)
    tr, jr = TT.knn_query(tss, T(xs), 5), _jax_knn(jss, xs, 5)
    assert tr.indices.shape == (5, 5)
    assert_same_neighbours(tr, jr)
    S = tss.states.numpy()[tss.mask.numpy()]
    w = np.asarray(JT.default_state_weights(7))
    for b in range(5):
        d = np.sqrt((((S - xs[b]) ** 2) * w).sum(1))
        np.testing.assert_allclose(tr.distances[b].numpy(), np.sort(d)[:5], rtol=1e-4, atol=2e-4)


def test_knn_fuel_filter_per_lane_and_fallback_match_jax():
    """One budget per lane: a budget below every requirement comes back
    all-invalid without the fallback and as the unfiltered neighbours with
    it; a budget that keeps some rows feasible is not affected by it."""
    jss, tss = _both(_trajectories(11), 128)
    xs = _queries(tss, 1, B=3)
    mid = float(np.median(tss.fuel_required.numpy()[tss.mask.numpy()]))
    fuel = np.array([-1.0, mid, 0.2], np.float32)
    for fallback in (False, True):
        tr = TT.knn_query(tss, T(xs), 5, fuel_available=T(fuel), fallback_unfiltered=fallback)
        assert_same_neighbours(tr, _jax_knn(jss, xs, 5, fuel, fallback))
    assert not bool(TT.knn_query(tss, T(xs), 5, fuel_available=T(fuel)).valid[0].any())
    fb = TT.knn_query(tss, T(xs), 5, fuel_available=T(fuel), fallback_unfiltered=True)
    assert_same_neighbours(TT.KNNResult(*[t[:1] for t in fb]),
                           _jax_knn(jss, xs[:1], 5))


def test_more_neighbours_than_rows():
    jss = JT.SafeSet.create(32, 7).add_trajectory(jnp.ones((3, 7)), jnp.zeros((3, 3)),
                                                   jnp.ones(3))
    tss = TT.SafeSet.create(32, 7, device="cpu").add_trajectory(torch.ones(3, 7),
                                                                  torch.zeros(3, 3),
                                                                  torch.ones(3))
    tr = TT.knn_query(tss, torch.ones(2, 7), 8)
    assert int(tr.valid[0].sum()) == 3
    assert_same_neighbours(tr, _jax_knn(jss, np.ones((2, 7), np.float32), 8))


def test_adaptive_k_and_interpolation_match_jax():
    jss, tss = _both(_trajectories(12), 128)
    xs = _queries(tss, 2, B=4)
    xs[3] += 100.0  # a sparse region: K_min
    jcfg = JT.LocalSafeSetConfig(K_min=4, K_max=50, density_radius=5.0)
    tcfg = TT.LocalSafeSetConfig(K_min=4, K_max=50, density_radius=5.0)
    kt = TT.adaptive_k(tss, T(xs), tcfg)
    np.testing.assert_array_equal(kt.numpy(),
                                  jax.vmap(lambda x: JT.adaptive_k(jss, x, jcfg))(jnp.asarray(xs)))
    tr, jr = TT.knn_query(tss, T(xs), 5), _jax_knn(jss, xs, 5)
    for mode in ("nearest", "idw", "barycentric"):
        jc, tc = jcfg.replace(interpolation=mode), tcfg.replace(interpolation=mode)
        jq = jax.vmap(lambda r, x: JT.interpolate_q(r, x, jc))(jr, jnp.asarray(xs))
        np.testing.assert_allclose(TT.interpolate_q(tr, T(xs), tc).numpy(), jq, rtol=1e-4)
        jq3 = jax.vmap(lambda r, x: JT.interpolate_q(r, x, jc, k_effective=3))(jr, jnp.asarray(xs))
        np.testing.assert_allclose(TT.interpolate_q(tr, T(xs), tc, k_effective=3).numpy(), jq3,
                                   rtol=1e-4)
    np.testing.assert_allclose(
        TT.LocalSafeSet(tcfg).q_value(tss, T(xs)).numpy(),
        jax.vmap(lambda x: JT.LocalSafeSet(jcfg).q_value(jss, x))(jnp.asarray(xs)), rtol=1e-4)
    np.testing.assert_allclose(
        TT.MultiResolutionLocalSafeSet().q_value(tss, T(xs)).numpy(),
        jax.vmap(lambda x: JT.MultiResolutionLocalSafeSet().q_value(jss, x))(jnp.asarray(xs)),
        rtol=1e-4)
    res, k_eff = TT.LocalSafeSet(tcfg).query_adaptive(tss, T(xs))
    assert res.indices.shape == (4, 50) and torch.equal(k_eff, kt)


# -- convex hulls --------------------------------------------------------------------

def test_hull_constraint_rows_match_jax_exactly():
    rng = np.random.default_rng(13)
    V = rng.normal(size=(3, 6, 7)).astype(np.float32)
    q = rng.random(size=(3, 6)).astype(np.float32)
    valid = rng.random(size=(3, 6)) > 0.3
    A, l, u, ql = TT.hull_constraint_rows(T(V), T(q), torch.tensor(valid), 45, xN_offset=0)
    for b in range(3):
        jA, jl, ju, jq = JT.hull_constraint_rows(jnp.asarray(V[b]), jnp.asarray(q[b]),
                                                 jnp.asarray(valid[b]), 45, xN_offset=0)
        for t, j in ((A, jA), (l, jl), (u, ju), (ql, jq)):
            np.testing.assert_array_equal(t[b].numpy(), np.asarray(j))
    A2 = TT.hull_constraint_rows(T(V), T(q), torch.tensor(valid), 157, xN_offset=150)[0]
    np.testing.assert_array_equal(
        A2[1].numpy(), np.asarray(JT.hull_constraint_rows(
            jnp.asarray(V[1]), jnp.asarray(q[1]), jnp.asarray(valid[1]), 157, xN_offset=150)[0]))


def _square():
    """A unit square in the (r_x, r_y) plane, embedded in 7 dimensions, and
    the far third vertex case of tests/test_terminal.py."""
    V = np.zeros((4, 7), np.float32)
    V[:, 1] = [0.0, 1.0, 0.0, 1.0]
    V[:, 2] = [0.0, 0.0, 1.0, 1.0]
    return V


def test_hull_projection_matches_jax():
    """tests/test_terminal.py:238-250: the projected point at 2e-3, Σλ at
    1e-3, inside/outside the same; invalid vertices pinned to λ = 0."""
    V = _square()
    pts = np.zeros((3, 7), np.float32)
    pts[0, 1:3] = (0.5, 0.5)  # inside
    pts[1, 1:3] = (2.0, 0.5)  # outside: projects to (1, 0.5)
    pts[2, 1:3] = (0.2, -0.7)
    Vb = T(np.broadcast_to(V, (3, 4, 7)).copy())
    hp = TT.project_onto_hull(Vb, T(pts))
    for b in range(3):
        jp = JT.project_onto_hull(jnp.asarray(V), jnp.asarray(pts[b]))
        np.testing.assert_allclose(hp.point[b].numpy(), jp.point, atol=2e-3)
        assert bool(hp.inside[b]) == bool(jp.inside)
    np.testing.assert_allclose(hp.point[1, 1:3].numpy(), [1.0, 0.5], atol=2e-3)
    np.testing.assert_allclose(hp.lam.sum(-1).numpy(), 1.0, atol=1e-3)
    assert TT.contains(Vb, T(pts)).tolist() == [True, False, False]
    # a far invalid vertex takes no weight
    W = np.zeros((1, 3, 7), np.float32)
    W[0, 1, 1], W[0, 2, 1] = 1.0, 100.0
    x = np.zeros((1, 7), np.float32)
    x[0, 1] = 50.0
    valid = torch.tensor([[True, True, False]])
    assert not bool(TT.contains(T(W), T(x), valid)[0])
    assert float(TT.project_onto_hull(T(W), T(x), valid).lam[0, 2]) < 1e-4
    hc = TT.ConvexHullConstraint(Vb)
    assert hc.contains(T(pts)).tolist() == [True, False, False]
    np.testing.assert_allclose(hc.project(T(pts)).point.numpy(), hp.point.numpy())


def test_terminal_set_manager_matches_jax():
    jss, tss = _both(_trajectories(14), 128)
    xs = _queries(tss, 3, B=2)
    tr = TT.TerminalSetManager(n_vertices=6).get_terminal_set(tss, T(xs))
    jr = jax.vmap(lambda x: JT.TerminalSetManager(n_vertices=6).get_terminal_set(jss, x))(
        jnp.asarray(xs))
    assert tr.states.shape == (2, 6, 7)
    assert_same_neighbours(tr, jr)


# -- Q-functions -----------------------------------------------------------------------

def test_q_functions_match_jax():
    jss, tss = _both(_trajectories(15), 128)
    xs = _queries(tss, 4, B=4)
    jx = jnp.asarray(xs)
    np.testing.assert_allclose(TT.idw_q(tss, T(xs), K=5).numpy(),
                               jax.vmap(lambda x: JT.idw_q(jss, x, K=5))(jx), rtol=1e-4)
    np.testing.assert_allclose(TT.local_linear_q(tss, T(xs), K=10).numpy(),
                               jax.vmap(lambda x: JT.local_linear_q(jss, x, K=10))(jx),
                               rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(TT.iteration_q_values(tss, T(xs), 3, K=5).numpy(),
                               jax.vmap(lambda x: JT.iteration_q_values(jss, x, 3, K=5))(jx),
                               rtol=1e-4)
    for method in ("idw", "linear", "gp"):
        tm, jm = TT.QFunctionManager(method=method, K=8), JT.QFunctionManager(method=method, K=8)
        np.testing.assert_allclose(tm.value(tss, T(xs)).numpy(),
                                   jax.vmap(lambda x: jm.value(jss, x))(jx), rtol=2e-3, atol=1e-2)
    tm = TT.QFunctionManager(method="gp", refit_every=2)
    tm = tm.update(torch.Generator().manual_seed(0), tss)
    assert tm.gp_q is None and tm.updates_seen == 1
    tm = tm.update(torch.Generator().manual_seed(0), tss)
    assert tm.gp_q is not None and tm.gp_q.fitted


def test_gp_q_function_matches_jax():
    """The JAX package's fitted GP Q-function carried across predicts the
    same values; the port's own fit meets tests/test_terminal.py:283-288's
    bound (within 3 of the stored Q at a stored state)."""
    jss, tss = _both(_trajectories(16), 128)
    jg = JT.GPQFunction.fit(jax.random.PRNGKey(0), jss, n_inducing=24)
    s = jg.gp_state
    d = {k: np.asarray(getattr(s, k)) for k in ("Z", "X", "y", "mask", "log_noise", "Luu_inv",
                                                "LB_inv", "c")}
    d["log_variance"] = np.asarray(s.kernel.log_variance)
    d["log_lengthscales"] = np.asarray(s.kernel.log_lengthscales)
    tg = TT.GPQFunction(gp_state=convert.sparse_gp_state_from_numpy(d, "cpu"), fitted=True)
    xs = tss.states[:40:7]
    v, sd = tg.value_and_std(xs)
    jv, jsd = jax.vmap(jg.value_and_std)(jnp.asarray(xs.numpy()))
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(sd.numpy(), jsd, rtol=1e-3, atol=1e-3)
    own = TT.GPQFunction.fit(torch.Generator().manual_seed(0), tss, n_inducing=24)
    v, sd = own.value_and_std(tss.states[10:11])
    assert abs(float(v[0]) - float(tss.q_values[10])) < 3.0 and float(sd[0]) >= 0
