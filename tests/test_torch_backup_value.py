"""The safety filter's backup-value seam (``ops/kernels/backup_value.py``) on
the CPU: the downdraft step value against the lambda it replaces, the
seam's decision, and a float32 forward-mode mirror of the kernel's
arithmetic (``csrc/backup_value.cu``, which runs only on a card) against the
autograd route, on the filter's draws and at the kinks of the rollout."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.chunk_bench import filter_lanes
from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, Rocket3DoFStep, Rocket6DoFParams
from gpmpc_tpu_torch.dynamics import rocket3dof as r3
from gpmpc_tpu_torch.dynamics import rocket6dof as r6
from gpmpc_tpu_torch.main_path import (DT, RESCUE_GUST, online_safety_path, safety_rescue_path,
                                       velocity_ellipsoid_filter)
from gpmpc_tpu_torch.ops.kernels import backup_value as BV
from gpmpc_tpu_torch.safety import (DescentFunnelSet, EmergencyBrakingController,
                                    PDBackupController, filter_control)
from gpmpc_tpu_torch.safety.safety_filter import _value_and_grad
from gpmpc_tpu_torch.utils.profiler import solve_record

torch.set_num_threads(1)

# The mirror runs forward mode (the tangent ∂x/∂u carried with the state, as
# the kernel does) and the plain version reverse mode: the same float32
# values summed in another order. Over the rollout's 20 RK4 stages and 4
# backup controls that moved V by ≤ 2.3e-6 relative and ∂V/∂u by ≤ 2.5e-7
# of its lane's scale (the largest |∂V/∂u_j|, at least 1) on 8 seeds of
# both draws below (16,384 lanes); the limits leave ×5 room.
V_RTOL, G_TOL = 1.2e-5, 1.3e-6


@pytest.fixture(scope="module")
def rescue():
    return safety_rescue_path("cpu")


def _states(n=256, seed=0):
    """The rescue's states: the filter's draws and its campaign's initial
    states (30 ± 2 m, −3 m/s), under nominal and braking controls."""
    x, u = filter_lanes(n, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    xc = (np.array([2.0, 30.0, 0.0, 0.0, -3.0, 0.0, 0.0])
          + rng.normal(size=(n, 7)) * [0.05, 2.0, 1.0, 1.0, 0.3, 0.2, 0.2])
    return torch.cat([x, torch.tensor(xc, dtype=torch.float32)]), torch.cat([u, u])


def test_downdraft_step_is_the_lambda_bit_for_bit(rescue):
    """The plant and the filter's model: the step value performs the
    lambda's tensor ops in the lambda's order, so the campaign's plant
    states do not change by one bit."""
    p = Rocket3DoFParams(device="cpu")
    lam = lambda x, u: r3.step(p, x, u, DT) + DT * r3.as_vertical(r3.gust_accel(x, RESCUE_GUST))
    x, u = _states()
    assert rescue.plant is rescue.F_filter
    assert type(rescue.plant) is r3.Rocket3DoFDowndraftStep
    for uu in (u, rescue.backup.control(x)):
        assert torch.equal(rescue.plant(x, uu), lam(x, uu))
    # a short closed loop under the backup
    xs = x
    for _ in range(10):
        xs, ys = rescue.plant(xs, rescue.backup.control(xs)), lam(xs, rescue.backup.control(xs))
        assert torch.equal(xs, ys)


def _fused_cases():
    p = Rocket3DoFParams(device="cpu")
    step, down = Rocket3DoFStep(p, DT), r3.Rocket3DoFDowndraftStep(p, DT, RESCUE_GUST)
    brake = EmergencyBrakingController(T_max=6.5, g_I=torch.tensor([-1.0, 0.0, 0.0]))
    funnel = DescentFunnelSet(0.6, 1.5)
    ellipsoid, _, _ = velocity_ellipsoid_filter("cpu")
    pd = PDBackupController(x_eq=torch.zeros(7), u_eq=torch.tensor([2.0, 0.0, 0.0]))
    return [
        ("downdraft", down, brake, funnel, torch.float32, True),
        ("nominal", step, brake, funnel, torch.float32, True),
        ("lambda", lambda x, u: down(x, u), brake, funnel, torch.float32, False),
        ("ellipsoid", down, brake, ellipsoid, torch.float32, False),
        ("gp_model", "online", brake, funnel, torch.float32, False),
        ("float64", down, brake, funnel, torch.float64, False),
        ("euler", Rocket3DoFStep(p.replace(integrator="euler"), DT), brake, funnel,
         torch.float32, False),
        ("pd_backup", down, pd, funnel, torch.float32, False),
        ("sixdof", r6.Rocket6DoFStep(Rocket6DoFParams(device="cpu"), DT), brake, funnel,
         torch.float32, False),
    ]


@pytest.mark.parametrize("case", _fused_cases(), ids=lambda c: c[0])
def test_fused_admits_exactly_what_the_kernel_computes(case):
    """The 3-DoF RK4 step values (nominal and with the downdraft) under
    emergency braking and the funnel, in float32; not a lambda, the online
    path's GP-padded model, the ellipsoid, float64, another integrator,
    backup or model."""
    _, step, backup, inv, dtype, want = case
    x = torch.tensor([[2.0, 5.0, 0.3, -0.2, -3.0, 0.1, 0.0]] * 2, dtype=dtype)
    if step == "online":
        op = online_safety_path("cpu")
        step = op.filter_model(op.inner[0](x))
    assert BV.fused(step, backup, inv, x) is want


# -- the mirror --------------------------------------------------------------


def _f_jvp(c, z, dz, u, du, T, dT):
    """f(z, u) (B, 7) and its derivative along (dz (B,7,3), du (B,3,3)), as
    the kernel's f_jvp writes it."""
    rm = 1.0 / z[:, 0]
    v, dv = z[:, 4:7], dz[:, 4:7]
    vmag = torch.sqrt((v * v).sum(1) + c["eps2"])
    s = -c["kd"] * vmag
    k = torch.cat([(-c["alpha"] * T)[:, None], v,
                   u * rm[:, None] + c["g"] + s[:, None] * v * rm[:, None]], 1)
    ds = -c["kd"] * ((v[:, :, None] * dv).sum(1) / vmag[:, None])
    dmr = dz[:, 0] * rm[:, None]
    dkv = (du + ds[:, None] * v[:, :, None] + s[:, None, None] * dv
           - (u + s[:, None] * v)[:, :, None] * dmr[:, None]) * rm[:, None, None]
    dk = torch.cat([(-c["alpha"] * dT)[:, None], dv, dkv], 1)
    return k, dk


def _step_jvp(c, x, dx, u, du):
    """The kernel's step_jvp: RK4, then the downdraft at the step's start."""
    T = torch.sqrt((u * u).sum(1) + c["eps2"])
    dT = (u[:, :, None] * du).sum(1) / T[:, None]
    k1, d1 = _f_jvp(c, x, dx, u, du, T, dT)
    k2, d2 = _f_jvp(c, x + c["h2"] * k1, dx + c["h2"] * d1, u, du, T, dT)
    k3, d3 = _f_jvp(c, x + c["h2"] * k2, dx + c["h2"] * d2, u, du, T, dT)
    k4, d4 = _f_jvp(c, x + c["h"] * k3, dx + c["h"] * d3, u, du, T, dT)
    sig = 1.0 / (1.0 + torch.exp(x[:, 1] - 6.0))
    gust = c["h"] * (c["gust"] * sig)
    dgust = -c["h"] * (c["gust"] * (sig * (1.0 - sig)))[:, None] * dx[:, 1]
    xn = x + c["h6"] * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    dxn = dx + c["h6"] * (d1 + 2.0 * d2 + 2.0 * d3 + d4)
    e4 = torch.zeros(7)
    e4[4] = 1.0
    return xn + gust[:, None] * e4, dxn + dgust[:, None] * e4[:, None]


def _braking_jvp(c, x, dx):
    """The kernel's braking_jvp: u_b(x) and its derivative along dx, with
    autograd's subgradient at each kink."""
    v, dv = x[:, 4:7], dx[:, 4:7]
    vsq = (v * v).sum(1)
    moving = vsq > 1e-12
    vmag = torch.sqrt(torch.where(moving, vsq, torch.ones_like(vsq)))
    up = torch.tensor([1.0, 0.0, 0.0]).expand_as(v)
    d = torch.where(moving[:, None], -v / vmag[:, None], up)
    dvmag = (v[:, :, None] * dv).sum(1) / vmag[:, None]
    dd = torch.where(moving[:, None, None],
                     (-dv - d[:, :, None] * dvmag[:, None]) / vmag[:, None, None], 0.0)
    w = d * c["T"] - x[:, 0:1] * c["b"]
    dw = dd * c["T"] - dx[:, 0:1] * c["b"][:, None]
    wsq = (w * w).sum(1)
    above = wsq >= 1e-12
    wmag = torch.sqrt(wsq.clamp_min(1e-12))
    dwmag = torch.where(above[:, None], (w[:, :, None] * dw).sum(1) / wmag[:, None], 0.0)
    s = c["T"] * (1.0 / wmag)
    inside = s <= 1.0
    sc = torch.where(inside, s, torch.ones_like(s))
    dsc = torch.where(inside[:, None], -s[:, None] * dwmag / wmag[:, None], 0.0)
    return w * sc[:, None], dw * sc[:, None, None] + w[:, :, None] * dsc[:, None]


def _constants(step, backup, inv):
    """The kernel's Model, as float32 numbers."""
    m = torch.tensor(BV._model(step, backup, inv), dtype=torch.float32)
    return {"alpha": m[0], "g": m[1:4], "kd": m[4], "eps2": m[5], "h2": m[6], "h": m[7],
            "h6": m[8], "gust": m[9], "T": m[10], "b": m[11:14], "slope": m[14]}


def _mirror(step, backup, inv, N, x, u):
    """(V, ∂V/∂u) as the kernel computes them, in plain float32 PyTorch."""
    c = _constants(step, backup, inv)
    B = x.shape[0]
    dx = torch.zeros(B, 7, 3)
    du = torch.eye(3).expand(B, 3, 3)
    x, dx = _step_jvp(c, x, dx, u, du)
    for _ in range(N - 1):
        ub, dub = _braking_jvp(c, x, dx)
        x, dx = _step_jvp(c, x, dx, ub, dub)
    above = x[:, 1] >= 0.0
    v, dv = x[:, 4:7], dx[:, 4:7]
    V = (v * v).sum(1) - c["slope"] * torch.where(above, x[:, 1], torch.zeros_like(x[:, 1]))
    g = 2.0 * (v[:, :, None] * dv).sum(1) - torch.where(above[:, None], c["slope"] * dx[:, 1],
                                                          0.0)
    return V, g


def _assert_mirror_matches(step, backup, inv, N, x, u):
    V, g = _mirror(step, backup, inv, N, x, u)
    V_ref, g_ref = _value_and_grad(step, backup, inv, N, x, u)
    assert bool(torch.isfinite(V).all()) and bool(torch.isfinite(g).all())
    torch.testing.assert_close(V, V_ref, rtol=V_RTOL, atol=V_RTOL)
    scale = g_ref.abs().amax(1, keepdim=True).clamp_min(1.0)
    assert bool(((g - g_ref).abs() <= G_TOL * scale).all()), (g - g_ref).abs().max()
    return V_ref, g_ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mirror_matches_autograd_on_the_filter_draws(rescue, seed):
    """1,024 draws of ``chunk_bench.filter_lanes`` (altitude 0.5-8 m in the
    downdraft, some lanes reaching the ground within the rollout) and the
    campaign's initial states, through the rescue filter's N = 5."""
    x, u = filter_lanes(1024, torch.Generator().manual_seed(seed), "cpu")
    V, _ = _assert_mirror_matches(rescue.F_filter, rescue.backup, rescue.invariant,
                                  rescue.filter_config.N, x, u)
    assert bool((V > rescue.invariant.alpha).any()) and bool((V <= rescue.invariant.alpha).any())
    x, u = _states(seed=seed)
    _assert_mirror_matches(rescue.F_filter, rescue.backup, rescue.invariant,
                           rescue.filter_config.N, x, u)


@pytest.mark.parametrize("h", [0.0, -0.05])
def test_mirror_matches_autograd_on_landed_lanes(rescue, h):
    """Lanes at rest on the ground (h = 0 and below, v = 0) under the rescue
    filter, with nominal, zero and braking thrust."""
    x = torch.tensor([[2.0, h, 0.1, -0.2, 0.0, 0.0, 0.0]]).repeat(3, 1)
    u = torch.tensor([[2.0, 0.0, 0.0], [0.0, 0.0, 0.0], [6.5, 0.3, -0.2]])
    _assert_mirror_matches(rescue.F_filter, rescue.backup, rescue.invariant,
                           rescue.filter_config.N, x, u)


@pytest.mark.parametrize("h", [0.0, -0.05])
def test_mirror_takes_autograds_subgradients_at_rest(h):
    """A lane held exactly at rest through the whole rollout: no mass flow
    (I_sp = ∞), thrust T_max = m against gravity, no downdraft, so every
    backup step sees v = 0 (the constant "up" direction) and the funnel sees
    h_N = h exactly. At h = 0 the clamp passes ∂h_N/∂u, below it nothing:
    the two differ, and the mirror takes autograd's side at each."""
    p = Rocket3DoFParams(I_sp=math.inf, device="cpu")
    step = Rocket3DoFStep(p, DT)
    backup = EmergencyBrakingController(T_max=2.0, g_I=torch.tensor([-1.0, 0.0, 0.0]))
    inv = DescentFunnelSet(0.6, 1.5)
    x = torch.tensor([[2.0, h, 0.0, 0.0, 0.0, 0.0, 0.0]])
    u = torch.tensor([[2.0, 0.0, 0.0]])
    assert torch.equal(BV.backup_rollout_terminal(step, backup, x, u, 5), x)
    V, g = _assert_mirror_matches(step, backup, inv, 5, x, u)
    assert float(V) == 0.0
    if h == 0.0:
        assert float(g[0, 0]) < -1e-3 and float(g[0, 1:].abs().max()) == 0.0
    else:
        assert float(g.abs().max()) == 0.0


def _on_the_thrust_limit(T=6.5, m=2.0, lanes=4001):
    """States whose braking thrust before the clamp has T_max/‖u‖ == 1 in
    float32 exactly: moving up and sideways so that the direction's vertical
    part is −m/(2T), v[4] scanned over ±2,000 ulps."""
    c = m / (2 * T)
    base = torch.tensor([m, 3.0, 0.0, 0.0, c, -math.sqrt(1 - c * c), 0.0])
    x = base.repeat(lanes, 1)
    v0 = torch.tensor(c, dtype=torch.float32)
    steps = torch.arange(lanes) - lanes // 2
    x[:, 4] = v0 + steps * (torch.nextafter(v0, torch.tensor(1.0)) - v0)
    backup = EmergencyBrakingController(T_max=T, g_I=torch.tensor([-1.0, 0.0, 0.0]))
    # the controller's own ops up to the clamp
    v = x[:, 4:7]
    w = -v / torch.sqrt((v * v).sum(-1, keepdim=True)) * T - x[:, 0:1] * backup.g_I
    ratio = T / torch.sqrt((w * w).sum(-1, keepdim=True).clamp_min(1e-12))
    return x[ratio[:, 0] == 1.0], backup


def test_mirror_braking_at_the_thrust_limit():
    """Where ‖u‖ lands exactly on T_max the clamp passes its derivative
    (autograd's ``self <= max``): the mirror's Jacobian of the backup control
    equals autograd's there, and differs from the clamped branch's."""
    x, backup = _on_the_thrust_limit()
    assert x.shape[0] >= 1
    x = x[:1]
    c = _constants(Rocket3DoFStep(Rocket3DoFParams(device="cpu"), DT), backup,
                   DescentFunnelSet(0.6, 1.5))
    u, du = _braking_jvp(c, x, torch.eye(7)[None])  # (1,3), (1,3,7)
    J = torch.autograd.functional.jacobian(backup.control, x[0])
    assert torch.equal(u, backup.control(x))
    torch.testing.assert_close(du[0], J, rtol=1e-6, atol=1e-6)
    # the clamped branch's Jacobian is that of the unscaled thrust alone: it
    # leaves out u·∂(T/‖u‖), so the kink is real
    J_clamped = torch.autograd.functional.jacobian(
        lambda xx: -xx[4:7] / torch.linalg.vector_norm(xx[4:7]) * backup.T_max
        - xx[0] * backup.g_I, x[0])
    assert float((J - J_clamped).abs().max()) > 1e-3


# -- the seam and the filter on the CPU --------------------------------------


def test_seam_on_the_cpu_is_the_autograd_route(rescue):
    """On a CPU tensor the wrapper runs the plain version, launching nothing;
    it refuses what the kernel does not take."""
    x, u = filter_lanes(64, torch.Generator().manual_seed(4), "cpu")
    args = (rescue.F_filter, rescue.backup, rescue.invariant, 5)
    before = BV.LAUNCHES
    V, g = BV.backup_value_grad(*args, x, u)
    V0, g0 = _value_and_grad(*args, x, u)
    assert torch.equal(V, V0) and torch.equal(g, g0) and BV.LAUNCHES == before
    with pytest.raises(ValueError):
        BV.backup_value_grad(*args, x[:, :6].contiguous(), u)
    with pytest.raises(ValueError):
        BV.backup_value_grad(*args, x, u[:3])
    with pytest.raises(TypeError):
        BV.backup_value_grad(*args, x.double(), u.double())
    with pytest.raises(ValueError):
        BV.backup_value_grad(*args, x.t().contiguous().t(), u)
    with pytest.raises(ValueError):
        BV.backup_value_grad(*args[:3], 0, x, u)


def test_bound_counts_bytes_and_operations():
    """At the rescue's 1,024 lanes and N = 5: 56 bytes a lane, 5,421
    operations a lane; the operations bound it, under a tenth of a µs."""
    ms, by, nbytes, flops = BV.bound_ms(1024, 5)
    assert (nbytes, flops, by) == (1024 * 56, 1024 * 5421, "ops")
    assert ms < 1e-4


def test_filter_names_its_route_on_the_cpu(rescue):
    """Each of the filter's two evaluations of V and ∂V/∂u is a span
    ``safety.value.autograd`` on the CPU, inside ``safety.check`` and
    ``safety.grad``; the solve record keeps both SCP iterations."""
    from torch.profiler import ProfilerActivity, profile

    x, u = filter_lanes(16, torch.Generator().manual_seed(5), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof, solve_record() as rec:
        filter_control(rescue.F_filter, rescue.backup, rescue.invariant, rescue.filter_config,
                       x, u)
    names = [e.name for e in prof.events()]
    assert names.count("safety.value.autograd") == 2
    assert "safety.value.kernel" not in names
    assert len(rec["filter"]) == 2
