"""The reader of ``cycle_replay_share`` on synthetic traced windows."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.core.trace import TraceData  # noqa: E402
from portbench.run import reader  # noqa: E402


def _window(units, spans):
    """A window of ``units`` units whose host events are ``spans`` (names),
    each beside the device op it issued."""
    host, device, t = [], [], 0.0
    for name in spans:
        host += [(name, t, t + 5.0), ("cudaGraphLaunch", t + 1.0, t + 2.0)]
        device.append(("kernel", t + 2.0, t + 3.0))
        t += 10.0
    return TraceData(window_s=t / 1e6, units=units, trajectories=0, device_name="cpu",
                     device=device, host=host, launches=[])


@pytest.mark.parametrize("units,spans,want", [
    (20, ["gpmpc.replay"] * 20, 100.0),  # every cycle replayed
    (10, ["gpmpc.capture"] + ["gpmpc.replay"] * 9, 90.0),  # the recording in the window
    (5, ["gpmpc.eager"] * 5, 0.0),  # every cycle eager: Path D's
    (4, ["gpmpc.eager", "gpmpc.replay", "gpmpc.replay", "gpmpc.eager"], 50.0),
    (6, ["gpmpc.rollout", "admm.chunk"], None),  # a program without the route
    (0, [], None),
])
def test_cycle_replay_share(units, spans, want):
    assert reader("cycle_replay_share")(_window(units, spans)) == want
