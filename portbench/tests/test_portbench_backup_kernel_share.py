"""The reader of ``backup_kernel_share`` on synthetic traced windows."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.core.trace import TraceData  # noqa: E402
from portbench.run import reader  # noqa: E402

K, A = "safety.value.kernel", "safety.value.autograd"


def _window(units, spans):
    """A window of ``units`` units whose host events are ``spans`` (names),
    each inside a filter call beside the device op it issued."""
    host, device, t = [], [], 0.0
    for name in spans:
        host += [("safety.filter", t, t + 8.0), (name, t + 1.0, t + 5.0),
                 ("cudaLaunchKernel", t + 2.0, t + 3.0)]
        device.append(("kernel", t + 3.0, t + 4.0))
        t += 10.0
    return TraceData(window_s=t / 1e6, units=units, trajectories=0, device_name="cpu",
                     device=device, host=host, launches=[])


@pytest.mark.parametrize("units,spans,want", [
    (5, [K] * 10, 100.0),  # two kernel evaluations a filtered step
    (5, [A] * 10, 0.0),  # the autograd route throughout
    (2, [K, A, K, K], 75.0),
    (3, ["safety.check", "safety.grad"], None),  # a program that does not name the route
    (0, [], None),
])
def test_backup_kernel_share(units, spans, want):
    assert reader("backup_kernel_share.rescue")(_window(units, spans)) == want
