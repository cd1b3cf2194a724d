"""Writes ``experiments_x0.npz``: the initial states that
``scripts/run_experiments.py --standard --seed 0`` flies, so that the port
flies the same lanes as the suite's record.

- ``x0`` (256, 7): ``sample_initial_conditions(PRNGKey(0), sim, 256)`` for
  the script's ``SimulationConfig`` (``scripts/run_experiments.py:86-91``:
  200 steps, 30 ± 2 m, −3 m/s, m_dry from ``config/rocket_params.yaml``).

Run: ``env JAX_PLATFORMS=cpu python tests/fixtures/make_experiments_x0.py``.
"""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from gpmpc_tpu.experiments import SimulationConfig, sample_initial_conditions  # noqa: E402

N_RUNS = 256  # --standard


def suite_x0():
    """The script's draw, as float32 NumPy."""
    sim = SimulationConfig(max_steps=200, dt=0.1, altitude_mean=30.0, altitude_std=2.0,
                           vertical_velocity_mean=-3.0, m_dry=1.0)
    return np.asarray(sample_initial_conditions(jax.random.PRNGKey(0), sim, N_RUNS), np.float32)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez(os.path.join(os.path.dirname(__file__), "experiments_x0.npz"), x0=suite_x0())
