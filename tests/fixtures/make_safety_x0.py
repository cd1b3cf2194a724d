"""Writes ``safety_x0.npz``: the initial states the JAX package's
safety-filtered campaigns drew, so that the port flies the same lanes as
the artifacts it is compared with.

- ``campaign`` (1024, 7): ``sample_initial_conditions(PRNGKey(0), ...)``
  around 30 m (σ 2 m), as ``scripts/run_campaign_tpu.py`` draws them for
  ``campaign_rti3dof_safety_gust_1024.json`` and
  ``campaign_gpmpc3dof_safety_1024.json``;
- ``online`` (512, 7): ``sample_initial_conditions(PRNGKey(11), ...)``
  around 15 m (σ 1.5 m), as ``scripts/run_online_safety_tpu.py`` draws them
  for ``campaign_online_safety_tpu_512.json``.

Run: ``env JAX_PLATFORMS=cpu python tests/fixtures/make_safety_x0.py``.
"""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from gpmpc_tpu.experiments import SimulationConfig, sample_initial_conditions  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    campaign = sample_initial_conditions(
        jax.random.PRNGKey(0), SimulationConfig(max_steps=150, altitude_mean=30.0,
                                                altitude_std=2.0), 1024, n_x=7)
    online = sample_initial_conditions(
        jax.random.PRNGKey(11), SimulationConfig(max_steps=110, altitude_mean=15.0,
                                                 altitude_std=1.5), 512, n_x=7)
    np.savez(os.path.join(os.path.dirname(__file__), "safety_x0.npz"),
             campaign=np.asarray(campaign, np.float32), online=np.asarray(online, np.float32))
