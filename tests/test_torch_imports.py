"""The port stands alone: ``gpmpc_tpu_torch`` and ``chip_smoke.py`` import
neither JAX (nor flax/optax) nor the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)  # the suite's xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "gpmpc_tpu")


def _port_files():
    files = sorted((ROOT / "gpmpc_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import gpmpc_tpu_torch, gpmpc_tpu_torch.convert, gpmpc_tpu_torch.mpc\n"
        "import gpmpc_tpu_torch.learning, gpmpc_tpu_torch.ops.kernels.admm_chunk\n"
        "import gpmpc_tpu_torch.reference, gpmpc_tpu_torch.main_path\n"
        "import gpmpc_tpu_torch.learning.hyperparameter_tuner, gpmpc_tpu_torch.profile_cycle\n"
        "import gpmpc_tpu_torch.experiments.monte_carlo, gpmpc_tpu_torch.chunk_bench\n"
        "import gpmpc_tpu_torch.dynamics.rocket6dof, gpmpc_tpu_torch.mpc.rti6dof\n"
        "import gpmpc_tpu_torch.mpc.cost_functions, gpmpc_tpu_torch.gp.structured_gp\n"
        "import gpmpc_tpu_torch.gp.online_update, gpmpc_tpu_torch.learning.online_gp_mpc\n"
        "import gpmpc_tpu_torch.gp.exact_gp, gpmpc_tpu_torch.gp.fast_gp, gpmpc_tpu_torch.gp.kernels\n"
        "import gpmpc_tpu_torch.gp.sparse_gp, gpmpc_tpu_torch.ops.kmeans\n"
        "import gpmpc_tpu_torch.learning.batched_learner, gpmpc_tpu_torch.learning.data_manager\n"
        "import gpmpc_tpu_torch.learning.novelty_selector\n"
        "import gpmpc_tpu_torch.ops.qp.ipm, gpmpc_tpu_torch.terminal, gpmpc_tpu_torch.lmpc\n"
        "import gpmpc_tpu_torch.terminal.safe_set, gpmpc_tpu_torch.terminal.local_safe_set\n"
        "import gpmpc_tpu_torch.terminal.convex_hull, gpmpc_tpu_torch.terminal.q_function\n"
        "import gpmpc_tpu_torch.lmpc.lmpc\n"
        "import gpmpc_tpu_torch.safety, gpmpc_tpu_torch.safety.safety_filter\n"
        "import gpmpc_tpu_torch.safety.backup_controller, gpmpc_tpu_torch.safety.invariant_sets\n"
        "import gpmpc_tpu_torch.safety.tube_mpc, gpmpc_tpu_torch.mpc.nominal\n"
        "import gpmpc_tpu_torch.mpc.constraints, gpmpc_tpu_torch.mpc.uncertainty_prop\n"
        "import gpmpc_tpu_torch.ops.linalg, gpmpc_tpu_torch.learning.online_learner\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the smoke test exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
