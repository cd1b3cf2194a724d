"""The port stands alone: ``gpmpc_tpu_torch`` and ``chip_smoke.py`` import
neither JAX (nor flax/optax) nor the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

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
