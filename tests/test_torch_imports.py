"""The port stands alone: importing ``repro_torch`` (every module of it) and
``chip_smoke`` pulls in neither ``jax`` nor the reference package ``repro``,
and needs neither ``triton`` nor a CUDA compiler."""
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
{extra}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("extra", ["", "import chip_smoke"], ids=["package", "chip_smoke"])
def test_port_imports_neither_jax_nor_the_reference_package(extra):
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT), extra=extra)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card():
    """No CUDA device: exit code 1, no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 1
    assert '"ok"' not in proc.stdout
