"""The port stands alone: no JAX, nothing of v2e2v_tpu, and no silent CPU
fallback in its entry points."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "v2e2v_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "v2e2v_tpu")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = set(_imported_roots(path)) & set(FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, v2e2v_tpu_torch, v2e2v_tpu_torch.ops.voxel, v2e2v_tpu_torch.utils.checkpoint\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'v2e2v_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    from v2e2v_tpu_torch import CistaConfig, StreamPool, cista_zero_state, init_cista_lstc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CistaConfig(image_dim=(8, 8), base_channels=8, depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cista_lstc(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cista_zero_state(cfg, 1)
    sd = init_cista_lstc(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamPool(cfg, sd)
