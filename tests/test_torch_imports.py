"""The port stands alone: no JAX, nothing of v2e2v_tpu, no cv2, PIL, pandas or
matplotlib (the card's machine has none of them), and no silent CPU fallback
in its entry points."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "v2e2v_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "v2e2v_tpu", "cv2", "PIL", "pandas", "matplotlib")


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
        "import v2e2v_tpu_torch.models.emulator, v2e2v_tpu_torch.models.v2e2v\n"
        "import v2e2v_tpu_torch.ops.cuda.emulator_iters, v2e2v_tpu_torch.ops.numerics\n"
        "import v2e2v_tpu_torch.ops.cuda.core, v2e2v_tpu_torch.ops.cuda._lib\n"
        "import v2e2v_tpu_torch.ops.cuda.conv_tc, v2e2v_tpu_torch.ops.image\n"
        "import v2e2v_tpu_torch.ops.fused\n"
        "import v2e2v_tpu_torch.runtime, v2e2v_tpu_torch.data.event_readers\n"
        "import v2e2v_tpu_torch.data.video_readers, v2e2v_tpu_torch.utils.image_io\n"
        "import v2e2v_tpu_torch.utils.evaluate, v2e2v_tpu_torch.utils.data_io\n"
        "import v2e2v_tpu_torch.utils.configs, v2e2v_tpu_torch.utils.profiling\n"
        "import v2e2v_tpu_torch.cli.test_e2v, v2e2v_tpu_torch.data.synthetic\n"
        "import v2e2v_tpu_torch.cli.test, v2e2v_tpu_torch.cli.generate_events\n"
        "import v2e2v_tpu_torch.cli.train_e2v, v2e2v_tpu_torch.cli.train\n"
        "import v2e2v_tpu_torch.training.losses, v2e2v_tpu_torch.training.steps\n"
        "import v2e2v_tpu_torch.data.datasets, v2e2v_tpu_torch.data.manifests\n"
        "import v2e2v_tpu_torch.data.prefetch, v2e2v_tpu_torch.utils.logging\n"
        "import v2e2v_tpu_torch.models.superslomo, v2e2v_tpu_torch.data.interpolating_reader\n"
        "import v2e2v_tpu_torch.parallel.distributed, v2e2v_tpu_torch.parallel.mesh\n"
        "import v2e2v_tpu_torch.parallel.spatial\n"
        "import v2e2v_tpu_torch.serving\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'v2e2v_tpu', 'cv2', 'PIL', 'pandas',\n"
        "                              'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    from v2e2v_tpu_torch import (
        CistaConfig,
        StreamPool,
        cista_zero_state,
        init_cista_lstc,
        init_cista_tc,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CistaConfig(image_dim=(8, 8), base_channels=8, depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cista_lstc(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cista_zero_state(cfg, 1)
    sd = init_cista_lstc(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamPool(cfg, sd)
    tc = CistaConfig(image_dim=(8, 8), base_channels=8, depth=1, model_mode="cista-tc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cista_tc(torch.Generator().manual_seed(0), tc)
    sd = init_cista_tc(torch.Generator().manual_seed(0), tc, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamPool(tc, sd)
    from v2e2v_tpu_torch.models.superslomo import Upsampler
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Upsampler([32, 40], ckpt_path="absent.ckpt")


@pytest.mark.parametrize("cli", ["test", "test_e2v", "generate_events", "train_e2v", "train"])
def test_cli_entry_points_raise_when_no_card(cli, monkeypatch, tmp_path):
    """Each CLI's main() without V2E2V_PLATFORM needs the card, and raises
    before it reads any data."""
    import importlib

    module = importlib.import_module(f"v2e2v_tpu_torch.cli.{cli}")
    monkeypatch.delenv("V2E2V_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--path_to_test_data", str(tmp_path / "absent"), "--path_to_test_model",
                     str(tmp_path / "absent.pth.tar"), "-o", str(tmp_path / "out"),
                     "--path_to_train_data", str(tmp_path / "absent"), "--path_to_model",
                     str(tmp_path / "models")])
    assert not (tmp_path / "out").exists() and not (tmp_path / "models").exists()


def test_emulator_and_v2e2v_entry_points_raise_when_no_card(monkeypatch):
    import numpy as np

    from v2e2v_tpu_torch import (
        CistaConfig,
        EmulatorConfig,
        GeneratorNoise,
        V2E2VConfig,
        emulate_pack,
        emulator_init,
        emulator_init_from_pack,
        init_cista_lstc,
        v2e2v_forward,
        v2e2v_init_state,
        v2e2v_sequence,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emu = EmulatorConfig()
    cfg = V2E2VConfig(CistaConfig(image_dim=(8, 8), base_channels=8, depth=1), emu)
    frames = np.full((1, 3, 8, 8), 100.0, np.float32)
    t = np.array([[0.0, 0.004, 0.008]], np.float32)
    g = torch.Generator().manual_seed(0)
    sd = init_cista_lstc(g, cfg.cista, device="cpu")
    calls = [
        lambda: emulator_init(g, emu, frames[:, 0], np.zeros((1, 8, 8), np.float32), 0.0),
        lambda: emulator_init_from_pack(emu, frames, t, g),
        lambda: emulate_pack(emu, None, frames, t, g),
        lambda: v2e2v_init_state(cfg, frames, t, g),
        lambda: v2e2v_forward(sd, cfg, frames, t, None, g),
        lambda: v2e2v_sequence(sd, cfg, frames[None], t[None], g),
        lambda: GeneratorNoise.from_seed(0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    recs, _ = v2e2v_sequence(sd, cfg, frames[None], t[None], g, device="cpu")
    assert recs.device.type == "cpu"
