"""v2e2v_tpu_torch — the PyTorch/CUDA port of ``v2e2v_tpu`` for an NVIDIA H100.

The JAX package ``v2e2v_tpu`` is the reference; this package mirrors its
module names and holds the same numerics. It imports ``torch`` and numpy,
never ``jax`` and nothing of ``v2e2v_tpu``. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; the TPU's Pallas kernels become
hand-written CUDA kernels for ``sm_90a`` (``csrc/``), each beside a plain
PyTorch version that CPU tensors take.

Ported so far: CISTA-LSTC and CISTA-TC stream serving (events -> voxel grid
-> StreamPool), CISTA-LSTC with the ISTA loop as CUDA kernel K1, or the whole
half-resolution core as CUDA kernel K2 (``CistaConfig.core_impl``); the V2E
event emulator and the V2E2V composite (HFR frames -> emulated voxel grids ->
reconstruction) with the emulator's iteration loop as CUDA kernel K3; the E2V
evaluation CLI
(``python -m v2e2v_tpu_torch.cli.test_e2v``) with its readers, host
voxeliser, native runtime, PNG codec, metrics and writers; the V2E2V CLI
(``python -m v2e2v_tpu_torch.cli.test``) through K3 and K1; raw-event mode and
the event generation tool (``python -m v2e2v_tpu_torch.cli.generate_events``);
training (``python -m v2e2v_tpu_torch.cli.train_e2v`` and ``cli.train``) with
its data path, losses and train steps, the core layer by layer with the
plain ISTA loop (K1 and K2 have no backward and refuse to run under
autograd), the V2E2V training forward's emulator through K3.
"""

from ._device import make_first_cpu_vml_call

make_first_cpu_vml_call()

from .models.cista import (  # noqa: E402, F401
    CistaConfig,
    CistaState,
    cista_lstc_step,
    cista_sequence,
    cista_tc_step,
    cista_zero_state,
    init_cista_lstc,
    init_cista_tc,
)
from .models.emulator import (  # noqa: E402, F401
    EmulatorConfig,
    EmulatorState,
    EmulatorStats,
    GeneratorNoise,
    emulate_pack,
    emulate_pack_raw,
    emulator_init,
    emulator_init_from_pack,
    validate_pack_times,
)
from .models.v2e2v import (  # noqa: E402, F401
    V2E2VConfig,
    V2E2VOutput,
    V2E2VState,
    v2e2v_forward,
    v2e2v_init_state,
    v2e2v_sequence,
)
from .serving import StreamPool  # noqa: E402, F401
