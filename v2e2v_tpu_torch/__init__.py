"""v2e2v_tpu_torch — the PyTorch/CUDA port of ``v2e2v_tpu`` for an NVIDIA H100.

The JAX package ``v2e2v_tpu`` is the reference; this package mirrors its
module names and holds the same numerics. It imports ``torch`` and numpy,
never ``jax`` and nothing of ``v2e2v_tpu``. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; the TPU's Pallas kernels become
hand-written CUDA kernels for ``sm_90a`` (``csrc/``), each beside a plain
PyTorch version that CPU tensors take.

Ported so far: CISTA-LSTC stream serving (events -> voxel grid -> StreamPool)
with the ISTA loop as CUDA kernel K1.
"""

from .models.cista import (  # noqa: F401
    CistaConfig,
    CistaState,
    cista_lstc_step,
    cista_sequence,
    cista_zero_state,
    init_cista_lstc,
)
from .serving import StreamPool  # noqa: F401
