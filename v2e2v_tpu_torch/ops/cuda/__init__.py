"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version. Sources are in ``v2e2v_tpu_torch/csrc/``."""

from __future__ import annotations

import torch

TRAINING_CONFIG = 'CistaConfig(ista_impl="plain", core_impl="layers")'
# the keys of K1's and K2's ``launches_by_dtype``
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def refuse_grad(what: str, tensors) -> None:
    """Raise when autograd would record ``what``: grad is enabled and one of
    ``tensors`` requires grad. The kernels write into fresh buffers through
    raw pointers, so their results carry no ``grad_fn``; the JAX package has
    no backward for its Pallas kernels either, and its trainers run the XLA
    paths. Checked on every device, before the CPU takes the plain version,
    so the CPU refuses what the card would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is a CUDA kernel without a backward, and an argument requires grad: "
            f"train with {TRAINING_CONFIG}, or run under torch.no_grad()"
        )


def refuse_shard(what: str, shard) -> None:
    """Raise on a call that holds one rank's block of columns (``shard`` not
    None): the kernels read the true image border and no halo, and they only
    run where the spatial axis does not, in inference."""
    if shard is not None:
        raise ValueError(
            f"{what} is a CUDA kernel over whole images, and this call is one rank's block of "
            f"columns: the spatial axis trains with {TRAINING_CONFIG}"
        )
