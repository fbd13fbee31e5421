"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version. Sources are in ``v2e2v_tpu_torch/csrc/``."""
