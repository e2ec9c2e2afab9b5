"""PyTorch/CUDA port of the clustered-sampling FL system (``repro``).

The package mirrors ``repro``'s module paths. Its hot kernels are
hand-written CUDA C++ for ``sm_90a`` under ``repro_torch/csrc`` and are
built at first use (``repro_torch.kernels._build``). Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``; the CPU path
runs every kernel's plain PyTorch version. The package imports neither
JAX nor ``repro``.
"""
