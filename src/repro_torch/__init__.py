"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Module names mirror ``repro`` so each counterpart is easy to find. Inside,
plain functions on tensors with NamedTuple states; every entry point takes
``device`` (default ``"cuda"``) and stochastic functions take an explicit
``torch.Generator``. The Pallas kernels of ``repro.kernels`` become CUDA C++
kernels for sm_90a under ``csrc/``, built on first use and bound with ctypes.
The package imports neither ``jax`` nor anything of ``repro``.
"""
__version__ = "0.1.0"
