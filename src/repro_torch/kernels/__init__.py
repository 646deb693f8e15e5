"""The port's hand-written CUDA kernels, their plain PyTorch versions and
the routing between them (``ops``). Importing the package registers B1 and
B2 as ``torch.library`` custom ops (``library``)."""
from repro_torch.kernels import library  # noqa: F401
