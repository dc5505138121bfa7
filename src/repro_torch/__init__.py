"""PyTorch + CUDA port of the ``repro`` serving system for NVIDIA Hopper.

Mirrors the JAX package's module layout (``repro_torch.models.attention``
is the counterpart of ``repro.models.attention``, and so on) but imports
nothing from it: the JAX-free modules the port needs (metering core,
model config, request types) are kept here as copies. Plain tensor code is
PyTorch; the attention kernels the JAX package wrote in Pallas for the TPU
are hand-written CUDA C++ for ``sm_90a`` under ``kernels/csrc``.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and
raises when no card is present; tests pass ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
