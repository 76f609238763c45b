"""PyTorch/CUDA port of the ``repro`` package (JAX on TPU) for NVIDIA Hopper.

Module names mirror ``repro`` so each counterpart is easy to find. The port
imports torch and numpy only, never jax or ``repro``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``
(``repro_torch.kernels.backend.resolve_device``).
"""
