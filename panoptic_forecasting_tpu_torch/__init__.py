"""PyTorch + CUDA port of panoptic_forecasting_tpu for NVIDIA Hopper.

The package mirrors the JAX package's module layout so each module's
counterpart is easy to find (``kernels/zbuffer.py`` here ports
``panoptic_forecasting_tpu/kernels/zbuffer.py``). It imports torch and
numpy only. Models are ``nn.Module``s, laid out NCHW inside; the public
functions keep the JAX package's layouts (seg/depth ``(B, T, H, W)``,
stem output ``(B, H/2, W/2, 16)``, panoptic ``(B, H, W)``).

Entry points run on the GPU unless the caller passes ``device="cpu"``
(see ``device.py``). The hand-written CUDA kernels under ``csrc/`` are
compiled with ``nvcc`` at first use (``kernels/build.py``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
