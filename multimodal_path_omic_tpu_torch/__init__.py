"""PyTorch/CUDA port of ``multimodal_path_omic_tpu`` for NVIDIA Hopper (H100).

The layout mirrors the JAX package (``ops/``, ``models/``, ``data/``,
``serve.py``) so each module has an obvious counterpart there. The port
imports ``torch`` and numpy only: nothing of JAX, flax or the JAX package.
Every TPU (Pallas) kernel on a ported path has a hand-written CUDA kernel in
``csrc/``, built with ``nvcc`` at first use (``ops/kernels.py``), with a plain
PyTorch version of the same function beside its wrapper.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit ``"cpu"`` they raise (``device.py``).
"""

__all__ = ["device", "serve"]
