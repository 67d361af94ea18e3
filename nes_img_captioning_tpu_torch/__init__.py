"""PyTorch + CUDA port of ``nes_img_captioning_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here mirrors
the JAX module of the same path and is tested against it on the same inputs
(``tests/test_torch_*.py``). This package imports ``torch`` and never
``jax`` or ``nes_img_captioning_tpu``.

The greedy decode kernels (``ops/decode_cuda.py``, sources in ``csrc/``) are
CUDA C++ for ``sm_90a``, built with ``nvcc`` on first use. Entry points run
on the card unless the caller passes ``device="cpu"``; on CPU tensors the
kernel wrappers run their plain PyTorch twins.
"""

__version__ = "0.1.0"
