"""PyTorch + CUDA port of the video_style_transfer_tpu serving path.

The JAX package beside this one is the reference; this package keeps its
subpackage and function names so each counterpart is easy to find, and
its public functions keep the JAX layouts (NHWC activations, (B, S, H*D)
attention tokens). The three Pallas kernels of the serving path are
hand-written CUDA kernels for Hopper under ``csrc/``, built at first use
into ``_build/`` (ops/cuda_build.py). Every kernel wrapper takes its plain
PyTorch version for CPU tensors and launches the kernel (or raises) for
CUDA tensors.
"""
