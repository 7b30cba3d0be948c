"""PyTorch/CUDA port of morphganformer_tpu for one NVIDIA H100.

Imports torch, numpy and scipy only: never jax, flax or the JAX package.
Activations are NHWC and weights keep the JAX layouts. The fused
high-resolution convolutions run as hand-written CUDA kernels
(csrc/fused_conv.cu), built at first use by ops/_build.py.
"""
