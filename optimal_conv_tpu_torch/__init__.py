"""optimal_conv_tpu_torch: the CKKS encrypted-convolution stack in PyTorch.

A port of ``optimal_conv_tpu`` (JAX on a TPU) to PyTorch and CUDA on an
NVIDIA H100.  It follows the JAX package's layout and names:

  core/    RNS ring arithmetic on int64 tensors: Montgomery products,
           negacyclic NTT/iNTT, Galois permutations, basis extension.
           The hot kernels are hand-written CUDA (``csrc/``), each with
           a plain PyTorch version that the CPU runs.
  ckks/    Parameters, encoder, keys, encryption and the evaluator ops
           the coefficient-packed convolution needs.
  ops/     The packed convolution + BN layer, the fused conv → bootstrap
           → ReLU → repack layer and its per-stage decrypt oracles.
  models/  The encrypted ResNet runner and its plaintext (numpy) model.

It imports neither ``jax`` nor ``optimal_conv_tpu``.
"""

__version__ = "0.1.0"
