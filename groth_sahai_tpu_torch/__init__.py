"""groth_sahai_tpu_torch: the PyTorch/CUDA port of groth_sahai_tpu.

Same `ops/ models/ parallel/ utils/` layout and names as the JAX package,
written as plain functions on PyTorch tensors, with the JAX package's
Pallas kernels rewritten by hand as CUDA C++ for Hopper (sm_90a) in
`csrc/`. Imports neither `jax` nor `groth_sahai_tpu`.
"""
