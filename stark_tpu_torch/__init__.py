"""PyTorch/CUDA port of the `stark_tpu` R1CS STARK prover and verifier.

The package mirrors `stark_tpu`'s module names. It imports `torch` and never
`jax`; the jax-free host modules of `stark_tpu` (field specs, R1CS readers
and arithmetizer, transcript, params, host polynomials, the native C++ host
library) are shared by import. The hand-written CUDA kernels live in
`csrc/` and are built with `nvcc` at first use (`ops/build.py`).
"""
