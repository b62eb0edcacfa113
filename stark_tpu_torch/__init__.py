"""PyTorch/CUDA port of the `stark_tpu` R1CS STARK prover and verifier.

The package mirrors `stark_tpu`'s module names. It imports `torch` and never
`jax`, and nothing of `stark_tpu`: the host modules it needs (field specs,
R1CS readers, arithmetizer and generators, transcript, params, host
polynomials, the bindings of the native C++ host library) are its own copies
under the same names. The hand-written CUDA kernels live in `csrc/` and are
built with `nvcc` at first use (`ops/build.py`).
"""
