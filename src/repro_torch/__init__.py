"""PyTorch/CUDA port of the constraint-checking pattern matcher.

The single-device main path of the paper's Alg. 1 -- `Graph` -> constraint
generation -> `init_state` -> LCC fixpoint -> NLCC cycle/path waves -> TDS ->
`prune()` -> match enumeration -- on PyTorch tensors, with the two bitset
aggregation kernels written by hand in CUDA C++ for Hopper (`kernels/`).

Module layout mirrors the JAX package `repro` file for file. Entry points run
on `cuda` unless the caller passes `device="cpu"`; on the CPU every kernel
wrapper runs its plain PyTorch version instead.
"""
