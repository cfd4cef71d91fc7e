"""PyTorch/CUDA port of the surrealdb_tpu device path.

`device/` holds the torch device runner: a server that speaks the
reference runner's frame protocol, keeps the vector and CSR stores in
GPU memory and answers their ops with hand-written CUDA kernels
(`csrc/`, built at first use). `ops/` holds the kernels' Python
wrappers beside their plain PyTorch versions.

Importing the package (or any module of it) loads no kernel and never
initialises CUDA; the entry points run on the card unless the caller
asks for the CPU.
"""
