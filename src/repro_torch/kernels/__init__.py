"""Hand-written CUDA kernels of the port and their plain torch versions.

Importing this package builds nothing: a kernel is compiled with nvcc
the first time a wrapper is called on a CUDA tensor (`_build`).
"""
