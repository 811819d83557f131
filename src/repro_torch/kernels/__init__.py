"""CUDA kernels for the coupled-STO RK4 step and for flash attention, their
wrappers and plain PyTorch versions. Importing this package builds nothing:
the kernels build at their first launch (kernels/_build.py)."""
