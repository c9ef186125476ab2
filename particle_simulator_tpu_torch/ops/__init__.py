"""Ops: the CUDA kernels' build and wrappers, and the dense-pack readback."""
