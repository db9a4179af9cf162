"""CUDA kernels of the port, their builds, wrappers and plain versions."""
