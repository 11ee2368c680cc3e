"""SonicScribe in PyTorch and CUDA: the port of the JAX package
``sonicscribe_tpu`` to an NVIDIA H100.

It mirrors that package's layout (audio/, models/, ops/, engine/, vad/,
serve/) and imports neither JAX nor anything of it. The kernels on the main
path are written by hand in CUDA C++ for Hopper (csrc/), built with nvcc at
first use (ops/_build.py); each has a plain PyTorch version beside it, which
runs for tensors on the CPU.
"""
