"""Kernel wrappers.  Each launches its CUDA kernel on a CUDA tensor (and
counts the launch in its ``launches`` attribute) and runs its plain PyTorch
version on a CPU tensor.  Kernels are built at first use (kernels/build.py);
importing this package needs no compiler and no card."""
