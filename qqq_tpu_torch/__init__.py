"""PyTorch/CUDA port of qqq_tpu: W4A8 (INT4 weights, INT8 activations)
Llama serving over an INT8 KV cache, with hand-written CUDA kernels for
Hopper (sm_90a).

The package mirrors ``qqq_tpu``'s layout and keeps its parameter layout at
the public surface, so that both packages compute from identical bits.  It
imports ``torch`` and never ``jax``.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; on the CPU every kernel wrapper
runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
