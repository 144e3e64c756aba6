"""Kernel wrappers.  Each launches its CUDA kernel on a CUDA tensor (and
counts the launch in its ``launches`` attribute) and runs its plain PyTorch
version on a CPU tensor.  Kernels are built at first use (kernels/build.py);
importing this package needs no compiler and no card."""


def counted_wrappers():
    """Every kernel wrapper with a ``launches`` count, by name: the W4A8
    GEMMs, the KV writes and the attention kernels."""
    from qqq_tpu_torch.kernels import attention, kv_write, w4a8_gemm

    fns = (*w4a8_gemm.KERNEL_WRAPPERS.values(),
           kv_write.slot_decode_write_int8, kv_write.paged_decode_write_int8,
           kv_write.paged_chunk_write_int8, attention.decode_attention_int8,
           attention.flash_decode_attention_int8,
           attention.flash_attention_int8,
           attention.paged_flash_attention_int8,
           attention.paged_decode_attention_int8)
    return {f.__name__: f for f in fns}
