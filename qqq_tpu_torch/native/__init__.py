"""Host-side native helpers (the INT4 packer)."""

from qqq_tpu_torch.native.build import (
    load_native, pack_int4_host, unpack_int4_host,
)
