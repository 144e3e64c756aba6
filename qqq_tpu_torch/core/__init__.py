from qqq_tpu_torch.core.packing import PACK_BLOCK, pack_int4, unpack_int4
from qqq_tpu_torch.core.quant import (
    QuantSpec,
    find_params_weight,
    quantize_activations_per_token,
    quantize_weight_int,
    requant_scales,
    requantize_group_weights_int8,
    s_extra_from_group_scales,
    w4a8_matmul_reference,
)
