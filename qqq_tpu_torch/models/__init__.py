from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.models.convert import params_from_numpy
from qqq_tpu_torch.models.llama import (
    decode_step,
    forward,
    fuse_inference_params,
    init_params,
    linear_apply,
)
from qqq_tpu_torch.models.quantize import quantize_params_rtn
from qqq_tpu_torch.models.loader import (
    load_hf_model, load_quantized, save_quantized,
)
