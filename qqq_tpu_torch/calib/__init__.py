from qqq_tpu_torch.calib.gptq import (
    GPTQResult,
    gptq_quantize_matrix,
    hessian_init,
    hessian_update,
)
