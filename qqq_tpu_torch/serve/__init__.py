from qqq_tpu_torch.serve import kv_cache
