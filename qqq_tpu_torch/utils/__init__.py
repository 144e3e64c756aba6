"""Utilities of the port: data loaders, devices, evaluation and
profiling."""

from qqq_tpu_torch.utils.profiling import StageTimer, device_trace
