"""Utilities of the port: data loaders, devices, evaluation, the device
timer and profiling."""

from qqq_tpu_torch.utils.benchmark import measure_op
from qqq_tpu_torch.utils.profiling import StageTimer, device_trace
