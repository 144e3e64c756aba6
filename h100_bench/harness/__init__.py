"""The H100 serving benchmark of ``qqq_tpu_torch``: the yardstick.

Everything that belongs to one configuration, traffic mix, cell, metric or
kernel name lives in a file of its own beside this package (``configs/``,
``traffic/``, ``workloads/``, ``metrics/``, ``kernels/``), found by the
name ``BENCHMARK.json`` gives it.  This package holds what they share: the
traffic generator, the seeded weights, the window loops, the operation and
byte counts, the trace reader and the comparison that decides ``correct``.
"""
