"""The control: the reference put in the program's place one precision step
below the configuration's (activations INT4 for the stated INT8) must come
out as not correct against the cell's limits, on several seeds, while the
program comes out correct; at a toy size here, on the card at the cells'
own size (PERF.md, which gives the readings the cells' limits were set
from)."""

import torch

import run
from toy import toy_bench, toy_cell

#: the toy's limits, set between its readings on the CPU: the program's
#: widest gap read at most 0.00035 nats and its mean 4.1e-6, the control's
#: at least 0.121 and 0.0057 (seeds 2**31 + 1 .. 3)
MAX_GAP, MEAN_GAP = 0.01, 0.0005


def test_control_is_not_correct_where_the_program_is():
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = run.run_cell(toy_cell("closed", limit=MAX_GAP,
                                    mean_limit=MEAN_GAP), toy_bench(), seed,
                           1.5, False, torch.device("cpu"), torch.float32,
                           control_bits=4)
        assert out["correct"], out["checks"]
        assert out["control_correct"] is False, (
            out["control_max_gap_nats"], out["control_mean_gap_nats"])
