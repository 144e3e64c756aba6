"""A toy Qwen2 cell for the CPU tests: the cells' code paths at a size the
CPU runs in seconds (the port's plain versions stand in for its kernels)."""

from __future__ import annotations

import copy
import json

from harness import spec

TOY_CONFIG = {
    "model_type": "qwen2", "vocab_size": 512, "hidden_size": 256,
    "intermediate_size": 512, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
    "max_position_embeddings": 4096, "tie_word_embeddings": False,
    "quant": {"w_bits": 4, "group_size": 128, "a_bits": 8, "kv_bits": 8},
    "reference": "qwen2_w4a8",
    "assumed": {"code_std": 2.0, "weight_std": 0.02, "scale_jitter": 0.1,
                "bias_std": 0.3, "norm_jitter": 0.1, "embed_std": 0.02,
                "head_std": 0.02},
}

CLOSED = {"loop": "closed", "clients": 4, "block": 8,
          "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.8,
                     "min": 8, "max": 120},
          "output": {"dist": "uniform", "min": 6, "max": 20}}
OPEN = {"loop": "open", "arrivals": "poisson", "block": 8,
        "prompt": {"dist": "lognormal", "median": 200, "sigma": 0.6,
                   "min": 64, "max": 700},
        "output": {"dist": "uniform", "min": 4, "max": 10}}


#: the toy open cell's name; BENCHMARK.json has no open cell, so the toy
#: benchmark (``toy_bench``) adds it with an open cell's metrics
OPEN_CELL = "toy.docqa-open"


def toy_bench() -> dict:
    """BENCHMARK.json with the toy open cell and the time to first token,
    which an open cell reports, added."""
    bench = copy.deepcopy(spec.benchmark())
    bench["workloads"].append({
        "name": OPEN_CELL, "config": "toy", "traffic": "toy-open",
        "chips": 1, "why": "the open loop's code path at a toy size"})
    bench["end_to_end"].append({
        "name": "ttft_p90_s", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock", "workloads": [OPEN_CELL]})
    return bench


def toy_cell(loop: str = "closed", group_size: int = 128,
             limit: float = 1.0, mean_limit: float = None) -> dict:
    """A cell dict as ``harness.spec.cell`` returns it: the closed loop
    named after the real closed cell, so that BENCHMARK.json lists its
    metrics, the open one after ``OPEN_CELL`` (run it with
    ``toy_bench()``); ``limit`` holds the widest gap, ``mean_limit`` (by
    default ``limit``) the mean gap."""
    cfg = copy.deepcopy(TOY_CONFIG)
    cfg["quant"]["group_size"] = group_size
    if loop == "closed":
        name, mix = "q7g.chat-closed64", CLOSED
        settings = {"engine": {"max_batch": 4, "max_len": 256,
                               "paged": False}, "profile_s": 0.5}
    else:
        name, mix = OPEN_CELL, OPEN
        settings = {"engine": {"max_batch": 4, "max_len": 1024,
                               "paged": True, "block_size": 64},
                    "rate_rps": 8.0, "profile_s": 0.5}
    settings["check"] = {"requests": 8, "min_tokens": 10}
    settings["limits"] = {"max_gap_nats": limit,
                          "mean_gap_nats": limit if mean_limit is None
                          else mean_limit}
    return {"name": name, "entry": spec.entry(toy_bench()["workloads"], name,
                                              "workload"),
            "settings": settings, "config": cfg,
            "traffic": copy.deepcopy(mix)}


def dumps(x) -> str:
    return json.dumps(x, allow_nan=False)
