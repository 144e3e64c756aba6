"""The system under test, ``qqq_tpu_torch``: its params built from the seeded
draw, its ``Engine`` with the cell's settings, the cell's own warm-up, and
the spans the benchmark records around the engine's dispatches.

Only this module (and the metric readers through it) touches the program;
it imports it inside its functions.  The cell's file passes only what a
deployment must choose (``max_batch``, ``max_len``, ``paged``,
``block_size``); every other engine argument stays at its default.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch

from harness import weights as W
from harness.traffic import rng

#: the engine arguments a cell's file may set
ENGINE_KEYS = ("max_batch", "max_len", "paged", "block_size")


def build_params(cfg: Dict[str, Any], seed: int, device, dtype=torch.bfloat16
                 ) -> Dict[str, Any]:
    """The port's params: each layer's drawn codes through the port's INT4
    packer (``core/packing.py:pack_int4``), its scales as the port takes
    them (g128 ``s_group`` bf16, per channel ``s_channel`` f32)."""
    from qqq_tpu_torch.core.packing import pack_int4

    per_channel = cfg["quant"]["group_size"] == -1
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        raw = W.draw_layer(cfg, seed, i, device)
        lay: Dict[str, Any] = {
            "input_layernorm": raw["input_layernorm"].to(dtype).clone(),
            "post_attention_layernorm":
                raw["post_attention_layernorm"].to(dtype).clone(),
        }
        for name in W.LINEARS:
            r = raw[name]
            p: Dict[str, Any] = {"w_packed": pack_int4(r["codes"])}
            if per_channel:
                p["s_channel"] = r["scale"][0].to(torch.float32).clone()
            else:
                p["s_group"] = r["scale"].clone()
            if r["bias"] is not None:
                p["b"] = r["bias"].to(dtype).clone()
            lay[name] = p
        layers.append(lay)
        del raw
    tied = bool(cfg.get("tie_word_embeddings"))
    return {
        "embed": W.draw_embed(cfg, seed, device).to(dtype),
        "layers": layers,
        "norm": W.draw_final_norm(cfg, seed, device).to(dtype),
        "lm_head": None if tied else {"w": W.draw_head(cfg, seed, device).to(
            dtype)},
    }


def model_config(cfg: Dict[str, Any]):
    from qqq_tpu_torch.models.config import ModelConfig

    return ModelConfig.from_hf(cfg)


def make_engine(params, cfg: Dict[str, Any], settings: Dict[str, Any],
                device, dtype=torch.bfloat16):
    from qqq_tpu_torch.serve.engine import Engine

    kw = {k: settings["engine"][k] for k in ENGINE_KEYS
          if k in settings["engine"]}
    return Engine(params, model_config(cfg), device=device, dtype=dtype, **kw)


def request(prompt: List[int], max_new: int):
    from qqq_tpu_torch.serve.engine import Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    return Request(prompt_tokens=prompt,
                   sampling=SamplingParams(max_new_tokens=max_new))


def _pow2_upto(n: int) -> List[int]:
    out, p = [], 1
    while p < n:
        out.append(p)
        p *= 2
    return out + [n]


def warm_up(eng, mix: Dict[str, Any], seed: int, vocab: int) -> int:
    """Run the dispatch shapes this cell's traffic uses once, outside the
    window: whole-prompt prefills of 1, 2, 4 .. ``prefill_batch`` rows in
    every bucket the mix's prompt lengths reach (slot mode), or chunk
    dispatches of 1, 2, 4 .. ``prefill_batch`` rows (chunked prefill), and
    the decode tick, whose graph the first tick captures.  Returns the
    dispatches run."""
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    g = rng(seed, "warm-up")
    n0 = eng.stats["prefill_dispatches"]

    def burst(n: int, length: int) -> None:
        eng.run([request(g.integers(0, vocab, length).tolist(), 2)
                 for _ in range(n)])

    if eng.prefill_chunk:
        for n in _pow2_upto(min(eng.prefill_batch, eng.max_batch)):
            burst(n, min(eng.prefill_chunk, hi))
    else:
        prev = 0
        for b in eng.prefill_buckets:
            if b >= lo and prev < hi:
                for n in _pow2_upto(min(eng.prefill_batch, eng.max_batch)):
                    burst(n, min(b, hi))
            prev = b
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng.stats["prefill_dispatches"] - n0


class Spans:
    """Host spans around the engine's three dispatch methods, each with
    the dispatch's shape as :mod:`harness.counts` describes it, read from
    the engine's state just before the call (a prefill's also with the
    token positions it computes, padding included: ``padded``);
    ``before`` / ``after`` run at each dispatch boundary (the profiler
    starts and stops there).  Each span is also a ``record_function``
    range, so a trace names the dispatch."""

    def __init__(self, eng, before: Callable[[float], None],
                 after: Callable[[float], None]):
        self.eng = eng
        self.records: List[Dict[str, Any]] = []
        self._before, self._after = before, after
        self.profiling = False
        self._wrap("_admit_batch", "prefill", self._whole)
        self._wrap("_prefill_chunk", "prefill", self._chunk)
        self._wrap("_decode_tick", "decode", self._tick)

    def _wrap(self, method: str, kind: str,
              describe: Callable[..., Dict[str, Any]]) -> None:
        orig = getattr(self.eng, method)

        def wrapped(*args, **kwargs):
            desc = describe(*args, **kwargs)
            self._before(time.monotonic())
            t0 = time.monotonic()
            with torch.profiler.record_function(f"h100_bench.{kind}"):
                out = orig(*args, **kwargs)
            t1 = time.monotonic()
            self.records.append({"t0": t0, "t1": t1, "desc": desc,
                                 "profiled": self.profiling})
            self._after(t1)
            return out

        setattr(self.eng, method, wrapped)

    @staticmethod
    def _whole(reqs, slots, bucket) -> Dict[str, Any]:
        return {"kind": "prefill", "heads": len(reqs),
                "rows": [(0, len(r.prompt_tokens)) for r in reqs],
                "padded": len(reqs) * bucket}

    def _chunk(self, rows) -> Dict[str, Any]:
        eng, C = self.eng, self.eng.prefill_chunk
        out, heads = [], 0
        for slot in rows:
            if slot is None:
                continue
            rest = len(eng.slot_prefill[slot])
            out.append((int(eng.slot_len[slot]), min(C, rest)))
            heads += rest <= C
        return {"kind": "prefill", "rows": out, "heads": heads,
                "padded": len(rows) * C}

    def _tick(self, active, n: int = 1) -> Dict[str, Any]:
        lens = self.eng.slot_len
        return {"kind": "decode", "steps": int(n),
                "rows": [int(lens[i]) for i in range(len(active))
                         if active[i]]}


def stats_snapshot(eng) -> Dict[str, Any]:
    return {k: (len(v) if isinstance(v, list) else v)
            for k, v in eng.stats.items()}


def release(eng) -> None:
    """Drop the engine's hold on the card's memory."""
    eng.on_token = None
    eng.params = eng.caches = None
    eng._graphs.clear()
