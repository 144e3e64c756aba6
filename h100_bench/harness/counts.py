"""Operations and bytes of the served model's work, from its shapes and the
dispatch shapes alone: never from which kernel ran, so a change that fuses
or reroutes kernels keeps the same yardstick.

A dispatch is described by the harness (``harness/program.py``) as it is
made:

* ``{"kind": "decode", "rows": [cache length of each active row], "steps":
  n}``: n decode steps of the active rows (each step one token a row, over
  its cached keys and itself);
* ``{"kind": "prefill", "rows": [(cached tokens k, new tokens t), ...],
  "heads": h}``: the new tokens of each row through every layer, attending
  causally to the row's k cached tokens and to themselves, and the head
  over the h rows whose prompt the dispatch completes.

Useful work only: padding rows, padded positions and masked slots count
nothing.  Counting rules, per layer unless said otherwise:

* a W4A8 GEMM of M token rows, K inputs and N weight columns does 2·M·K·N
  int8 operations and moves its INT4 weights, their scales and biases once,
  its M·K int8 activations and M token scales in and its output (bf16) out;
  q/k/v are one unit (their input is read once), gate/up one unit writing
  silu(gate)·up (M·I);
* attention does 4·nh·hd operations per (query, key) pair (QKᵀ and PV) in
  bf16; it reads each cached key and value once (INT8 codes and one f32
  scale per token and kv head), writes each new token's once, and reads q
  and writes its output once (bf16);
* the head does 2·H·V bf16 operations a row, reads its bf16 weight once
  and writes bf16 logits; the embedding rows read are counted with the
  norms' weights.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

from harness import weights as W


def _units(cfg: Dict[str, Any]) -> List[Tuple[str, int, int, int, int]]:
    """(name, K, weight columns N, output columns, weight bytes) of the four
    GEMM units of a layer."""
    shp = W.shapes(cfg)
    per_channel = cfg["quant"]["group_size"] == -1

    def wbytes(names: Iterable[str]) -> int:
        b = 0
        for n in names:
            K, N = shp[n]
            b += K * N // 2 + (K // W.group_size(cfg, K)) * N * (
                4 if per_channel else 2)
            if n in W.BIASED:
                b += N * 2
        return b

    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    qkv = shp["q_proj"][1] + 2 * shp["k_proj"][1]
    qd = shp["o_proj"][0]
    return [
        ("qkv", H, qkv, qkv, wbytes(("q_proj", "k_proj", "v_proj"))),
        ("o", qd, H, H, wbytes(("o_proj",))),
        ("gate_up", H, 2 * I, I, wbytes(("gate_proj", "up_proj"))),
        ("down", I, H, H, wbytes(("down_proj",))),
    ]


def _least(ops: float, peak_ops: float, nbytes: float, bw: float) -> float:
    return max(ops / peak_ops, nbytes / bw)


def _pass(cfg: Dict[str, Any], rows: List[Tuple[int, int]], heads: int,
          pk: Dict[str, float]) -> Dict[str, float]:
    """One forward over ``rows`` [(k, t)] with the head over ``heads``
    rows: operations, bytes and least seconds by part."""
    L, H, V = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["vocab_size"])
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = W.head_dim(cfg)
    i8, bf, bw = pk["int8_ops"], pk["bf16_flops"], pk["hbm_bytes_s"]
    M = sum(t for _, t in rows)
    g_ops = g_bytes = g_least = 0.0
    for _, K, N, Nout, wb in _units(cfg):
        ops = 2.0 * M * K * N
        nb = wb + M * K + M * 4 + M * Nout * 2
        g_ops += ops
        g_bytes += nb
        g_least += _least(ops, i8, nb, bw)
    pairs = sum(t * k + t * (t + 1) / 2 for k, t in rows)
    kvb = nkv * 2 * (hd + 4)
    a_ops = 4.0 * nh * hd * pairs
    a_bytes = sum(k * kvb + t * kvb + t * nkv * 2 * hd * 2
                  + 2 * t * nh * hd * 2 for k, t in rows)
    h_ops = 2.0 * heads * H * V
    h_bytes = H * V * 2 + heads * H * 2 + heads * V * 2
    other = M * H * 2 + L * 2 * H * 2 + H * 2
    out = {
        "gemm_ops": L * g_ops, "gemm_bytes": L * g_bytes,
        "gemm_least": L * g_least,
        "attn_ops": L * a_ops, "attn_bytes": L * a_bytes,
        "attn_least": L * _least(a_ops, bf, a_bytes, bw),
        "head_ops": h_ops, "head_bytes": h_bytes,
        "head_least": _least(h_ops, bf, h_bytes, bw),
    }
    compute = out["gemm_ops"] / i8 + (out["attn_ops"] + h_ops) / bf
    nbytes = out["gemm_bytes"] + out["attn_bytes"] + h_bytes + other
    out["least"] = max(compute, nbytes / bw)
    out["tokens"] = M
    return out


def dispatch(cfg: Dict[str, Any], desc: Dict[str, Any],
             pk: Dict[str, float]) -> Dict[str, float]:
    """Operations, bytes and least seconds of one dispatch (see the module
    docstring), summed over a decode tick's steps."""
    if desc["kind"] == "prefill":
        return _pass(cfg, [tuple(r) for r in desc["rows"]], desc["heads"], pk)
    tot: Dict[str, float] = {}
    for s in range(desc["steps"]):
        rows = [(k + s, 1) for k in desc["rows"]]
        for key, v in _pass(cfg, rows, len(rows), pk).items():
            tot[key] = tot.get(key, 0.0) + v
    return tot


def total(cfg: Dict[str, Any], descs: Iterable[Dict[str, Any]],
          pk: Dict[str, float]) -> Dict[str, float]:
    tot: Dict[str, float] = {}
    for d in descs:
        for key, v in dispatch(cfg, d, pk).items():
            tot[key] = tot.get(key, 0.0) + v
    return tot
