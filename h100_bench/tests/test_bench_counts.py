"""Operation and byte counts of one Qwen2.5-7B layer and its lm_head,
against numbers worked out by hand from the configuration's sizes."""

import copy
import math

from harness import counts, spec

PEAKS = spec.peaks("NVIDIA H100 80GB HBM3")
CFG7 = spec._load_json(spec.BENCH_DIR / "configs" / "qwen2.5-7b-g128.json")


def one_layer(cfg):
    c = copy.deepcopy(cfg)
    c["num_hidden_layers"] = 1
    return c


def test_one_decode_row_of_one_7b_layer_and_the_head():
    """One decode step of one row over 99 cached keys, H 3584, I 18944,
    28 heads, 4 kv heads, hd 128, g128 scales bf16, q/k/v biases bf16."""
    w = counts.dispatch(one_layer(CFG7),
                        {"kind": "decode", "rows": [99], "steps": 1}, PEAKS)
    # GEMM units (K, N): qkv (3584, 3584 + 2·512), o (3584, 3584), gate/up
    # (3584, 2·18944), down (18944, 3584); 2·M·K·N at M = 1
    assert w["gemm_ops"] == 2 * (3584 * 4608 + 3584 * 3584 + 3584 * 37888
                                 + 18944 * 3584) == 466_092_032
    # weights K·N/2 + (K/128)·N·2 scales (+ 2·N bias for qkv):
    # 8_257_536 + 258_048 + 9_216 | 6_422_528 + 200_704 |
    # 67_895_296 + 2_121_728 | 33_947_648 + 1_060_864
    weights = 8_524_800 + 6_623_232 + 70_017_024 + 35_008_512
    assert weights == 120_173_568
    # activations M·K int8 + M·4 scale in, M·N_out·2 out:
    # qkv 3584+4+9216, o 3584+4+7168, gate/up 3584+4+37888, down 18944+4+7168
    acts = 12_804 + 10_756 + 41_476 + 26_116
    assert w["gemm_bytes"] == weights + acts == 120_264_720
    # attention: 100 (query, key) pairs · 4 · nh 28 · hd 128
    assert w["attn_ops"] == 1_433_600
    # 99 cached + 1 new token · 4 kv heads · (K, V) · (128 codes + 4 scale)
    # + the new K/V in bf16 (2048) + q and output bf16 (2 · 28 · 128 · 2)
    assert w["attn_bytes"] == 99 * 1056 + 1056 + 2048 + 14_336 == 121_984
    # head: 2 · H · V, its bf16 weight, the row's input and bf16 logits
    assert w["head_ops"] == 2 * 3584 * 152064 == 1_089_994_752
    assert w["head_bytes"] == 1_089_994_752 + 7_168 + 304_128
    total_bytes = 120_264_720 + 121_984 + 1_090_306_048 + (7168 + 14336 + 7168)
    compute = 466_092_032 / 1.979e15 + (1_433_600 + 1_089_994_752) / 9.89e14
    assert math.isclose(w["least"], max(compute, total_bytes / 3.35e12))
    assert math.isclose(w["least"], 1_210_721_424 / 3.35e12)
    assert math.isclose(w["gemm_least"], (
        max(2 * 3584 * 4608 / 1.979e15, (8_524_800 + 12_804) / 3.35e12)
        + max(2 * 3584 * 3584 / 1.979e15, (6_623_232 + 10_756) / 3.35e12)
        + max(2 * 3584 * 37888 / 1.979e15, (70_017_024 + 41_476) / 3.35e12)
        + max(2 * 18944 * 3584 / 1.979e15, (35_008_512 + 26_116) / 3.35e12)))


def test_a_prefill_chunk_counts_its_causal_pairs_and_cached_keys():
    cfg = one_layer(CFG7)
    w = counts.dispatch(cfg, {"kind": "prefill", "rows": [(512, 512)],
                              "heads": 1}, PEAKS)
    pairs = 512 * 512 + 512 * 513 // 2
    assert w["attn_ops"] == 4 * 28 * 128 * pairs
    assert w["tokens"] == 512
    # at M = 512 the GEMMs are bound by operations: 2·M·K·N at 1979 TOP/s
    ops = 2 * 512 * 233_046_016
    assert w["gemm_ops"] == ops
    assert math.isclose(w["gemm_least"], ops / 1.979e15, rel_tol=0.05)


def test_a_decode_tick_of_two_steps_is_two_steps():
    cfg = one_layer(CFG7)
    two = counts.dispatch(cfg, {"kind": "decode", "rows": [10, 20],
                                "steps": 2}, PEAKS)
    a = counts.dispatch(cfg, {"kind": "decode", "rows": [10, 20],
                              "steps": 1}, PEAKS)
    b = counts.dispatch(cfg, {"kind": "decode", "rows": [11, 21],
                              "steps": 1}, PEAKS)
    for k in two:
        assert math.isclose(two[k], a[k] + b[k])


def test_per_channel_scales_are_f32_per_column():
    cfg = one_layer(spec._load_json(spec.BENCH_DIR / "configs"
                                    / "qwen2.5-14b-ch.json"))
    w = counts.dispatch(cfg, {"kind": "decode", "rows": [0], "steps": 1},
                        PEAKS)
    H, I, kvd = 5120, 13824, 8 * 128
    weights = (H * (H + 2 * kvd) // 2 + (H + 2 * kvd) * 4 + (H + 2 * kvd) * 2
               + H * H // 2 + H * 4 + H * 2 * I // 2 + 2 * I * 4
               + I * H // 2 + H * 4)
    acts = (H + 4 + (H + 2 * kvd) * 2) + (H + 4 + H * 2) + (H + 4 + I * 2) \
        + (I + 4 + H * 2)
    assert w["gemm_bytes"] == weights + acts
