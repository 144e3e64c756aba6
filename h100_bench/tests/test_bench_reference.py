"""The plain reference against the port at a toy Qwen2 size on the CPU:
the port's prefill through its INT8 slot cache and its decode steps, on the
benchmark's seeded weights, give the reference's logits."""

import pytest
import torch

from harness import program
from reference import qwen2_w4a8 as ref
from toy import TOY_CONFIG

SEED = 2**31 + 2024


def _port_logits(cfg, prompt, steps):
    """Prefill ``prompt`` into a slot cache, then ``steps`` greedy decode
    steps: (all positions' logits, the tokens decoded)."""
    from qqq_tpu_torch.models import llama as M
    from qqq_tpu_torch.serve import kv_cache

    dev = torch.device("cpu")
    params = program.build_params(cfg, SEED, dev, torch.float32)
    mcfg = program.model_config(cfg)
    caches = kv_cache.init(mcfg, 1, 128, dtype=torch.float32, device=dev)
    toks = torch.tensor([prompt])
    logits, _ = M.forward(params, mcfg, toks, caches=caches,
                          cache_len=torch.zeros(1, dtype=torch.int32))
    rows, out = [logits[0]], []
    n = len(prompt)
    for _ in range(steps):
        nxt = int(rows[-1][-1].argmax())
        out.append(nxt)
        lg, _ = M.forward(params, mcfg, torch.tensor([[nxt]]), caches=caches,
                          cache_len=torch.tensor([n], dtype=torch.int32))
        rows.append(lg[0])
        n += 1
    return torch.cat(rows), out


@pytest.mark.parametrize("group_size", [128, -1])
def test_reference_matches_the_port_prefill_and_decode(group_size):
    cfg = dict(TOY_CONFIG, quant=dict(TOY_CONFIG["quant"],
                                      group_size=group_size))
    prompt = torch.randint(0, cfg["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(3)).tolist()
    port, out = _port_logits(cfg, prompt, 6)
    want = ref.logits_at(cfg, SEED, [prompt + out], [0],
                         torch.device("cpu"))[0]
    assert want.shape == port.shape
    # both float32 with the same quantization points; an INT8 code that
    # rounds the other way in one quantizer moves logits by a few hundredths
    # of their spread (the largest: 4 % here), most by a few thousandths
    spread = want.std()
    assert (port - want).abs().max() < 0.06 * spread
    assert (port - want).abs().mean() < 0.01 * spread
    assert (port.argmax(-1) == want.argmax(-1)).float().mean() >= 0.95


def test_the_reference_sees_a_wrong_layer():
    """A sanity check of the comparison's power: the reference with one
    less layer disagrees with itself far beyond that tolerance."""
    cfg = dict(TOY_CONFIG)
    prompt = list(range(1, 30))
    a = ref.logits_at(cfg, SEED, [prompt], [0], torch.device("cpu"))[0]
    b = ref.logits_at(dict(cfg, num_hidden_layers=1), SEED, [prompt], [0],
                      torch.device("cpu"))[0]
    assert (a - b).abs().max() > 0.1 * a.std()
