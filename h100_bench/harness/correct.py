"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the program served,
drawn from the seed and always holding the one with the most served tokens,
is scored by the plain reference (the configuration's ``reference`` module
under ``reference/``): one forward over each prompt with its served tokens.
For every served token the number compared is the gap by which the
reference's logit of that token lies below the reference's best logit at
that position; the widest gap over the sample is held to the cell's limit.
Served tokens are greedy, so a sound program's gaps are rounding's near
ties, and a wrong layer's are the logits' own spread.

The control puts the reference itself in the program's place, computed one
precision step below what the configuration states (activations quantized
to ``control_act_bits``, INT4 for the stated INT8): at each position the
token the control puts first is read by the same gap.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

import torch

from harness.traffic import rng


def pick(finished: List[Any], seed: int, k: int) -> List[Any]:
    """``k`` finished requests drawn from the seed, the one with the most
    served tokens always among them."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: (len(finished[i].output_tokens), -i))
    rest = [i for i in range(len(finished)) if i != longest]
    g = rng(seed, "check")
    chosen = list(g.choice(rest, size=min(k - 1, len(rest)), replace=False)) \
        if rest and k > 1 else []
    return [finished[i] for i in sorted([longest] + chosen)]


def reference(cfg: Dict[str, Any]):
    return importlib.import_module(f"reference.{cfg['reference']}")


def served_gaps(cfg: Dict[str, Any], seed: int,
                sample: List[Dict[str, List[int]]], device,
                control_bits: Optional[int] = None) -> Dict[str, float]:
    """Widest gap of the served tokens of ``sample`` ([{"prompt": ids,
    "output": ids}]) under the reference, and with ``control_bits`` the
    widest gap of the control's first choices."""
    ref = reference(cfg)
    seqs = [s["prompt"] + s["output"][:-1] for s in sample]
    starts = [len(s["prompt"]) - 1 for s in sample]
    logits = ref.logits_at(cfg, seed, seqs, starts, device)
    served = [torch.tensor(s["output"], dtype=torch.int64, device=device)
              for s in sample]
    out = _gaps(logits, served)
    out["requests"] = len(sample)
    if control_bits is not None:
        ctl = ref.logits_at(cfg, seed, seqs, starts, device,
                            act_bits=control_bits)
        got = _gaps(logits, [c.argmax(dim=-1) for c in ctl])
        out["control_max_gap"] = got["max_gap"]
        out["control_mean_gap"] = got["mean_gap"]
    return out


def _gaps(logits: List[torch.Tensor], chosen: List[torch.Tensor]
          ) -> Dict[str, float]:
    """Widest and mean gap, over every position, of the ``chosen`` token's
    reference logit below the reference's best."""
    if not chosen:
        return {"max_gap": 0.0, "mean_gap": 0.0, "tokens": 0}
    gaps = torch.cat([lg.max(dim=-1).values - lg.gather(1, c[:, None])[:, 0]
                      for lg, c in zip(logits, chosen)])
    return {"max_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "tokens": int(len(gaps))}
