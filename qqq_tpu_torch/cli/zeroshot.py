"""Zero-shot / few-shot multiple-choice harness for the reference's 5 tasks
(port of qqq_tpu/cli/zeroshot.py; the formatting string for string, the
scoring through the port's utils/eval.py).

The reference runs piqa, arc_easy, arc_challenge, hellaswag, and winogrande
through lm_eval==0.4.2 (reference examples/eval_model.py:100-116,
requirements.txt:6); this module re-implements that library's scoring
protocol, with the formatting isolated in pure functions
(:func:`doc_requests`, :func:`example_text`) that tests hold to the JAX
package's on the golden fixtures of tests/test_zeroshot_format.py.  The
datasets come through HF ``datasets`` and the tokenizer through
``transformers``, both imported only when tasks run.

lm_eval 0.4.2 conventions reproduced here (multiple_choice output type):

* request = (context, continuation); continuation carries the task's
  ``target_delimiter`` (default a single space).
* ``acc`` = argmax over raw loglikelihoods; ``acc_norm`` = argmax over
  ll / len(choice_string) where the normalizing length is the byte length
  of ``doc_to_choice[i]`` — WITHOUT the target delimiter.
* winogrande is a ``multiple_input`` task: the CHOICES are the contexts
  (``sentence[:idx] + option``, no whitespace munging) and the shared
  continuation is ``" " + sentence[idx+1:].strip()``; acc_norm normalizes
  by the context-choice lengths.
* few-shot: ONE ``random.Random(1234)`` per task samples ``k+1`` docs from
  the train split FOR EACH eval doc (state evolves across docs — shots
  differ per doc), drops the eval doc if sampled, keeps the first ``k``;
  each shot renders as ``doc_to_text + " " + gold_target`` joined and
  terminated by "\\n\\n".

Known deviation (documented, unfixable without the real library): arc
examples whose answerKey is missing from choices.label are SKIPPED here;
lm_eval 0.4.2 would raise inside its Jinja template for such rows (none are
known to exist in the released split).
"""

from __future__ import annotations

import logging
import random
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("qqq_tpu_torch")

#: lm_eval 0.4.2 defaults (lm_eval/api/task.py): between context and
#: continuation, and between few-shot examples.
TARGET_DELIMITER = " "
FEWSHOT_DELIMITER = "\n\n"
FEWSHOT_SEED = 1234

TASKS = ("piqa", "arc_easy", "arc_challenge", "hellaswag", "winogrande")


def hellaswag_preprocess(text: str) -> str:
    """lm_eval 0.4.2 hellaswag ``preprocess`` (utils.py of the task),
    verbatim semantics: strip, WikiHow artifact cleanup, bracket removal,
    double-space collapse."""
    text = text.strip()
    text = text.replace(" [title]", ". ")
    text = re.sub("\\[.*?\\]", "", text)
    text = text.replace("  ", " ")
    return text


def doc_requests(
    task: str, ex: dict
) -> Optional[Tuple[List[str], List[str], int, List[int]]]:
    """One eval doc → lm_eval 0.4.2 request tuples.

    Returns ``(contexts, continuations, gold, norm_lens)``: request ``i``
    scores ``continuations[i]`` after ``contexts[i]`` (the few-shot prefix,
    if any, is prepended by the caller); ``norm_lens[i]`` is the byte
    length lm_eval's acc_norm divides request ``i``'s loglikelihood by
    (``len(doc_to_choice(doc)[i])``).  ``None`` = skip the doc.
    """
    if task == "piqa":
        ctx = f"Question: {ex['goal']}\nAnswer:"
        choices = [ex["sol1"], ex["sol2"]]
        return (
            [ctx] * 2,
            [TARGET_DELIMITER + c for c in choices],
            int(ex["label"]),
            [len(c) for c in choices],
        )
    if task in ("arc_easy", "arc_challenge"):
        labels = ex["choices"]["label"]
        if ex["answerKey"] not in labels:
            return None
        ctx = f"Question: {ex['question']}\nAnswer:"
        choices = list(ex["choices"]["text"])
        return (
            [ctx] * len(choices),
            [TARGET_DELIMITER + c for c in choices],
            labels.index(ex["answerKey"]),
            [len(c) for c in choices],
        )
    if task == "hellaswag":
        ctx = ex["ctx_a"] + " " + ex["ctx_b"].capitalize()
        query = hellaswag_preprocess(ex["activity_label"] + ": " + ctx)
        choices = [hellaswag_preprocess(e) for e in ex["endings"]]
        return (
            [query] * len(choices),
            [TARGET_DELIMITER + c for c in choices],
            int(ex["label"]),
            [len(c) for c in choices],
        )
    if task == "winogrande":
        idx = ex["sentence"].index("_")
        # multiple_input task: the choices ARE the contexts — the option
        # spliced verbatim at "_" with NO whitespace adjustments
        # (lm_eval preprocess_winogrande.doc_to_choice); the shared
        # continuation is the stripped suffix behind the delimiter.
        ctxs = [
            ex["sentence"][:idx] + ex["option1"],
            ex["sentence"][:idx] + ex["option2"],
        ]
        cont = TARGET_DELIMITER + ex["sentence"][idx + 1 :].strip()
        return (
            ctxs,
            [cont, cont],
            int(ex["answer"]) - 1,
            [len(c) for c in ctxs],
        )
    raise ValueError(f"unknown task {task!r}")


def example_text(task: str, ex: dict) -> Optional[str]:
    """Render one SOLVED doc for a few-shot prefix: lm_eval 0.4.2 sampler
    ``get_context`` — ``doc_to_text + target_delimiter + gold target`` (for
    winogrande, ``doc_to_choice[gold] + delimiter + doc_to_target``)."""
    reqs = doc_requests(task, ex)
    if reqs is None:
        return None
    ctxs, conts, gold, _ = reqs
    return ctxs[gold] + conts[gold]


class FewshotSampler:
    """lm_eval 0.4.2 default sampler: ONE ``random.Random(1234)`` whose
    state evolves across eval docs; per doc, ``rnd.sample(train, k+1)``,
    drop the eval doc if present, keep the first ``k``."""

    def __init__(self, train_docs: List[dict], seed: int = FEWSHOT_SEED):
        self.docs = train_docs
        self.rnd = random.Random(seed)

    def context(self, task: str, k: int, doc: Optional[dict] = None) -> str:
        if k <= 0:
            return ""
        shots = self.rnd.sample(self.docs, k + 1)
        shots = [x for x in shots if x != doc][:k]
        texts = [example_text(task, s) for s in shots]
        return (
            FEWSHOT_DELIMITER.join(t for t in texts if t is not None)
            + FEWSHOT_DELIMITER
        )


def _load_raw(name: str, limit: int, split: str = "validation"):
    """Raw HF dataset records for a task (dataset access only — all
    formatting lives in :func:`doc_requests`)."""
    from datasets import load_dataset

    if name == "piqa":
        ds = load_dataset("piqa", split=split)
    elif name in ("arc_easy", "arc_challenge"):
        sub = "ARC-Easy" if name == "arc_easy" else "ARC-Challenge"
        ds = load_dataset("allenai/ai2_arc", sub, split=split)
    elif name == "hellaswag":
        ds = load_dataset("hellaswag", split=split)
    elif name == "winogrande":
        ds = load_dataset("winogrande", "winogrande_xl", split=split)
    else:
        raise ValueError(f"unknown task {name!r}")
    out = []
    for i, ex in enumerate(ds):
        if limit and i >= limit:
            break
        out.append(dict(ex))
    return out


def run_tasks(
    params, config, tokenizer_path: str, tasks: List[str], limit: int = 0,
    num_fewshot: int = 0,
) -> Dict[str, float]:
    from transformers import AutoTokenizer

    from qqq_tpu_torch.utils.eval import loglikelihood_batch

    tok = AutoTokenizer.from_pretrained(tokenizer_path, use_fast=False)
    results: Dict[str, float] = {}
    for task in tasks:
        task = task.strip()
        try:
            docs = _load_raw(task, limit)
            sampler = (
                FewshotSampler(_load_raw(task, 0, split="train"))
                if num_fewshot > 0 else None
            )
        except Exception as e:
            logger.warning("task %s unavailable (%s); skipping", task, e)
            continue
        # tokenize all (context, continuation) pairs up front and score them
        # in padded batches of fixed shape, one forward a bucket batch
        pairs, meta, examples = [], [], []
        for ex in docs:
            reqs = doc_requests(task, ex)
            if reqs is None:
                continue
            ctxs, conts, gold, norm_lens = reqs
            prefix = (
                sampler.context(task, num_fewshot, ex) if sampler else ""
            )
            ex_i = len(examples)
            examples.append(gold)
            for ctx, cont, nl in zip(ctxs, conts, norm_lens):
                c_toks = tok(prefix + ctx).input_ids
                t_toks = tok(cont, add_special_tokens=False).input_ids
                pairs.append((c_toks, t_toks))
                meta.append((ex_i, nl))
        scored = loglikelihood_batch(params, config, pairs)

        n_ex = len(examples)
        lls = [[] for _ in range(n_ex)]
        lls_norm = [[] for _ in range(n_ex)]
        for (ex_i, nl), (ll, _) in zip(meta, scored):
            lls[ex_i].append(ll)
            lls_norm[ex_i].append(ll / max(nl, 1))
        acc = sum(
            int(int(np.argmax(l)) == gold) for l, gold in zip(lls, examples)
        )
        acc_norm = sum(
            int(int(np.argmax(l)) == gold)
            for l, gold in zip(lls_norm, examples)
        )
        if n_ex:
            results[f"{task}_acc"] = round(acc / n_ex, 4)
            results[f"{task}_acc_norm"] = round(acc_norm / n_ex, 4)
            logger.info("%s: acc=%.4f acc_norm=%.4f (n=%d)",
                        task, acc / n_ex, acc_norm / n_ex, n_ex)
    return results
