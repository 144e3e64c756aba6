"""Calibration / evaluation data loaders (the port's own copy of
qqq_tpu/utils/data.py: numpy only, ``transformers`` and ``datasets``
imported when a corpus is tokenized).

Mirrors the reference's sampler semantics (QQQ/utils/data_utils.py): random
``seqlen``-token crops of a "\\n\\n"-joined corpus, seeded with ``random.seed``
so crop positions match the reference bit-for-bit for the same tokenizer and
corpus (important for PPL comparisons at the 0.01 level, SURVEY.md §7).

Supported sources: wikitext2 / ptb / c4 / pile via HF ``datasets``, a local
text/jsonl file (the reference's ``get_custom_data`` is a NotImplementedError
stub, data_utils.py:177-180 — here it works), and a ``synthetic`` fallback
(seeded random tokens) so the pipeline runs in fully offline environments.
"""

from __future__ import annotations

import logging
import os
import random
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("qqq_tpu_torch")


def _tokenizer(tokenizer_path: str):
    from transformers import AutoTokenizer

    # use_fast=False matches reference data_utils.py:36 (tokenization parity)
    return AutoTokenizer.from_pretrained(tokenizer_path, use_fast=False)


def _crops(ids: np.ndarray, nsamples: int, seed: int, seqlen: int) -> np.ndarray:
    """Random seqlen crops, reference RNG protocol (random.seed + randint)."""
    random.seed(seed)
    out = np.empty((nsamples, seqlen), np.int32)
    for s in range(nsamples):
        i = random.randint(0, ids.shape[0] - seqlen - 1)
        out[s] = ids[i : i + seqlen]
    return out


#: HF datasets the sampler knows how to fetch (reference data_utils.py:183-213)
KNOWN_DATASETS = (
    "wikitext2", "ptb", "ptb-new", "c4", "c4-new", "pile", "mix", "synthetic",
)

#: pile needs a local shard in offline environments (the reference hardcodes
#: a cluster path, data_utils.py:12); point this env var at val.jsonl.zst
PILE_PATH_ENV = "QQQ_TPU_PILE_PATH"  # the JAX package's variable


def _load_corpus(
    name: str, tokenizer_path: str, split: str,
    custom_data_path: Optional[str] = None,
) -> np.ndarray:
    from datasets import load_dataset

    tok = _tokenizer(tokenizer_path)
    if name == "wikitext2":
        data = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
        text = "\n\n".join(data["text"])
    elif name == "ptb":
        data = load_dataset(
            "ptb_text_only", "penn_treebank",
            split="train" if split == "train" else "validation",
        )
        text = "\n\n".join(data["sentence"])
    elif name == "c4":
        files = (
            {"train": "en/c4-train.00000-of-01024.json.gz"}
            if split == "train"
            else {"validation": "en/c4-validation.00000-of-00008.json.gz"}
        )
        data = load_dataset("allenai/c4", data_files=files, split=split)
        text = "\n\n".join(data["text"][:2000])
    elif name == "pile":
        # reference get_pile (data_utils.py:8-20): one jsonl.zst val shard,
        # same corpus for calib and test
        path = custom_data_path or os.environ.get(PILE_PATH_ENV)
        if path and os.path.exists(path):
            data = load_dataset("json", data_files=path, split="train")
        else:
            data = load_dataset(
                "monology/pile-uncopyrighted",
                data_files={"val": "val.jsonl.zst"}, split="val",
            )
        text = "\n\n".join(data["text"][:2000])
    else:
        raise ValueError(name)
    return np.asarray(tok(text).input_ids, np.int32)


def _load_local(path: str, tokenizer_path: str) -> np.ndarray:
    tok = _tokenizer(tokenizer_path)
    if path.endswith((".jsonl", ".jsonl.zst")):
        import json

        if path.endswith(".zst"):
            import io

            import zstandard

            raw = zstandard.ZstdDecompressor().decompress(
                open(path, "rb").read(), max_output_size=1 << 31
            )
            lines = io.StringIO(raw.decode("utf-8")).readlines()
        else:
            lines = open(path).readlines()
        texts = [json.loads(l)["text"] for l in lines if l.strip()]
        text = "\n\n".join(texts)
    else:
        text = open(path).read()
    return np.asarray(tok(text).input_ids, np.int32)


def get_loaders(
    name: str,
    tokenizer_path: Optional[str] = None,
    nsamples: int = 128,
    seed: int = 0,
    seqlen: int = 2048,
    vocab_size: int = 32000,
    allow_synthetic: bool = False,
    custom_data_path: Optional[str] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (calib_tokens (nsamples, seqlen) int32, test_tokens (N,) or
    None).  ``name`` ∈ KNOWN_DATASETS or a local file path.

    Failure policy: an unknown name raises ValueError immediately; a known
    dataset that can't be fetched raises RuntimeError — calibrating on
    garbage silently produces a garbage checkpoint with rc=0.  Pass ``allow_synthetic=True`` (CLI ``--allow_synthetic``) to
    opt into the random-token fallback for offline smoke runs.
    """
    if custom_data_path:  # reference get_loaders(custom_data_path=...) :191
        name = custom_data_path
    if name not in KNOWN_DATASETS and not os.path.exists(name):
        raise ValueError(
            f"unknown calibration dataset {name!r} (and not a local file); "
            f"known: {', '.join(KNOWN_DATASETS)}"
        )
    if name in ("ptb-new", "c4-new"):  # reference aliases (data_utils.py)
        name = name.split("-")[0]
    if name == "mix":
        # reference's mixed sampler: thirds from wikitext2 / ptb / c4
        parts = []
        for i, sub in enumerate(("wikitext2", "ptb", "c4")):
            n_i = nsamples // 3 + (1 if i < nsamples % 3 else 0)
            calib, _ = get_loaders(
                sub, tokenizer_path, n_i, seed + i, seqlen, vocab_size,
                allow_synthetic=allow_synthetic,
            )
            parts.append(calib)
        return np.concatenate(parts, axis=0), None
    if name == "synthetic":
        rng = np.random.default_rng(seed)
        calib = rng.integers(0, vocab_size, size=(nsamples, seqlen), dtype=np.int64)
        test = rng.integers(0, vocab_size, size=(seqlen * 64,), dtype=np.int64)
        return calib.astype(np.int32), test.astype(np.int32)
    if os.path.exists(name):
        ids = _load_local(name, tokenizer_path)
        return _crops(ids, nsamples, seed, seqlen), ids
    try:
        train_ids = _load_corpus(name, tokenizer_path, "train")
        test_ids = (
            train_ids if name == "pile"  # reference: same shard (:8-20)
            else _load_corpus(name, tokenizer_path, "test")
        )
        return _crops(train_ids, nsamples, seed, seqlen), test_ids
    except Exception as e:  # offline / fetch failure
        if not allow_synthetic:
            raise RuntimeError(
                f"calibration dataset {name!r} could not be loaded ({e}); "
                "pass --allow_synthetic to calibrate on random tokens "
                "(smoke runs only — quality will be garbage)"
            ) from e
        logger.warning(
            "dataset %r unavailable (%s); falling back to synthetic tokens "
            "(--allow_synthetic)", name, e,
        )
        return get_loaders(
            "synthetic", tokenizer_path, nsamples, seed, seqlen, vocab_size
        )
