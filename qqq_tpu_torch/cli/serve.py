"""HTTP serving CLI: continuous-batching text generation over the Engine
(port of qqq_tpu/cli/serve.py, with its endpoints, payloads and error
codes).

A threaded HTTP server feeds one shared
:class:`qqq_tpu_torch.serve.engine.Engine`, so concurrent requests batch
together on the card (continuous batching, INT8 KV cache, captured decode
ticks).

Endpoints:
  POST /generate   {"prompt": str | "prompt_tokens": [int], "max_new_tokens",
                    "temperature", "top_k", "top_p",
                    "stop": str | [str],       # stop strings (needs tokenizer)
                    "stop_token_ids": [int],   # extra EOS-like token ids
                    "min_p", "presence_penalty", "frequency_penalty",
                    "repetition_penalty", "seed",
                    "logit_bias": {token_id: bias},
                    "guided_choice": [str | [int]],  # constrained output
                    "logprobs": bool}  →
                   {"output_tokens": [int], "text": str?, "num_generated": int,
                    "token_logprobs": [float]?}
  POST /v1/completions   OpenAI-compatible completions (prompt / max_tokens /
                   temperature / top_p / stop / logprobs / logit_bias /
                   n / best_of / echo incl. echo+max_tokens=0 prompt
                   scoring / stream-as-SSE) — drop-in for clients pointed
                   at the reference's vLLM deployment (QQQ README.md:15,
                   77-79)
  GET  /v1/models  OpenAI-compatible model listing
  GET  /health     {"status": "ok", "active": n, "pending": n}

  GET  /stats      the engine's counters and latency percentiles

Usage:
  python -m qqq_tpu_torch.cli.serve --model_path <dir> --port 8000
  curl -s localhost:8000/generate -d '{"prompt_tokens": [1,2,3]}'

Without a tokenizer (no ``transformers``, or none at the model path) the
server takes and returns token ids only.

Design notes: all device work stays on ONE worker thread (the engine loop);
HTTP handler threads only submit requests to the engine's inbox and poll
``Request.done``.  Echo scoring also runs on the worker, through
``Engine.submit_call``, so no handler thread ever touches the card: CUDA
work from another thread during a graph capture would break the capture.
``Engine.run`` drains the inbox every scheduling round, so a request
arriving mid-run joins the running batch as soon as a slot frees.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import itertools
import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import torch

from qqq_tpu_torch.serve.engine import Engine, Request
from qqq_tpu_torch.serve.sampling import SamplingParams

log = logging.getLogger("qqq_tpu_torch")


class EngineWorker:
    """Single engine-owning thread; HTTP threads submit and wait.

    ``submit`` adds to the engine's inbox (drained by a run in progress)
    and wakes the worker; the worker calls ``Engine.run([])``, which runs
    until the inbox, the queue and the slots are empty.  A wake token
    enqueued after the add guarantees that a request landing just as
    ``run`` returns is picked up by the next loop iteration.
    """

    def __init__(self, engine: Engine, tokenizer=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self._wake: "queue.Queue[Optional[object]]" = queue.Queue()
        self._shutdown = False
        self.error: Optional[BaseException] = None
        self._streams: Dict[int, "queue.Queue[int]"] = {}
        self._stops: Dict[int, list] = {}       # id(req) → stop strings
        self._stop_text: Dict[int, str] = {}    # id(req) → truncated text
        engine.on_token = self._on_token
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, req: Request) -> None:
        if self.error is not None:
            raise RuntimeError(f"engine worker died: {self.error!r}")
        self.engine.add_request(req)
        self._wake.put(None)

    # -- stop strings ---------------------------------------------------------

    def set_stops(self, req: Request, stops: list) -> None:
        """Register stop strings BEFORE submit (requires a tokenizer).  The
        on_token watcher re-decodes the output so far each token — O(n²) in
        generation length, negligible next to a decode step — and cancels
        the request the moment any stop string appears; the final text is
        truncated just before it (vLLM stop-string semantics)."""
        if stops:
            self._stops[id(req)] = list(stops)

    def take_stop_text(self, req: Request) -> Optional[str]:
        self._stops.pop(id(req), None)
        return self._stop_text.pop(id(req), None)

    def clear_stops(self, req: Request) -> None:
        """Drop stop-watcher state unconditionally — MUST run on every
        error/disconnect path too: entries are keyed by id(req), and CPython
        reuses ids, so a leaked entry could truncate a future request."""
        self._stops.pop(id(req), None)
        self._stop_text.pop(id(req), None)

    def cancel(self, req: Request) -> None:
        """Abandon a request from an error/disconnect path: stop the engine
        from generating further tokens for it (otherwise a timed-out
        best_of=64 burst keeps burning decode ticks to completion) AND drop
        its stop-watcher state."""
        self.engine.cancel(req)
        self.clear_stops(req)

    # -- streaming ----------------------------------------------------------

    def open_stream(self, req: Request) -> "queue.Queue[int]":
        """Register BEFORE submit; tokens arrive as the engine emits them."""
        q: "queue.Queue[int]" = queue.Queue()
        self._streams[id(req)] = q
        return q

    def close_stream(self, req: Request) -> None:
        self._streams.pop(id(req), None)

    def _on_token(self, req: Request, tok: int) -> None:
        stops = self._stops.get(id(req))
        if stops and self.tokenizer is not None:
            text = self.tokenizer.decode(req.output_tokens[: req._emitted])
            cut = min(
                (i for i in (text.find(s) for s in stops) if i >= 0),
                default=-1,
            )
            if cut >= 0:
                self._stop_text[id(req)] = text[:cut]
                self.engine.cancel(req)
                return  # don't stream the token that completed the stop
        q = self._streams.get(id(req))
        if q is not None:
            q.put(tok)

    def _loop(self) -> None:
        while not self._shutdown:
            try:
                token = self._wake.get(timeout=0.1)
            except queue.Empty:
                continue
            if token is StopIteration:
                return
            try:
                while not self._wake.empty():  # coalesce wakes
                    self._wake.get_nowait()
                self.engine.run([])
            except BaseException as e:  # noqa: BLE001 — surfaced to clients
                self.error = e
                log.exception("engine worker failed")
                return

    def stop(self) -> None:
        self._shutdown = True
        self._wake.put(StopIteration)
        self._thread.join(timeout=5)

    def wait(self, req: Request, timeout: float = 600.0) -> None:
        t0 = time.monotonic()
        while not req.done:
            if self.error is not None:
                raise RuntimeError(f"engine worker died: {self.error!r}")
            if time.monotonic() - t0 > timeout:
                raise TimeoutError("generation timed out")
            time.sleep(0.002)

    def score_prompt(self, tokens: List[int],
                     timeout: float = 600.0) -> List[Optional[float]]:
        """:meth:`Engine.score_prompt` run on the worker thread (between
        two scheduling rounds); raises what it raises."""
        if self.error is not None:
            raise RuntimeError(f"engine worker died: {self.error!r}")
        fut = self.engine.submit_call(
            lambda: self.engine.score_prompt(tokens))
        self._wake.put(None)
        t0 = time.monotonic()
        while True:
            try:
                return fut.result(timeout=0.05)
            except concurrent.futures.TimeoutError:
                if self.error is not None:
                    raise RuntimeError(
                        f"engine worker died: {self.error!r}") from None
                if time.monotonic() - t0 > timeout:
                    fut.cancel()  # a call not yet started never runs
                    raise TimeoutError("scoring timed out") from None


def _num(body: Dict[str, Any], key: str, default, cast):
    """body[key] with OpenAI-client semantics: an explicit JSON null means
    'use the default', and a bad type must 400, not kill the connection."""
    v = body.get(key)
    return default if v is None else cast(v)


def _parse_sampling(body: Dict[str, Any], *, temp_default: float,
                    max_key: str, max_default: int, eos,
                    vocab: Optional[int] = None,
                    tokenizer=None) -> SamplingParams:
    """Shared request→SamplingParams parsing for all three endpoints —
    raises ValueError/TypeError on bad values (callers reply 400)."""
    gc = body.get("guided_choice") or ()
    if not isinstance(gc, (list, tuple)):
        raise ValueError("guided_choice must be a list")
    guided = []
    for c in gc:
        if isinstance(c, list) and c and all(isinstance(t, int) for t in c):
            guided.append(tuple(c))
        elif isinstance(c, str) and c and tokenizer is not None:
            try:
                ids = tokenizer(c, add_special_tokens=False).input_ids
            except TypeError:  # tokenizer without the kwarg (tests)
                ids = tokenizer(c).input_ids
            if not ids:
                raise ValueError(f"guided_choice entry {c!r} tokenizes "
                                 "to nothing")
            guided.append(tuple(ids))
        else:
            raise ValueError(
                "guided_choice entries must be non-empty strings (needs a "
                "tokenizer) or token-id lists"
            )
    mp = _num(body, "min_p", 0.0, float)
    if not 0.0 <= mp <= 1.0:
        raise ValueError(f"min_p must be in [0, 1], got {mp}")
    # top-N alternative logprobs: chat's ``top_logprobs`` or completions'
    # integer ``logprobs`` (booleans mean chosen-token scores only)
    n_top = body.get("top_logprobs")
    if n_top is None:
        lp = body.get("logprobs")
        n_top = (lp if isinstance(lp, int) and not isinstance(lp, bool)
                 else 0)
    n_top = int(n_top or 0)
    if not 0 <= n_top <= 8:
        raise ValueError(f"top_logprobs must be in [0, 8], got {n_top}")
    lb = body.get("logit_bias") or {}
    if not isinstance(lb, dict):
        raise ValueError("logit_bias must be a {token_id: bias} object")
    bias = []
    for k, v in lb.items():
        b = float(v)
        if not -100.0 <= b <= 100.0:
            raise ValueError(f"logit_bias values must be in [-100, 100], "
                             f"got {b}")
        tid = int(k)
        # invalid ids must 400 (OpenAI/vLLM behavior), not index out of
        # the vocabulary or wrap around it
        if tid < 0 or (vocab is not None and tid >= vocab):
            raise ValueError(f"logit_bias token id {tid} out of range "
                             f"[0, {vocab})")
        bias.append((tid, b))
    return SamplingParams(
        temperature=_num(body, "temperature", temp_default, float),
        top_k=_num(body, "top_k", 0, int),  # vLLM extension
        top_p=_num(body, "top_p", 1.0, float),
        min_p=mp,
        seed=None if body.get("seed") is None else int(body["seed"]),
        max_new_tokens=_num(body, max_key, max_default, int),
        eos_token_id=eos,
        stop_token_ids=tuple(body.get("stop_token_ids") or ()),
        presence_penalty=_num(body, "presence_penalty", 0.0, float),
        frequency_penalty=_num(body, "frequency_penalty", 0.0, float),
        repetition_penalty=_num(body, "repetition_penalty", 1.0, float),
        logit_bias=tuple(sorted(bias)),
        guided_choice=tuple(guided),
        top_logprobs=n_top,
    )


def _fan_out(sampling: SamplingParams, toks, count: int):
    """``count`` candidate Requests over one prompt (OpenAI ``n`` /
    ``best_of``).  A seeded request's candidates get ``seed + i`` — our
    reproducible-sampling noise is keyed on (seed, generation index) only,
    so identical seeds would produce identical candidates."""
    reqs = []
    for i in range(count):
        sp = sampling
        if sp.seed is not None and count > 1:
            sp = dataclasses.replace(sp, seed=sp.seed + i)
        reqs.append(Request(prompt_tokens=list(toks), sampling=sp))
    return reqs


def _mean_logprob(req: Request) -> float:
    if not req.token_logprobs:
        return float("-inf")
    return sum(req.token_logprobs) / len(req.token_logprobs)


def _make_handler(worker: EngineWorker, tokenizer=None,
                  default_eos: Optional[int] = None,
                  model_name: str = "qqq-tpu"):
    max_prompt = worker.engine.max_len - 1
    if not worker.engine.prefill_chunk:
        max_prompt = min(max_prompt, worker.engine.prefill_buckets[-1])
    counter = itertools.count()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):  # route through our logger
            log.debug("http: " + fmt, *a)

        def _reply(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            eng = worker.engine
            if self.path == "/health":
                return self._reply(200, {
                    "status": "error" if worker.error else "ok",
                    "active": sum(r is not None for r in eng.slot_req),
                    "pending": len(eng._pending),
                })
            if self.path == "/stats":
                return self._reply(200, {
                    **eng.stats,
                    **eng.latency_summary(),
                    "active": sum(r is not None for r in eng.slot_req),
                    "pending": len(eng._pending),
                    "max_batch": eng.max_batch,
                    "max_len": eng.max_len,
                })
            if self.path == "/v1/models":
                return self._reply(200, {
                    "object": "list",
                    "data": [{"id": model_name, "object": "model",
                              "owned_by": "qqq-tpu"}],
                })
            self._reply(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802 — http.server API
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": f"bad JSON: {e}"})
            if self.path == "/v1/completions":
                return self._completions(body)
            if self.path == "/v1/chat/completions":
                return self._chat_completions(body)
            if self.path != "/generate":
                return self._reply(404, {"error": "not found"})

            if "prompt_tokens" in body:
                toks = body["prompt_tokens"]
                if not (isinstance(toks, list)
                        and all(isinstance(t, int) for t in toks) and toks):
                    return self._reply(
                        400, {"error": "prompt_tokens: non-empty [int]"}
                    )
            elif "prompt" in body:
                if tokenizer is None:
                    return self._reply(
                        400,
                        {"error": "no tokenizer loaded; send prompt_tokens"},
                    )
                toks = tokenizer(body["prompt"]).input_ids
            else:
                return self._reply(
                    400, {"error": "need prompt or prompt_tokens"}
                )
            if len(toks) > max_prompt:
                return self._reply(400, {
                    "error": f"prompt length {len(toks)} exceeds the largest "
                             f"prefill bucket {max_prompt}"
                })

            stops = body.get("stop", [])
            if isinstance(stops, str):
                stops = [stops]
            if stops and tokenizer is None:
                return self._reply(
                    400, {"error": "stop strings need a tokenizer; "
                                   "use stop_token_ids"}
                )
            try:
                sampling = _parse_sampling(
                    body, temp_default=0.0,
                    max_key="max_new_tokens", max_default=128,
                    eos=body.get("eos_token_id", default_eos),
                    vocab=worker.engine.config.vocab_size,
                    tokenizer=tokenizer,
                )
            except (TypeError, ValueError) as e:
                return self._reply(400, {"error": f"bad parameter: {e}"})
            req = Request(prompt_tokens=list(toks), sampling=sampling)
            worker.set_stops(req, stops)
            want_logprobs = bool(body.get("logprobs"))
            if body.get("stream"):
                return self._stream(req, want_logprobs)
            try:
                worker.submit(req)
                worker.wait(req)
            except (RuntimeError, TimeoutError) as e:
                worker.cancel(req)
                return self._reply(500, {"error": str(e)})
            out: Dict[str, Any] = {
                "output_tokens": req.output_tokens,
                "num_generated": len(req.output_tokens),
            }
            if want_logprobs:
                out["token_logprobs"] = req.token_logprobs
            if req.top_logprobs:
                out["top_logprobs"] = req.top_logprobs
            stop_text = worker.take_stop_text(req)
            if tokenizer is not None:
                out["text"] = (
                    stop_text if stop_text is not None
                    else tokenizer.decode(req.output_tokens)
                )
            self._reply(200, out)

        def _stream(self, req: Request, want_logprobs: bool = False) -> None:
            """Chunked NDJSON: one {"token": t} line per generated token,
            then a final {"done": true, ...} line."""
            q = worker.open_stream(req)
            try:
                worker.submit(req)
            except RuntimeError as e:
                worker.close_stream(req)
                worker.clear_stops(req)
                return self._reply(500, {"error": str(e)})
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(payload: Dict[str, Any]) -> None:
                data = (json.dumps(payload) + "\n").encode()
                self.wfile.write(
                    f"{len(data):X}\r\n".encode() + data + b"\r\n"
                )
                self.wfile.flush()

            # incremental detokenization: decode the RUNNING sequence and
            # emit the suffix — per-token decode drops SentencePiece word
            # boundaries and mangles multi-token UTF-8 sequences
            acc: list = []
            prev = ""

            def tok_out(tok: int) -> Dict[str, Any]:
                nonlocal prev
                out: Dict[str, Any] = {"token": tok}
                if tokenizer is not None:
                    acc.append(tok)
                    full = tokenizer.decode(acc)
                    out["text"], prev = full[len(prev):], full
                return out

            try:
                while True:
                    try:
                        tok = q.get(timeout=0.05)
                    except queue.Empty:
                        if worker.error is not None:
                            chunk({"error": f"engine died: {worker.error!r}"})
                            break
                        # _emitted catches up to output_tokens at the END of
                        # the engine's final emit — no token can still be in
                        # flight once this holds
                        if (req.done and q.empty()
                                and req._emitted >= len(req.output_tokens)):
                            break
                        continue
                    chunk(tok_out(tok))
                # done is set just before the final emit — drain stragglers
                while not q.empty():
                    chunk(tok_out(q.get_nowait()))
                final: Dict[str, Any] = {
                    "done": True,
                    "output_tokens": req.output_tokens,
                    "num_generated": len(req.output_tokens),
                }
                if want_logprobs:
                    final["token_logprobs"] = req.token_logprobs
                stop_text = worker.take_stop_text(req)
                if stop_text is not None:
                    final["text"] = stop_text
                chunk(final)
                self.wfile.write(b"0\r\n\r\n")
            except BrokenPipeError:
                pass  # client went away; engine finishes the slot anyway
            finally:
                worker.close_stream(req)
                worker.clear_stops(req)

        # -- OpenAI-compatible surface ------------------------------------

        def _completions(self, body: Dict[str, Any]) -> None:
            """OpenAI /v1/completions (the API the reference's recommended
            vLLM deployment serves): prompt as a string or a token-id list,
            OpenAI defaults (max_tokens=16, temperature=1.0), SSE streaming.
            ``n`` > 1 fans out into sibling requests that batch together in
            the engine; ``best_of`` > n generates best_of candidates and
            returns the n with the highest mean logprob (OpenAI semantics).
            ``echo`` prepends the prompt to every choice's text and (with
            logprobs) its per-token scores via one scoring forward
            (Engine.score_prompt); ``echo`` + ``max_tokens=0`` is the pure
            prompt-scoring call.  Streaming with n > 1 or echo is not
            supported (400)."""
            echo = bool(body.get("echo"))
            prompt = body.get("prompt")
            if isinstance(prompt, list) and prompt and all(
                isinstance(t, int) for t in prompt
            ):
                toks = prompt
            elif isinstance(prompt, str):
                if tokenizer is None:
                    return self._reply(
                        400, {"error": "no tokenizer loaded; send the "
                                       "prompt as a token-id list"}
                    )
                toks = tokenizer(prompt).input_ids
            else:
                return self._reply(
                    400, {"error": "prompt: string or [int] required"}
                )
            if len(toks) > max_prompt:
                return self._reply(400, {
                    "error": f"prompt length {len(toks)} exceeds the "
                             f"largest prefill bucket {max_prompt}"
                })
            stops = body.get("stop") or []
            if isinstance(stops, str):
                stops = [stops]
            if stops and tokenizer is None:
                return self._reply(
                    400, {"error": "stop strings need a tokenizer"}
                )
            try:
                sampling = _parse_sampling(
                    body, temp_default=1.0,
                    max_key="max_tokens", max_default=16,
                    eos=default_eos,
                    vocab=worker.engine.config.vocab_size,
                    tokenizer=tokenizer,
                )
                n_out = _num(body, "n", 1, int)
                best_of = _num(body, "best_of", n_out, int)
                if not 1 <= n_out <= best_of <= 64:
                    raise ValueError(
                        f"need 1 <= n <= best_of <= 64, got n={n_out} "
                        f"best_of={best_of}"
                    )
            except (TypeError, ValueError) as e:
                return self._reply(400, {"error": f"bad parameter: {e}"})
            want_logprobs = body.get("logprobs") not in (None, 0, False)
            cid = f"cmpl-{next(counter)}"
            if body.get("stream"):
                if best_of > 1 or echo:
                    return self._reply(400, {
                        "error": "streaming with n/best_of > 1 or echo is "
                                 "not supported"
                    })
                req = _fan_out(sampling, toks, 1)[0]
                worker.set_stops(req, stops)
                return self._completions_stream(req, cid, want_logprobs)
            prompt_lps: list = []
            if echo:
                try:
                    prompt_lps = worker.score_prompt(list(toks))
                except ValueError as e:
                    return self._reply(400, {"error": f"echo: {e}"})
                except (RuntimeError, TimeoutError) as e:
                    return self._reply(500, {"error": str(e)})
            if echo and sampling.max_new_tokens == 0:
                # pure scoring: no generation at all (OpenAI echo +
                # max_tokens=0)
                text = tokenizer.decode(toks) if tokenizer else ""
                return self._reply(200, {
                    "id": cid, "object": "text_completion",
                    "created": int(time.time()),
                    "model": body.get("model", model_name),
                    "choices": [{
                        "text": text, "index": 0, "finish_reason": "length",
                        "logprobs": (
                            {"token_logprobs": prompt_lps,
                             "tokens": list(toks)}
                            if want_logprobs else None
                        ),
                    }],
                    "usage": {"prompt_tokens": len(toks),
                              "completion_tokens": 0,
                              "total_tokens": len(toks)},
                })
            if sampling.max_new_tokens <= 0:
                # OpenAI max_tokens=0 (without echo): empty completions —
                # the engine would otherwise emit the prefill-sampled token
                return self._reply(200, {
                    "id": cid, "object": "text_completion",
                    "created": int(time.time()),
                    "model": body.get("model", model_name),
                    "choices": [{
                        "text": "", "index": i, "finish_reason": "length",
                        "logprobs": (
                            {"token_logprobs": [], "tokens": []}
                            if want_logprobs else None
                        ),
                    } for i in range(n_out)],
                    "usage": {"prompt_tokens": len(toks),
                              "completion_tokens": 0,
                              "total_tokens": len(toks)},
                })
            reqs = _fan_out(sampling, toks, best_of)
            for r in reqs:
                worker.set_stops(r, stops)
            try:
                for r in reqs:
                    worker.submit(r)
                for r in reqs:
                    worker.wait(r)
            except (RuntimeError, TimeoutError) as e:
                for r in reqs:
                    worker.cancel(r)
                return self._reply(500, {"error": str(e)})
            # best_of > n: keep the n candidates with the highest mean
            # logprob (OpenAI's "highest log probability per token")
            order = sorted(range(best_of),
                           key=lambda i: -_mean_logprob(reqs[i]))
            chosen = [reqs[i] for i in sorted(order[:n_out])]
            choices = []
            prefix = (tokenizer.decode(toks)
                      if echo and tokenizer is not None else "")
            for idx, r in enumerate(chosen):
                stop_text = worker.take_stop_text(r)
                if tokenizer is not None:
                    text = (stop_text if stop_text is not None
                            else tokenizer.decode(r.output_tokens))
                else:
                    text = ""
                lp_block = None
                if want_logprobs:
                    lp_block = {
                        "token_logprobs": prompt_lps + r.token_logprobs,
                        "tokens": list(toks) + r.output_tokens,
                    } if echo else {
                        "token_logprobs": r.token_logprobs,
                        "tokens": r.output_tokens,
                    }
                    if r.sampling.top_logprobs:
                        tops = [
                            {(tokenizer.decode([t]) if tokenizer
                              else str(t)): v for t, v in pos}
                            for pos in r.top_logprobs
                        ]
                        lp_block["top_logprobs"] = (
                            [None] * len(toks) + tops if echo else tops
                        )
                choices.append({
                    "text": prefix + text if echo else text,
                    "index": idx,
                    "finish_reason": r.finish_reason or "stop",
                    "logprobs": lp_block,
                })
            for r in reqs:  # discarded best_of candidates
                worker.clear_stops(r)
            self._reply(200, {
                "id": cid,
                "object": "text_completion",
                "created": int(time.time()),
                "model": body.get("model", model_name),
                "choices": choices,
                "usage": {
                    "prompt_tokens": len(toks),
                    # OpenAI counts every generated token, incl. discarded
                    # best_of candidates
                    "completion_tokens": sum(
                        len(r.output_tokens) for r in reqs
                    ),
                    "total_tokens": len(toks) + sum(
                        len(r.output_tokens) for r in reqs
                    ),
                },
            })

        def _chat_completions(self, body: Dict[str, Any]) -> None:
            """OpenAI /v1/chat/completions: ``messages`` are rendered
            through the tokenizer's chat template (``apply_chat_template``,
            add_generation_prompt=True), generation flows through the same
            engine path as completions, and the response/stream use chat
            framing (message / delta chunks)."""
            if tokenizer is None or not hasattr(
                tokenizer, "apply_chat_template"
            ):
                return self._reply(
                    400, {"error": "chat completions need a tokenizer with "
                                   "a chat template"}
                )
            messages = body.get("messages")
            if not (isinstance(messages, list) and messages and all(
                isinstance(m, dict) and "role" in m and "content" in m
                for m in messages
            )):
                return self._reply(
                    400, {"error": "messages: [{role, content}, …] required"}
                )
            if body.get("tools"):  # empty list = no tools = fine
                return self._reply(
                    400, {"error": "'tools' is not supported"}
                )
            if body.get("tool_choice") not in (None, "none", "auto"):
                return self._reply(
                    400, {"error": "'tool_choice' is not supported"}
                )
            try:
                toks = tokenizer.apply_chat_template(
                    messages, add_generation_prompt=True
                )
            except Exception as e:  # template errors are client errors
                return self._reply(400, {"error": f"chat template: {e}"})
            if len(toks) > max_prompt:
                return self._reply(400, {
                    "error": f"rendered prompt length {len(toks)} exceeds "
                             f"{max_prompt}"
                })
            stops = body.get("stop") or []
            if isinstance(stops, str):
                stops = [stops]
            try:
                sampling = _parse_sampling(
                    body, temp_default=1.0,
                    max_key="max_tokens", max_default=128,
                    eos=default_eos,
                    vocab=worker.engine.config.vocab_size,
                    tokenizer=tokenizer,
                )
                n_out = _num(body, "n", 1, int)
                if not 1 <= n_out <= 64:
                    raise ValueError(f"need 1 <= n <= 64, got {n_out}")
            except (TypeError, ValueError) as e:
                return self._reply(400, {"error": f"bad parameter: {e}"})
            want_logprobs = body.get("logprobs") not in (None, 0, False)
            cid = f"chatcmpl-{next(counter)}"
            if body.get("stream"):
                if n_out > 1:
                    return self._reply(400, {
                        "error": "streaming with n > 1 is not supported"
                    })
                req = _fan_out(sampling, toks, 1)[0]
                worker.set_stops(req, stops)
                return self._completions_stream(
                    req, cid, want_logprobs, chat=True
                )
            reqs = _fan_out(sampling, toks, n_out)
            for r in reqs:
                worker.set_stops(r, stops)
            try:
                for r in reqs:
                    worker.submit(r)
                for r in reqs:
                    worker.wait(r)
            except (RuntimeError, TimeoutError) as e:
                for r in reqs:
                    worker.cancel(r)
                return self._reply(500, {"error": str(e)})
            choices = []
            for idx, r in enumerate(reqs):
                stop_text = worker.take_stop_text(r)
                text = (stop_text if stop_text is not None
                        else tokenizer.decode(r.output_tokens))
                choices.append({
                    "index": idx,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": r.finish_reason or "stop",
                    "logprobs": (
                        {"content": [
                            {"token": tokenizer.decode([t]), "logprob": lp,
                             **({"top_logprobs": [
                                 {"token": tokenizer.decode([tt]),
                                  "logprob": tv}
                                 for tt, tv in r.top_logprobs[i]
                             ]} if r.sampling.top_logprobs else {})}
                            for i, (t, lp) in enumerate(zip(
                                r.output_tokens, r.token_logprobs))
                        ]} if want_logprobs else None
                    ),
                })
            self._reply(200, {
                "id": cid,
                "object": "chat.completion",
                "created": int(time.time()),
                "model": body.get("model", model_name),
                "choices": choices,
                "usage": {
                    "prompt_tokens": len(toks),
                    "completion_tokens": sum(
                        len(r.output_tokens) for r in reqs
                    ),
                    "total_tokens": len(toks) + sum(
                        len(r.output_tokens) for r in reqs
                    ),
                },
            })

        def _completions_stream(self, req: Request, cid: str,
                                want_logprobs: bool,
                                chat: bool = False) -> None:
            """SSE: ``data: {chunk}`` per token, then a finish_reason chunk
            and ``data: [DONE]`` (OpenAI stream framing; chat mode uses
            chat.completion.chunk delta framing)."""
            q = worker.open_stream(req)
            try:
                worker.submit(req)
            except RuntimeError as e:
                worker.close_stream(req)
                worker.clear_stops(req)
                return self._reply(500, {"error": str(e)})
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def sse(payload) -> None:
                data = (
                    "data: "
                    + (payload if isinstance(payload, str)
                       else json.dumps(payload))
                    + "\n\n"
                ).encode()
                self.wfile.write(
                    f"{len(data):X}\r\n".encode() + data + b"\r\n"
                )
                self.wfile.flush()

            acc: list = []
            prev = ""

            def tok_chunk(tok: int, finish: Optional[str] = None):
                # incremental detokenization (see _stream): decode the
                # running sequence, emit the suffix
                nonlocal prev
                text = ""
                if tokenizer is not None and tok >= 0:
                    acc.append(tok)
                    full = tokenizer.decode(acc)
                    text, prev = full[len(prev):], full
                if chat:
                    delta = {"content": text} if tok >= 0 else {}
                    if len(acc) == 1 and tok >= 0:  # first content chunk
                        delta["role"] = "assistant"
                    return {
                        "id": cid, "object": "chat.completion.chunk",
                        "created": int(time.time()), "model": model_name,
                        "choices": [{
                            "index": 0, "delta": delta,
                            "finish_reason": finish,
                        }],
                    }
                return {
                    "id": cid, "object": "text_completion",
                    "created": int(time.time()), "model": model_name,
                    "choices": [{
                        "text": text,
                        "index": 0, "finish_reason": finish,
                    }],
                }

            try:
                while True:
                    try:
                        tok = q.get(timeout=0.05)
                    except queue.Empty:
                        if worker.error is not None:
                            sse({"error": f"engine died: {worker.error!r}"})
                            break
                        if (req.done and q.empty()
                                and req._emitted >= len(req.output_tokens)):
                            break
                        continue
                    sse(tok_chunk(tok))
                while not q.empty():
                    sse(tok_chunk(q.get_nowait()))
                worker.take_stop_text(req)
                final = tok_chunk(-1, finish=req.finish_reason or "stop")
                if want_logprobs:
                    final["choices"][0]["logprobs"] = {
                        "token_logprobs": req.token_logprobs,
                        "tokens": req.output_tokens,
                    }
                sse(final)
                sse("[DONE]")
                self.wfile.write(b"0\r\n\r\n")
            except BrokenPipeError:
                pass
            finally:
                worker.close_stream(req)
                worker.clear_stops(req)

    return Handler


def make_server(
    engine: Engine,
    host: str = "127.0.0.1",
    port: int = 8000,
    tokenizer=None,
    default_eos: Optional[int] = None,
    model_name: str = "qqq-tpu",
):
    """Build (server, worker); call ``server.serve_forever()`` to run.
    Factored out of ``main`` so tests can serve a tiny in-memory model."""
    worker = EngineWorker(engine, tokenizer)
    server = ThreadingHTTPServer(
        (host, port), _make_handler(worker, tokenizer, default_eos,
                                    model_name)
    )
    return server, worker


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_length", type=int, default=2048)
    p.add_argument("--steps_per_tick", type=int, default=1,
                   help=">1 fuses that many decode steps in each captured "
                        "tick (chunked EOS checks)")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="paged mode: prompt tokens prefilled per chunk (0 = "
                        "the engine's default); not ported in slot mode")
    p.add_argument("--prefix_cache", action="store_true",
                   help="not ported yet: refused at startup")
    p.add_argument("--spec_ngram", type=int, default=0,
                   help="not ported yet: >0 is refused at startup")
    p.add_argument("--spec_k", type=int, default=4)
    p.add_argument("--kv_int8", action="store_true", default=True)
    p.add_argument("--paged", action="store_true",
                   help="paged KV cache (block pool + block tables, "
                        "serve/paged_kv.py): KV memory follows the tokens "
                        "in flight; pool exhaustion preempts (recompute)")
    p.add_argument("--block_size", type=int, default=128,
                   help="paged-KV tokens per block")
    p.add_argument("--num_blocks", type=int, default=0,
                   help="paged-KV pool size in blocks (0 = cover "
                        "max_batch x max_length; smaller oversubscribes)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="the CUDA card by default; 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    return p.parse_args(argv)


def load_tokenizer(path: str):
    """The HF tokenizer at ``path``, or None (``transformers`` absent, or
    no tokenizer there): the server then serves token ids only."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path, use_fast=False,
                                             local_files_only=True)
    except Exception as e:  # noqa: BLE001 — tokens in / tokens out works
        log.warning("no tokenizer (%s); serving prompt_tokens only", e)
        return None


def build_engine(args) -> Engine:
    """Load ``args.model_path`` onto ``args.device`` and build the Engine
    that the CLI flags describe."""
    from qqq_tpu_torch.cli.eval import load_any

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params, config = load_any(args.model_path, dtype, device=args.device)
    return Engine(
        params, config, max_batch=args.max_batch, max_len=args.max_length,
        kv_quantized=args.kv_int8, steps_per_tick=args.steps_per_tick,
        prefill_chunk=args.prefill_chunk, spec_ngram=args.spec_ngram,
        spec_k=args.spec_k, prefix_cache=args.prefix_cache, dtype=dtype,
        paged=args.paged, block_size=args.block_size,
        num_blocks=args.num_blocks or None, device=args.device,
    )


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    engine = build_engine(args)
    tokenizer = load_tokenizer(args.tokenizer_path or args.model_path)
    eos = tokenizer.eos_token_id if tokenizer is not None else None
    server, worker = make_server(
        engine, args.host, args.port, tokenizer, eos,
        model_name=os.path.basename(args.model_path.rstrip("/")) or "qqq-tpu",
    )
    log.info("serving on http://%s:%d (max_batch=%d, max_len=%d)",
             args.host, args.port, args.max_batch, args.max_length)
    try:
        server.serve_forever()
    finally:
        worker.stop()


if __name__ == "__main__":
    main()
