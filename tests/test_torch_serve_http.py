"""The port's HTTP front end (qqq_tpu_torch/cli/serve.py) and its generate
CLI, on the CPU: the subset of tests/test_serve_http.py that needs no real
tokenizer, over the same toy tokenizers (token t ↔ text " t"; a chat
template of role marker tokens).

A toy dense f32 model drawn by the port from a seeded generator, prompts
from a numpy seed.  Served greedy tokens must equal the port's direct
generation on the same params; echo scores a naive log_softmax forward
within 1e-4 (one f32 forward over the padded bucket against one over the
prompt alone).
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from qqq_tpu_torch.cli import generate as gen_cli
from qqq_tpu_torch.cli.serve import (
    EngineWorker, build_engine, make_server, parse_args,
)
from qqq_tpu_torch.models import (
    ModelConfig, forward, init_params, quantize_params_rtn,
)
from qqq_tpu_torch.models.loader import save_quantized
from qqq_tpu_torch.serve.engine import Engine, Request, generate
from qqq_tpu_torch.serve.sampling import SamplingParams

CFG = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128)
ENGINE_KW = dict(max_batch=2, max_len=64, kv_quantized=False,
                 dtype=torch.float32, prefill_buckets=(16,), device="cpu")


class _ToyTokenizer:
    """Token ids ↔ text: token t decodes to ' t'."""

    eos_token_id = None

    def decode(self, toks):
        return "".join(f" {t}" for t in toks)

    def __call__(self, text, **kw):
        class R:
            input_ids = [int(t) for t in text.split()]
        return R()


class _ChatToyTokenizer(_ToyTokenizer):
    """Adds a chat template: roles become marker tokens."""

    def apply_chat_template(self, messages, add_generation_prompt=True):
        toks = []
        for m in messages:
            toks.append(1 if m["role"] == "user" else 2)
            toks.extend(int(t) for t in str(m["content"]).split())
        if add_generation_prompt:
            toks.append(3)
        return toks


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")


def _serve(params, tokenizer):
    engine = Engine(params, CFG, **ENGINE_KW)
    server, worker = make_server(engine, port=0, tokenizer=tokenizer)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}", server, worker


@pytest.fixture(scope="module")
def servers(params):
    """One server each without a tokenizer, with the toy tokenizer and with
    the chat template: kind → base URL."""
    running = {kind: _serve(params, tok) for kind, tok in (
        ("ids", None), ("toy", _ToyTokenizer()),
        ("chat", _ChatToyTokenizer()))}
    yield {kind: base for kind, (base, _, _) in running.items()}
    for _, server, worker in running.values():
        server.shutdown()
        worker.stop()


@pytest.fixture(params=["ids", "toy", "chat"])
def served(request, servers):
    return servers[request.param]


@pytest.fixture
def served_tok(servers):
    return servers["toy"]


def _want(params, prompt, n):
    return generate(params, CFG, [prompt], SamplingParams(max_new_tokens=n),
                    **ENGINE_KW)[0]


def _post(base, path, body, timeout=120):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _events(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode())
    out = []
    with urllib.request.urlopen(req, timeout=120) as r:
        ctype = r.headers["Content-Type"]
        for raw in r:  # urllib de-chunks
            line = raw.decode().strip()
            if line.startswith("data: "):
                out.append(line[len("data: "):])
            elif line:
                out.append(json.loads(line))
    return ctype, out


def _status(base, path, body):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base, path, body, timeout=30)
    return ei.value.code, json.loads(ei.value.read())


def test_health_models_and_stats(served, params):
    """/health, /v1/models and /stats (latency percentiles after a request
    finished) on each server."""
    base = served
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
        assert json.loads(r.read())["data"][0]["id"] == "qqq-tpu"
    _post(base, "/generate", {"prompt_tokens": [5, 6, 7],
                              "max_new_tokens": 4})
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        st = json.loads(r.read())
    assert st["max_batch"] == 2 and st["prefills"] >= 1
    assert st["requests"] >= 1 and st["ttft_p50_s"] > 0
    assert st["tpot_p50_s"] > 0


def test_concurrent_generate_matches_direct(served, params):
    """3 concurrent requests onto 2 slots: continuous admission over HTTP,
    each equal to direct generation."""
    base = served
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)]
               for n in (7, 12, 3)]
    want = generate(params, CFG, prompts, SamplingParams(max_new_tokens=5),
                    **ENGINE_KW)
    results = [None] * 3

    def go(i):
        results[i] = _post(base, "/generate", {"prompt_tokens": prompts[i],
                                               "max_new_tokens": 5})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert [r["output_tokens"] for r in results] == want
    assert all(r["num_generated"] == 5 for r in results)


def test_bad_requests(served_tok):
    base = served_tok
    for path, payload, want_err in [
        ("/generate", {}, "need prompt"),
        ("/generate", {"prompt_tokens": []}, "non-empty"),
        ("/generate", {"prompt_tokens": list(range(999))}, "exceeds"),
        ("/v1/completions", {"prompt": [1, 2], "min_p": 1.5}, "min_p"),
        ("/v1/completions", {"prompt": [1, 2], "logprobs": 99},
         "top_logprobs"),
        ("/v1/completions", {"prompt": [1, 2], "guided_choice": [[]]},
         "guided_choice"),
        ("/v1/completions", {"prompt": [1, 2], "logit_bias": {"5": -1000}},
         "logit_bias"),
        ("/v1/completions", {"prompt": [1, 2], "logit_bias": {"999": 1}},
         "out of range"),
        ("/v1/completions", {"prompt": [1, 2], "n": 3, "best_of": 2},
         "best_of"),
        ("/v1/completions", {"prompt": [1, 2], "n": 2, "stream": True},
         "streaming"),
        ("/v1/chat/completions", {"messages": [{"role": "user",
                                                "content": "1"}]},
         "chat template"),
        ("/nowhere", {}, "not found"),
    ]:
        code, body = _status(base, path, payload)
        assert code == (404 if path == "/nowhere" else 400), path
        assert want_err in body["error"], (path, body)


def test_no_tokenizer_serves_token_ids_only(servers):
    base = servers["ids"]
    code, body = _status(base, "/generate", {"prompt": "1 2"})
    assert code == 400 and "no tokenizer" in body["error"]
    code, body = _status(base, "/generate", {"prompt_tokens": [1],
                                             "stop": "x"})
    assert code == 400 and "stop strings" in body["error"]


def test_streams_equal_non_streamed(served_tok, params):
    """NDJSON on /generate and SSE on /v1/completions carry the tokens and
    text of the non-streamed reply, then a final frame."""
    base = served_tok
    prompt = [9, 41, 77, 3, 120, 8]
    plain = _post(base, "/generate", {"prompt_tokens": prompt,
                                      "max_new_tokens": 6})
    assert plain["output_tokens"] == _want(params, prompt, 6)
    ctype, lines = _events(base, "/generate", {
        "prompt_tokens": prompt, "max_new_tokens": 6, "stream": True})
    assert ctype == "application/x-ndjson"
    assert lines[-1]["done"] is True
    assert [ln["token"] for ln in lines[:-1]] == plain["output_tokens"]
    body = {"prompt": prompt, "max_tokens": 6, "temperature": 0.0}
    whole = _post(base, "/v1/completions", body)
    ctype, events = _events(base, "/v1/completions",
                            {**body, "stream": True})
    assert ctype == "text/event-stream" and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert "".join(c["choices"][0]["text"] for c in chunks[:-1]) == \
        whole["choices"][0]["text"] == _ToyTokenizer().decode(
            plain["output_tokens"])
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"


def test_completions_n_best_of_and_logprobs(served_tok, params):
    """OpenAI framing and usage; ``n`` fans out (greedy ⇒ identical
    choices), ``best_of`` counts every candidate's tokens; integer
    ``logprobs`` gives top-N whose best entry is the greedy token's."""
    base = served_tok
    prompt = [3, 14, 15, 92, 65, 35]
    want = _want(params, prompt, 4)
    text = _ToyTokenizer().decode(want)
    res = _post(base, "/v1/completions", {
        "prompt": prompt, "max_tokens": 4, "temperature": 0.0, "n": 2,
        "logprobs": 3})
    assert res["object"] == "text_completion"
    assert [c["index"] for c in res["choices"]] == [0, 1]
    assert all(c["text"] == text for c in res["choices"])
    assert res["usage"] == {"prompt_tokens": 6, "completion_tokens": 8,
                            "total_tokens": 14}
    lp = res["choices"][0]["logprobs"]
    assert lp["tokens"] == want and len(lp["top_logprobs"]) == 4
    for pos, chosen in zip(lp["top_logprobs"], lp["token_logprobs"]):
        assert len(pos) == 3 and abs(max(pos.values()) - chosen) < 1e-5
    res = _post(base, "/v1/completions", {
        "prompt": prompt, "max_tokens": 4, "temperature": 0.0, "n": 1,
        "best_of": 3})
    assert len(res["choices"]) == 1 and res["choices"][0]["text"] == text
    assert res["usage"]["completion_tokens"] == 12


def test_echo_and_prompt_scoring(served_tok, params):
    """``echo`` + ``max_tokens=0`` scores the prompt (None first) as a
    naive log_softmax forward does; echo with tokens prepends the prompt;
    plain ``max_tokens=0`` is an empty completion."""
    base = served_tok
    prompt = [11, 22, 33, 44, 55, 66]
    logits, _ = forward(params, CFG, torch.tensor([prompt]))
    lsm = torch.log_softmax(logits[0], dim=-1)
    want = [float(lsm[i - 1, prompt[i]]) for i in range(1, len(prompt))]
    res = _post(base, "/v1/completions", {
        "prompt": prompt, "max_tokens": 0, "echo": True, "logprobs": 1})
    lp = res["choices"][0]["logprobs"]
    assert lp["tokens"] == prompt and lp["token_logprobs"][0] is None
    np.testing.assert_allclose(lp["token_logprobs"][1:], want, rtol=1e-4,
                               atol=1e-4)
    assert res["usage"]["completion_tokens"] == 0
    res = _post(base, "/v1/completions", {
        "prompt": prompt, "max_tokens": 3, "temperature": 0.0, "echo": True,
        "logprobs": 1})
    lp = res["choices"][0]["logprobs"]
    assert lp["tokens"] == prompt + _want(params, prompt, 3)
    assert len(lp["token_logprobs"]) == len(prompt) + 3
    assert res["choices"][0]["text"].startswith(
        _ToyTokenizer().decode(prompt))
    res = _post(base, "/v1/completions", {"prompt": prompt, "max_tokens": 0})
    assert res["choices"][0]["text"] == ""
    code, body = _status(base, "/v1/completions", {
        "prompt": list(range(40)), "max_tokens": 0, "echo": True})
    assert code == 400


def test_guided_choice_logit_bias_and_seed(served_tok, params):
    """Over the wire: guided choice gives one candidate, ``logit_bias``
    −100 bans the greedy first token on both endpoints, penalties change
    the stream, explicit nulls mean defaults, a seeded sampled request
    repeats, and a stop string truncates the text."""
    base = served_tok
    prompt = [7, 70, 17, 107, 27, 72]
    plain = _want(params, prompt, 5)
    choices = [[(plain[0] + 1) % 128, 7], [(plain[0] + 2) % 128]]
    res = _post(base, "/generate", {
        "prompt_tokens": prompt, "max_new_tokens": 8, "guided_choice":
        choices})
    assert res["output_tokens"] in choices
    bias = {str(plain[0]): -100}
    res = _post(base, "/generate", {
        "prompt_tokens": prompt, "max_new_tokens": 5, "logit_bias": bias})
    assert plain[0] not in res["output_tokens"]
    res = _post(base, "/v1/completions", {
        "prompt": prompt, "max_tokens": 5, "temperature": 0.0,
        "logit_bias": bias, "logprobs": 1})
    assert plain[0] not in res["choices"][0]["logprobs"]["tokens"]
    res = _post(base, "/generate", {
        "prompt_tokens": prompt, "max_new_tokens": 5,
        "presence_penalty": 5.0, "repetition_penalty": 2.0,
        "temperature": None, "top_p": None, "seed": None})
    assert res["num_generated"] == 5
    body = {"prompt_tokens": prompt, "max_new_tokens": 5,
            "temperature": 0.9, "seed": 42}
    assert _post(base, "/generate", body) == _post(base, "/generate", body)
    stop = f" {plain[3]} "
    res = _post(base, "/generate", {
        "prompt_tokens": prompt, "max_new_tokens": 8, "stop": stop})
    full = _ToyTokenizer().decode(_want(params, prompt, 8))
    assert res["text"] == full[:full.find(stop)]


def test_chat_completions(servers, params):
    """``/v1/chat/completions`` through the chat template: message, ``n``,
    and the delta stream."""
    base = servers["chat"]
    msgs = [{"role": "user", "content": "12 34 56 78"}]
    prompt = _ChatToyTokenizer().apply_chat_template(msgs)
    text = _ToyTokenizer().decode(_want(params, prompt, 4))
    res = _post(base, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 4, "temperature": 0.0, "n": 2,
        "tools": [], "tool_choice": "none"})
    assert res["object"] == "chat.completion"
    assert [c["message"]["content"] for c in res["choices"]] == [text] * 2
    assert res["usage"]["prompt_tokens"] == len(prompt)
    _, events = _events(base, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 4, "temperature": 0.0,
        "stream": True})
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks) == text
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A toy g128 checkpoint written by the port, and its params."""
    cfg = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128)
    dense = init_params(cfg, torch.Generator().manual_seed(1),
                        dtype=torch.float32, device="cpu")
    packed = quantize_params_rtn(dense, cfg, group_size=128)
    path = tmp_path_factory.mktemp("ckpt")
    save_quantized(str(path), packed, cfg,
                   {"quant_method": "qqq", "wbits": 4, "group_size": 128})
    return str(path), packed, cfg


def test_generate_cli_on_a_checkpoint(checkpoint, capsys):
    """``cli/generate --prompt_tokens --device cpu`` on a saved checkpoint
    prints what direct generation on the saved params gives."""
    path, packed, cfg = checkpoint
    outs = gen_cli.main(["--model_path", path, "--device", "cpu",
                         "--dtype", "float32", "--max_length", "64",
                         "--max_new_tokens", "5", "--prompt_tokens",
                         "1,2,3,4", "--prompt_tokens", "9,8"])
    want = generate(packed, cfg, [[1, 2, 3, 4], [9, 8]],
                    SamplingParams(max_new_tokens=5), max_batch=2,
                    max_len=64, dtype=torch.float32, device="cpu")
    assert outs == want
    assert str(want[1]) in capsys.readouterr().out


def test_serve_cli_builds_engine_and_refuses_unported(checkpoint):
    """``cli/serve``'s flags build the Engine on a checkpoint, the
    scheduler features' flags included (chunked prefill in slot mode, the
    prefix cache, speculative decoding), and the engine they build serves;
    the default device, the card, raises without one."""
    path, _, _ = checkpoint
    base = ["--model_path", path, "--device", "cpu", "--dtype", "float32",
            "--max_length", "64"]
    eng = build_engine(parse_args(base + ["--paged", "--block_size", "8"]))
    assert eng.paged and eng.prefill_chunk == 64
    for extra, want in (
            (["--spec_ngram", "2", "--spec_k", "3"],
             dict(spec_ngram=2, spec_k=3, prefill_chunk=0)),
            (["--prefix_cache", "--paged", "--block_size", "8"],
             dict(prefix_cache=True, paged=True, prefill_chunk=64)),
            (["--prefill_chunk", "32", "--prefix_cache"],
             dict(prefix_cache=True, paged=False, prefill_chunk=32))):
        eng = build_engine(parse_args(base + extra))
        for k, v in want.items():
            assert getattr(eng, k) == v, (extra, k)
        req = Request([1, 2, 3, 1, 2, 3], SamplingParams(max_new_tokens=3))
        eng.run([req])
        assert req.done and len(req.output_tokens) == 3, extra
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_engine(parse_args(["--model_path", path]))


def test_worker_inbox_under_thread_stress(params):
    """More submitting threads than cores, the interpreter switching
    threads every microsecond: every request submitted and every scoring
    call made through the worker completes exactly once, on the worker's
    thread, with the tokens and scores of a single-threaded run."""
    prompts = [[i + 1, 2 * i + 3, 5] for i in range(12)]
    want = generate(params, CFG, prompts, SamplingParams(max_new_tokens=2),
                    **ENGINE_KW)
    eng = Engine(params, CFG, **ENGINE_KW)
    score_want = eng.score_prompt([7, 8, 9, 10])
    worker = EngineWorker(eng)
    reqs = [Request(p, SamplingParams(max_new_tokens=2)) for p in prompts]
    scores = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def go(i):
            for r in reqs[i::12]:
                worker.submit(r)
            scores.append(worker.score_prompt([7, 8, 9, 10], timeout=60))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for r in reqs:
            worker.wait(r, timeout=60)
    finally:
        sys.setswitchinterval(old)
        worker.stop()
    assert worker.error is None
    assert [r.output_tokens for r in reqs] == want
    assert eng.stats["prefills"] == len(reqs)
    assert scores == [score_want] * 12
