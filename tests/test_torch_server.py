"""The port's HTTP front end (`cxl_speckv_tpu_torch/server.py`) on the CPU.

Every case of `tests/test_server.py` runs here against the port's server:
health and statistics, Prometheus metrics, concurrent completions equal to
the engine API's, SSE chunks concatenating to the non-streamed result, a
sampled completion, the 400 / 404 refusals, string prompts through a
tokenizer, chat completions (templated and streamed) and `n` choices.
Added:

- parity: greedy completions from the port's server on `tiny_test_config()`
  at float32 attention compute are token-identical to the JAX package's
  server (reference attention, `use_pallas=False`) on the same weights
  (`params_from_jax`), non-streamed, streamed and concurrent;
- `/v1/stats` round-trips through `json.loads`, holds only JSON values, and
  every `/metrics` line parses;
- a string `stop` streamed (the holdback path) equals it non-streamed;
- logprobs, prompt logprobs and a penalty over HTTP;
- a client that disconnects mid-stream cancels its request, and the free
  HBM and host block counts return to their values before it;
- the loop thread is alive after every case.

Most cases share one port server and the parity case one JAX server, as
`tests/test_server.py`'s share one; a case that needs another server (no
tokenizer, a tokenizer without a chat template) builds it on an engine of
its own, since one serving loop at a time steps an engine.
"""

import http.client
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
from test_torch_engine import JPARAMS, PARAMS
from torch_surface import F32, JAX, JF32, system

from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.server import SpeckvServer as JServer
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.server import SpeckvServer, plain

SERVE = dict(hbm=64, host=64, batch=4, horizon=2, seq=128, chunk=32)
TIMEOUT = 120


def make_engine():
    return Engine(F32, system(**SERVE), params=PARAMS, device="cpu", seed=0,
                  enable_lstm=False)


def make_jax_engine():
    return JEngine(JF32, system(JAX, **SERVE), params=JPARAMS,
                   use_pallas=False, enable_lstm=False, seed=0)


class Tok:
    """A toy tokenizer whose decode inverts encode on every model id (ids
    map to characters past U+10000), so a string `stop` taken from decoded
    output encodes back to the same ids; other text maps to ids 1-250."""

    def encode(self, s):
        return [ord(c) - 0x10000 if ord(c) >= 0x10000 else ord(c) % 250 + 1
                for c in s]

    def decode(self, ids):
        return "".join(chr(0x10000 + i) for i in ids)


class ChatTok(Tok):
    def apply_chat_template(self, messages, add_generation_prompt=False):
        text = "".join(f"<{m['role']}>{m['content']}" for m in messages)
        return self.encode(text + ("<assistant>" if add_generation_prompt
                                   else ""))


def post(port, path, body, timeout=TIMEOUT):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


def stream(port, body, path="/v1/completions"):
    """POST with "stream": true; returns (tokens concatenated, [DONE] seen,
    the Content-Type)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    toks, done = [], False
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        ctype = r.headers["Content-Type"]
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                done = True
                break
            toks.extend(json.loads(payload)["tokens"])
    return toks, done, ctype


def prompts(n=3, seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, F32.vocab_size, rng.randint(6, 18)).tolist()
            for _ in range(n)]


def concurrently(fn, n):
    results = [None] * n

    def go(i):
        results[i] = fn(i)
    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    return results


@pytest.fixture(scope="module")
def port_engine():
    return make_engine()


@pytest.fixture(scope="module")
def server(port_engine):
    with SpeckvServer(port_engine, port=0, tokenizer=ChatTok()) as srv:
        yield srv


@pytest.fixture(scope="module")
def jax_server():
    with JServer(make_jax_engine(), port=0) as srv:
        yield srv


@pytest.fixture(autouse=True)
def loop_alive(request):
    yield
    if "server" in request.fixturenames:
        assert request.getfixturevalue("server").loop.alive


# -- the cases of tests/test_server.py ------------------------------------------

def test_health_and_stats(server):
    assert get(server.port, "/health") == (200, {"status": "ok"})
    code, stats = get(server.port, "/v1/stats")
    assert code == 200 and "directory" in stats and "engine" in stats


def test_prometheus_metrics(server):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=30) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    lines = [ln for ln in body.strip().splitlines() if ln]
    assert any(ln.startswith("speckv_engine_steps ") for ln in lines)
    assert any(ln.startswith("speckv_directory_hit_rate ") for ln in lines)
    for ln in lines:  # every line is "<name> <number>"
        name, val = ln.rsplit(" ", 1)
        assert " " not in name and "-" not in name
        float(val)


def test_completion_matches_engine_api(server):
    ps = prompts()
    want = make_engine().generate(ps, max_new_tokens=8)
    # concurrent clients -> continuous batching in the engine
    results = concurrently(lambda i: post(server.port, "/v1/completions",
                                          {"prompt": ps[i], "max_tokens": 8}),
                           len(ps))
    for i, (code, body) in enumerate(results):
        assert code == 200, body
        assert body["tokens"] == want[i]
        assert body["finish_reason"] == "length"
        assert body["usage"]["completion_tokens"] == 8


def test_streaming_concatenates_to_full_result(server):
    p = prompts(1, seed=23)[0]
    _, full = post(server.port, "/v1/completions",
                   {"prompt": p, "max_tokens": 8})
    toks, done, ctype = stream(server.port, {"prompt": p, "max_tokens": 8})
    assert ctype == "text/event-stream"
    assert done
    assert toks == full["tokens"]


def test_sampled_completion(server):
    p = prompts(1, seed=31)[0]
    code, body = post(server.port, "/v1/completions",
                      {"prompt": p, "max_tokens": 8, "temperature": 0.8,
                       "top_p": 0.9})
    assert code == 200 and len(body["tokens"]) == 8


def test_bad_requests():
    with SpeckvServer(make_engine(), port=0) as srv:     # no tokenizer
        code, body = post(srv.port, "/v1/completions", {"prompt": []})
        assert code == 400 and "error" in body
        code, body = post(srv.port, "/v1/completions", {"prompt": "text"})
        assert code == 400
        code, body = post(srv.port, "/v1/completions",
                          {"prompt": [1, 2, 3], "max_tokens": 100000})
        assert code == 400  # beyond max_seq_len and streaming capacity
        code, body = post(srv.port, "/v1/completions",
                          {"prompt": [1, 2], "stop": "x"})
        assert code == 400  # string stops need the tokenizer
        code, body = post(srv.port, "/nope", {})
        assert code == 404
        assert srv.loop.alive


def test_tokenizer_round_trip(server):
    """String prompts work when a tokenizer is provided."""
    code, body = post(server.port, "/v1/completions",
                      {"prompt": "hello speckv", "max_tokens": 4})
    assert code == 200 and len(body["tokens"]) == 4
    assert body["text"] == Tok().decode(body["tokens"])


def test_chat_completions(server):
    """OpenAI chat endpoint: messages -> templated prompt -> assistant
    message; validation; no tokenizer -> a clean refusal."""
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}]
    code, body = post(server.port, "/v1/chat/completions",
                      {"messages": msgs, "max_tokens": 4})
    assert code == 200
    assert body["object"] == "chat.completion"
    ch = body["choices"][0]
    assert ch["message"]["role"] == "assistant"
    assert ch["message"]["content"] == Tok().decode(body["tokens"])
    assert ch["finish_reason"] in ("length", "eos")
    # the template's prompt, served through the engine API
    want = make_engine().generate(
        [ChatTok().apply_chat_template(msgs, add_generation_prompt=True)],
        max_new_tokens=4)[0]
    assert body["tokens"] == want
    code, _ = post(server.port, "/v1/chat/completions", {"messages": []})
    assert code == 400
    code, _ = post(server.port, "/v1/chat/completions",
                   {"messages": [{"role": "user"}]})
    assert code == 400
    with SpeckvServer(make_engine(), port=0) as srv:
        code, _ = post(srv.port, "/v1/chat/completions", {"messages": msgs})
        assert code == 400
        assert srv.loop.alive


def test_chat_transcript_without_template():
    """A tokenizer without `apply_chat_template`: the role-tagged
    transcript."""
    msgs = [{"role": "user", "content": "hello"}]
    with SpeckvServer(make_engine(), port=0, tokenizer=Tok()) as srv:
        code, body = post(srv.port, "/v1/chat/completions",
                          {"messages": msgs, "max_tokens": 3})
        assert code == 200 and srv.loop.alive
    want = make_engine().generate([Tok().encode("user: hello\nassistant:")],
                                  max_new_tokens=3)[0]
    assert body["tokens"] == want


def test_chat_stream_delta_chunks(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    conn.request("POST", "/v1/chat/completions",
                 json.dumps({"messages": [{"role": "user",
                                           "content": "hello"}],
                             "max_tokens": 5, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    raw = resp.read().decode()
    conn.close()
    chunks = [ln[6:] for ln in raw.splitlines()
              if ln.startswith("data: ") and ln != "data: [DONE]"]
    assert raw.strip().endswith("data: [DONE]")
    toks = []
    for c in chunks:
        d = json.loads(c)
        assert d["object"] == "chat.completion.chunk"
        assert d["choices"][0]["delta"]["content"] == Tok().decode(
            d["tokens"])
        toks += d["tokens"]
    assert len(toks) == 5


def test_n_choices(server):
    """OpenAI `n`: sampled completions batch in the engine and return as a
    choices list; invalid combinations are refused."""
    code, body = post(server.port, "/v1/completions",
                      {"prompt": [3, 5, 7, 9], "max_tokens": 6,
                       "temperature": 0.9, "n": 3})
    assert code == 200 and len(body["choices"]) == 3
    assert [c["index"] for c in body["choices"]] == [0, 1, 2]
    assert all(len(c["tokens"]) == 6 for c in body["choices"])
    # sampled choices should not all coincide on a 256-token vocabulary
    assert len({tuple(c["tokens"]) for c in body["choices"]}) > 1
    code, _ = post(server.port, "/v1/completions",
                   {"prompt": [1, 2], "n": 2})          # greedy n > 1
    assert code == 400
    code, _ = post(server.port, "/v1/completions",
                   {"prompt": [1, 2], "n": 2, "stream": True,
                    "temperature": 0.5})
    assert code == 400
    code, _ = post(server.port, "/v1/completions",
                   {"prompt": [1, 2], "n": 99, "temperature": 0.5})
    assert code == 400


# -- added for the port ----------------------------------------------------------

def test_greedy_completions_match_jax_server(server, jax_server):
    """The same prompts through both packages' servers, concurrently and
    one at a time, non-streamed and streamed: identical tokens."""
    ps = prompts(4, seed=41)
    body = lambda i: {"prompt": ps[i], "max_tokens": 10}
    got = concurrently(lambda i: post(server.port, "/v1/completions",
                                      body(i)), len(ps))
    want = concurrently(lambda i: post(jax_server.port, "/v1/completions",
                                       body(i)), len(ps))
    for (gc, g), (wc, w) in zip(got, want):
        assert gc == wc == 200
        assert g["tokens"] == w["tokens"]
        assert g["finish_reason"] == w["finish_reason"]
    for i in (0, 3):
        g, g_done, _ = stream(server.port, body(i))
        w, w_done, _ = stream(jax_server.port, body(i))
        assert g_done and w_done and g == w == want[i][1]["tokens"]


def test_stats_are_json_and_metrics_parse(server):
    post(server.port, "/v1/completions", {"prompt": [4, 5, 6],
                                          "max_tokens": 4})
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/v1/stats", timeout=30) as r:
        text = r.read().decode()
    stats = json.loads(text)
    assert stats == plain(stats)
    assert json.loads(json.dumps(stats)) == stats
    assert stats["engine"]["requests_finished"] > 0
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=30) as r:
        lines = r.read().decode().strip().splitlines()
    gauges = dict(ln.rsplit(" ", 1) for ln in lines)
    assert len(gauges) == len(lines)
    for v in gauges.values():
        float(v)
    assert float(gauges["speckv_hbm_free"]) == stats["hbm_free"]


def test_plain_holds_leaves_to_python_scalars():
    import torch

    got = plain({"a": np.int64(3), "b": np.float32(0.5), "c": torch.tensor(2),
                 "d": (1, np.bool_(True)), "e": None})
    assert got == {"a": 3, "b": 0.5, "c": 2, "d": [1, True], "e": None}
    assert type(got["a"]) is int and type(got["b"]) is float
    with pytest.raises(TypeError, match="ndarray"):
        plain({"x": np.zeros(3)})


def test_stop_string_streams_with_holdback(server):
    """A string `stop` that matches: non-streamed, the match is trimmed;
    streamed (interim chunks hold back the stop's length), the chunks
    concatenate to the same tokens."""
    p = prompts(1, seed=53)[0]
    _, full = post(server.port, "/v1/completions",
                   {"prompt": p, "max_tokens": 12})
    t = full["tokens"]
    stop_ids = t[5:7]
    j = next(i for i in range(len(t) - 1) if t[i:i + 2] == stop_ids)
    stop = Tok().decode(stop_ids)
    code, cut = post(server.port, "/v1/completions",
                     {"prompt": p, "max_tokens": 12, "stop": stop})
    assert code == 200
    assert cut["tokens"] == t[:j] and cut["finish_reason"] == "stop"
    toks, done, _ = stream(server.port, {"prompt": p, "max_tokens": 12,
                                         "stop": [stop]})
    assert done and toks == cut["tokens"]


def test_logprobs_prompt_logprobs_and_penalties(server):
    p = prompts(1, seed=61)[0]
    code, body = post(server.port, "/v1/completions",
                      {"prompt": p, "max_tokens": 5, "logprobs": 3,
                       "prompt_logprobs": True})
    assert code == 200
    lp = body["logprobs"]
    assert len(lp["token_logprobs"]) == 5
    assert all(isinstance(x, float) for x in lp["token_logprobs"])
    assert [ids[0] for ids in lp["top_ids"]] == body["tokens"]   # greedy
    assert all(len(ids) == 3 for ids in lp["top_ids"])
    pl = body["prompt_logprobs"]
    assert len(pl) == len(p) and pl[0] is None
    assert all(isinstance(x, float) for x in pl[1:])
    code, pen = post(server.port, "/v1/completions",
                     {"prompt": p, "max_tokens": 5,
                      "repetition_penalty": 1.3, "frequency_penalty": 0.5})
    assert code == 200 and len(pen["tokens"]) == 5


def test_disconnect_cancels_and_frees_blocks(server, port_engine):
    """A streaming client that goes away after the first chunk: its request
    is cancelled (not finished to its length) and the free block counts
    return. Each step is slowed by 10 ms, so 100 tokens at horizon 2 take
    half a second, far longer than the disconnect takes to detect (one
    20 ms poll)."""
    _, before = get(server.port, "/v1/stats")
    step = port_engine.step

    def slow_step():
        time.sleep(0.01)
        return step()
    port_engine.step = slow_step
    try:
        p = prompts(1, seed=71)[0]
        s = socket.create_connection(("127.0.0.1", server.port), timeout=30)
        body = json.dumps({"prompt": p, "max_tokens": 100, "stream": True,
                           "ignore_eos": True}).encode()
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = b""
        while b"data: " not in got:
            chunk = s.recv(4096)
            assert chunk, "the server closed before the first chunk"
            got += chunk
        s.close()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            req = next(r for r in reversed(port_engine._requests.values())
                       if r.prompt == p)
            if req.finish_reason:
                break
            time.sleep(0.02)
        assert req.finish_reason == "cancelled"
        assert len(req.output) < 100
        while time.monotonic() < deadline and port_engine.has_work:
            time.sleep(0.02)
    finally:
        port_engine.step = step
    _, after = get(server.port, "/v1/stats")
    assert after["hbm_free"] == before["hbm_free"]
    assert after["host_free"] == before["host_free"]


def test_concurrent_clients_join_one_batch(server, port_engine):
    """Eight clients posting at once are all live in the engine together
    (continuous batching), as eight `add_request` callers are: the loop
    yields the interpreter between steps, so a client waiting for its lock
    gets it (without the yield, the JAX server's loop takes its lock back
    first and requests join late or one at a time). Each step is slowed by
    5 ms, so a request of 100 tokens at horizon 2 lasts at least 250 ms."""
    live = []
    step = port_engine.step

    def counted_step():
        live.append(port_engine.scheduler.num_running
                    + port_engine.scheduler.num_waiting)
        time.sleep(0.005)
        return step()
    port_engine.step = counted_step
    try:
        ps = prompts(8, seed=83)
        results = concurrently(lambda i: post(
            server.port, "/v1/completions",
            {"prompt": ps[i], "max_tokens": 100, "ignore_eos": True}), 8)
    finally:
        port_engine.step = step
    assert all(code == 200 for code, _ in results)
    assert max(live) == 8
