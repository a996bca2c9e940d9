"""HTTP serving front end: an OpenAI-style completions API over the Engine.

Counterpart of `cxl_speckv_tpu/server.py`, the same routes, bodies and
semantics. A continuous-batching loop thread drives `Engine.step()` while
HTTP handler threads submit requests and wait on per-request events, so
concurrent clients batch together in the engine exactly as `add_request`
callers do. Standard library only (`http.server`).

Endpoints:

- `POST /v1/completions` (and `/generate`): body `{"prompt": [token ids]
  | "text", "max_tokens": N, "temperature": t, "top_p": p, "stream": bool,
  "n": choices, "stop": "str" | ["strs"], "stop_token_ids": [ids],
  "stop_sequences": [[ids]], "ignore_eos": bool, "logprobs": k,
  "prompt_logprobs": bool, "frequency_penalty": f, "presence_penalty": f,
  "repetition_penalty": f}` (penalties: OpenAI semantics for frequency /
  presence, HF / vLLM for repetition). A client that disconnects
  mid-stream cancels its request (the engine stops generating and frees
  its KV). String prompts and string `stop` entries need the server to be
  built with a tokenizer (`encode` / `decode`, e.g. an HF tokenizer).
  Matched stop sequences are excluded from the returned tokens (OpenAI
  semantics); stop token ids finish like EOS. With `"stream": true` the
  response is SSE: one `data: {"tokens": [...]}` chunk per new-token
  group, then `data: [DONE]`.
- `POST /v1/chat/completions`: OpenAI chat schema, `{"messages": [{"role",
  "content"}, ...], ...}` templated through the tokenizer
  (`apply_chat_template` when it has one, a role-tagged transcript
  otherwise); responds with `chat.completion` / `chat.completion.chunk`
  delta SSE.
- `GET /v1/stats`: `Engine.get_statistics()` as JSON; `GET /metrics`: its
  numeric leaves as Prometheus gauges; `GET /health`: liveness.

Threads. Only the loop thread calls into the engine (under the loop's
lock, submissions from handler threads included), so every kernel launches
from one thread, on its current stream, as `Engine.run` launches them.
Handler threads read host lists only (`tokens_so_far`) and the statistics
as plain Python values (`ServingLoop.stats`), never a device tensor. One
departure from the JAX server: the loop yields the interpreter between
steps, so a handler waiting for the lock submits before the next step
instead of after the batch drains (concurrent clients batch as
`add_request` callers do).
"""

from __future__ import annotations

import json
import numbers
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from cxl_speckv_tpu_torch.engine.engine import Engine, EngineOutput


def plain(obj):
    """`obj` with every leaf a JSON value: a numpy or torch scalar becomes
    the Python number it holds (`.item()`), tuples become lists; any other
    leaf raises TypeError (a 500, not a silently dropped gauge)."""
    if isinstance(obj, dict):
        return {str(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, numbers.Number) or (
            hasattr(obj, "item") and getattr(obj, "ndim", None) == 0):
        return obj.item()
    raise TypeError(f"statistics leaf of type {type(obj).__name__}")


class ServingLoop:
    """Background thread that steps the engine while work exists.

    The engine is single-threaded by design; every engine call happens
    under one lock (submissions from handler threads included), so HTTP
    concurrency becomes engine-level continuous batching."""

    def __init__(self, engine: Engine, idle_poll_s: float = 0.02):
        self.engine = engine
        self._cv = threading.Condition()
        self._done: dict[int, EngineOutput] = {}
        self._events: dict[int, threading.Event] = {}
        self._aborts: set[int] = set()
        self._stop = False
        self._idle_poll_s = idle_poll_s
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="speckv-serving-loop")
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def submit(self, prompt, max_new_tokens: int, temperature: float,
               top_p: float, stop_token_ids=None,
               stop_sequences=None, ignore_eos: bool = False,
               logprobs: int = 0,
               prompt_logprobs: bool = False,
               frequency_penalty: float = 0.0,
               presence_penalty: float = 0.0,
               repetition_penalty: float = 0.0) -> tuple[int, threading.Event]:
        with self._cv:
            rid = self.engine.add_request(
                prompt, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p,
                stop_token_ids=stop_token_ids,
                stop_sequences=stop_sequences,
                ignore_eos=ignore_eos, logprobs=logprobs,
                prompt_logprobs=prompt_logprobs,
                frequency_penalty=frequency_penalty,
                presence_penalty=presence_penalty,
                repetition_penalty=repetition_penalty)
            ev = threading.Event()
            self._events[rid] = ev
            self._cv.notify()
        return rid, ev

    def cancel(self, rid: int) -> None:
        """Abort a request (client went away). Lock-free: sets a flag the
        loop thread drains before its next step; taking the loop lock here
        could convoy behind a continuously stepping loop."""
        self._aborts.add(rid)

    def tokens_so_far(self, rid: int) -> tuple[int, list[int]]:
        # lock-free snapshot of host lists: the loop thread only ever
        # APPENDS to req.output between restarts, and list() under the GIL
        # yields a consistent prefix; taking the loop lock here would starve
        # streaming handlers while the loop steps continuously. The restart
        # counter is read FIRST: if it moved by the time the caller
        # compares, the caller re-snapshots next poll, so a preempted
        # request (whose output was cleared and regenerates, possibly
        # differently at temperature > 0) never splices two generations
        # into one stream.
        req = self.engine._requests.get(rid)
        if req is None:
            return 0, []
        return req.restarts, list(req.output)

    def result(self, rid: int, ev: threading.Event,
               timeout: float | None = None) -> EngineOutput | None:
        if not ev.wait(timeout):
            return None
        with self._cv:
            return self._done.pop(rid)

    def stats(self) -> dict:
        with self._cv:
            return plain(self.engine.get_statistics())

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=10)

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
                while self._aborts:
                    rid = self._aborts.pop()
                    self.engine.cancel(rid)
                    self._events.pop(rid, None)
                    self._done.pop(rid, None)
                if not self.engine.has_work:
                    self._cv.wait(self._idle_poll_s)
                    continue
                outs = self.engine.step()
                for o in outs:
                    self._done[o.req_id] = o
                    ev = self._events.pop(o.req_id, None)
                    if ev is not None:
                        ev.set()
            # hand the interpreter to a thread waiting for the lock: the lock
            # is not fair, and without the yield this thread takes it again
            # before a submitter wakes, so concurrent requests join the batch
            # late or one at a time
            time.sleep(0)


class _Handler(BaseHTTPRequestHandler):
    # set by SpeckvServer; class-level so ThreadingHTTPServer handler
    # instances (one per connection) share them
    loop: ServingLoop = None
    tokenizer = None            # object with .encode(str) / .decode(list)
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet by default; stats carry the signal
        pass

    # -- helpers -------------------------------------------------------------

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str) -> None:
        self._json(code, {"error": {"message": msg, "code": code}})

    # -- routes --------------------------------------------------------------

    def do_GET(self):
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/v1/stats":
            self._json(200, self.loop.stats())
        elif self.path == "/metrics":
            # Prometheus text exposition: every numeric leaf of the
            # engine's statistics tree as a gauge, dots -> underscores
            lines = []

            def walk(prefix, obj):
                if isinstance(obj, dict):
                    for k, v in obj.items():
                        k = (str(k).replace(".", "_").replace("-", "_")
                             .replace(" ", "_").replace("/", "_"))
                        walk(f"{prefix}_{k}", v)
                elif isinstance(obj, bool):
                    lines.append(f"{prefix} {int(obj)}")
                elif isinstance(obj, (int, float)):
                    lines.append(f"{prefix} {obj}")

            walk("speckv", self.loop.stats())
            body = "\n".join(lines).encode() + b"\n"
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._error(404, f"unknown path {self.path}")

    def do_POST(self):
        chat = self.path == "/v1/chat/completions"
        if not chat and self.path not in ("/v1/completions", "/generate"):
            self._error(404, f"unknown path {self.path}")
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if chat:
                prompt = self._chat_prompt(body.get("messages"))
            else:
                prompt = body.get("prompt")
                if isinstance(prompt, str):
                    if self.tokenizer is None:
                        raise ValueError("string prompts need a tokenizer; "
                                         "send token ids")
                    prompt = list(self.tokenizer.encode(prompt))
            if not isinstance(prompt, list) or not prompt:
                raise ValueError("prompt must be a non-empty token-id list")
            max_tokens = int(body.get("max_tokens", 64))
            temperature = float(body.get("temperature", 0.0))
            top_p = float(body.get("top_p", 1.0))
            stream = bool(body.get("stream", False))
            n = int(body.get("n", 1))
            if not 1 <= n <= 8:
                raise ValueError("n must be in [1, 8]")
            if n > 1 and stream:
                raise ValueError("n > 1 does not stream (one SSE body "
                                 "multiplexing choices is not supported)")
            if n > 1 and temperature <= 0.0:
                raise ValueError("n > 1 needs temperature > 0 (greedy "
                                 "choices would be identical)")
            ignore_eos = bool(body.get("ignore_eos", False))
            logprobs = int(body.get("logprobs") or 0)
            prompt_logprobs = bool(body.get("prompt_logprobs", False))
            # OpenAI sampling penalties + the HF/vLLM repetition extension
            frequency_penalty = float(body.get("frequency_penalty", 0.0))
            presence_penalty = float(body.get("presence_penalty", 0.0))
            repetition_penalty = float(body.get("repetition_penalty", 0.0))
            stop_token_ids = body.get("stop_token_ids") or []
            # OpenAI "stop": string or list of strings, excluded from the
            # returned text; needs the tokenizer to become token sequences.
            # Token-id clients can send "stop_sequences" (lists of ids)
            stop_sequences = [list(s) for s in body.get("stop_sequences") or []]
            stop = body.get("stop")
            if stop is not None:
                if isinstance(stop, str):
                    stop = [stop]
                if self.tokenizer is None:
                    raise ValueError("string stop sequences need a "
                                     "tokenizer; send stop_sequences ids")
                stop_sequences += [list(self.tokenizer.encode(s))
                                   for s in stop]
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._error(400, str(e))
            return

        try:
            subs = [self.loop.submit(prompt, max_tokens, temperature, top_p,
                                     stop_token_ids=stop_token_ids,
                                     stop_sequences=stop_sequences,
                                     ignore_eos=ignore_eos,
                                     logprobs=logprobs,
                                     prompt_logprobs=prompt_logprobs,
                                     frequency_penalty=frequency_penalty,
                                     presence_penalty=presence_penalty,
                                     repetition_penalty=repetition_penalty)
                    for _ in range(n)]
            rid, ev = subs[0]
        except ValueError as e:   # over capacity etc.: the engine's checks
            self._error(400, str(e))
            return
        if n > 1:
            # the n choices batch together in the engine like any other
            # concurrent requests; each request draws its own samples
            outs = [self.loop.result(r, e, timeout=600) for r, e in subs]
            if any(o is None for o in outs):
                self._error(504, "generation timed out")
                return
            if chat:
                merged = self._chat_payload(outs[0])
                merged["choices"] = [
                    {**self._chat_payload(o)["choices"][0], "index": i}
                    for i, o in enumerate(outs)]
            else:
                merged = {"id": f"cmpl-{outs[0].req_id}",
                          "object": "completion",
                          "choices": [{**self._payload(o), "index": i}
                                      for i, o in enumerate(outs)]}
            self._json(200, merged)
            return
        if stream:
            # a matched stop sequence is trimmed from the final result, so
            # interim SSE chunks hold back the longest possible match (the
            # engine records the stop-completing token BEFORE the done event
            # is set, so a max(len) - 1 holdback could emit the match's
            # first token in that window, a token the trimmed result
            # retracts); the withheld tokens flush from the final result
            holdback = max((len(s) for s in stop_sequences), default=0)
            self._stream(rid, ev, holdback=holdback, chat=chat)
        else:
            out = self.loop.result(rid, ev, timeout=600)
            if out is None:
                self._error(504, "generation timed out")
                return
            self._json(200, self._chat_payload(out) if chat
                       else self._payload(out))

    def _chat_prompt(self, messages) -> list[int]:
        """OpenAI chat messages -> prompt token ids, through the
        tokenizer's chat template when it has one (HF tokenizers:
        `apply_chat_template`), else a plain role-tagged transcript with a
        generation prompt."""
        if self.tokenizer is None:
            raise ValueError("chat completions need a tokenizer")
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m or "content" not in m:
                raise ValueError("each message needs role and content")
        if hasattr(self.tokenizer, "apply_chat_template"):
            return list(self.tokenizer.apply_chat_template(
                messages, add_generation_prompt=True))
        text = "".join(f"{m['role']}: {m['content']}\n" for m in messages)
        return list(self.tokenizer.encode(text + "assistant:"))

    def _chat_payload(self, out: EngineOutput) -> dict:
        d = {"id": f"chatcmpl-{out.req_id}", "object": "chat.completion",
             "choices": [{
                 "index": 0,
                 "message": {"role": "assistant",
                             "content": self.tokenizer.decode(out.tokens)},
                 "finish_reason": out.finish_reason,
             }],
             "usage": {"completion_tokens": len(out.tokens)},
             "tokens": out.tokens,
             "ttft_ms": out.ttft_ms, "tpot_ms": out.tpot_ms}
        if out.logprobs is not None:
            d["choices"][0]["logprobs"] = {
                "token_logprobs": [e["logprob"] for e in out.logprobs]}
        return d

    def _payload(self, out: EngineOutput) -> dict:
        d = {"id": f"cmpl-{out.req_id}", "object": "completion",
             "tokens": out.tokens, "finish_reason": out.finish_reason,
             "usage": {"completion_tokens": len(out.tokens)},
             "ttft_ms": out.ttft_ms, "tpot_ms": out.tpot_ms}
        if out.logprobs is not None:
            d["logprobs"] = {
                "token_logprobs": [e["logprob"] for e in out.logprobs],
                "top_ids": [e["top_ids"] for e in out.logprobs],
                "top_logprobs": [e["top_logprobs"] for e in out.logprobs],
            }
        if out.prompt_logprobs is not None:
            d["prompt_logprobs"] = out.prompt_logprobs
        if self.tokenizer is not None:
            d["text"] = self.tokenizer.decode(out.tokens)
        return d

    def _stream(self, rid: int, ev: threading.Event,
                holdback: int = 0, chat: bool = False) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        # SSE has no fixed length; close delimits the body
        self.send_header("Connection", "close")
        self.end_headers()
        sent = 0
        gen = 0   # restart counter of the prefix sent so far
        deadline = time.monotonic() + 600
        try:
            while time.monotonic() < deadline:
                done = ev.wait(0.02)
                # active disconnect probe: an SSE client never sends more
                # data on this connection (the response is Connection:
                # close), so a readable socket returning EOF means it went
                # away; detect it now instead of waiting for a write to fail
                r, _, _ = select.select([self.connection], [], [], 0)
                if r and not self.connection.recv(1, socket.MSG_PEEK):
                    raise BrokenPipeError
                g, toks = self.loop.tokens_so_far(rid)
                if g != gen:
                    # preemption restarted generation: tell the client to
                    # discard everything received and resend from scratch
                    # (at temperature > 0 the regenerated tokens differ)
                    if sent:
                        self.wfile.write(b'data: {"restart": true}\n\n')
                        self.wfile.flush()
                    sent, gen = 0, g
                if holdback and not done:
                    toks = toks[: max(0, len(toks) - holdback)]
                if done:
                    # the finished request may already be retired from the
                    # engine's table; the authoritative output is the result
                    out = self.loop.result(rid, ev)
                    toks = out.tokens
                    if len(toks) < sent:  # a restart raced the done event
                        self.wfile.write(b'data: {"restart": true}\n\n')
                        self.wfile.flush()
                        sent = 0
                if len(toks) > sent:
                    if chat:
                        # OpenAI chat.completion.chunk delta format
                        chunk = {"object": "chat.completion.chunk",
                                 "choices": [{"index": 0, "delta": {
                                     "content": self.tokenizer.decode(
                                         toks[sent:])}}],
                                 "tokens": toks[sent:]}
                    else:
                        chunk = {"tokens": toks[sent:]}
                        if self.tokenizer is not None:
                            chunk["text"] = self.tokenizer.decode(toks[sent:])
                    self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                    self.wfile.flush()
                    sent = len(toks)
                if done:
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                    return
            self.wfile.write(b"data: [TIMEOUT]\n\n")
        except (BrokenPipeError, ConnectionResetError):
            # the client went away mid-stream: withdraw the request so the
            # engine stops generating (and frees its KV) instead of
            # finishing a reply nobody reads
            self.loop.cancel(rid)


class SpeckvServer:
    """Owns the HTTP server and the serving loop. `port=0` picks a free
    port (read it back from `.port`)."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8000, tokenizer=None):
        self.loop = ServingLoop(engine)
        handler = type("BoundHandler", (_Handler,),
                       {"loop": self.loop, "tokenizer": tokenizer})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="speckv-http")

    def start(self) -> None:
        self._thread.start()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.loop.stop()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
