"""HTTP serving of the port (counterpart of the JAX ``infer/server.py`` for
one engine on one card):

  GET  /healthz      -> 200 "ok" (also while a slot engine restarts);
                        503 {"status": "draining"} with Retry-After
                        during a drain; 503 {"status": "unhealthy",
                        "circuit_state", "error"} once a slot engine's
                        circuit opened or a fatal failure ended it
  POST /v1/generate  {"question": ..., optional "system_prompt", "greedy",
                      "seed", "max_new_tokens", "temperature", "top_p",
                      "top_k", "repetition_penalty", "speculative",
                      "priority", "deadline_ms"}
                     -> {"answer": ...}, plus a "speculative" block (the
                     request's own acceptance rate and draft counts) when
                     it asked to speculate
  POST /v1/stream    the same body (plus "stream_chunk" for the window
                     engine) -> Server-Sent Events over chunked transfer:
                     one ``data: {"delta": ...}`` per decoded text delta,
                     then ``data: {"done": true, "n_tokens": N}``, or
                     ``event: error`` with the error's body if the request
                     fails mid-stream
  GET  /v1/stats     -> {"engine": ..., **engine.stats_snapshot()}
  GET  /metrics      -> the same snapshot and the latency histograms as
                        Prometheus text
  GET  /v1/flight?limit=N -> {"events": [...]}: the last N (default 256)
                        events of a slot engine's flight recorder; 404 on
                        the window engine

Engines (``--engine``): ``continuous`` (the default, as in the JAX server)
decodes every request in a persistent slot batch over a dense KV cache;
``paged`` does the same over a block-paged KV pool with a prefix cache and
chunked prefill, and with ``--quantize-kv int8`` its decode attention runs
the paged decode CUDA kernel; ``window`` groups requests that arrive within
``--batch-window-ms`` into one ``generate_batch``. On ``continuous`` and
``paged`` a stream rides the slot batch; on ``window`` it decodes on the
handler's thread (``Generator.generate_stream``).

Speculation: ``"speculative": K`` asks for K drafts per step. With
``--speculative K`` the continuous and paged engines run every tick as the
fused draft-verify step, drafting by prompt lookup or, with ``--draft-dir``,
by a draft model. A slot engine started without it hands speculative
requests to a window engine that the server keeps beside it, whose
``generate_batch`` speculates; ``--engine window`` serves them the same way.
``/v1/stream`` speculates only on a slot engine started with
``--speculative``, and answers 400 otherwise.

Overload control (the continuous and paged engines, as in the JAX server):
``"priority"`` names a tier (``interactive``, ``batch``, ``best_effort``;
``--priority-default`` otherwise) and ``"deadline_ms"`` the client's budget
for the whole request; ``--max-queue-depth`` bounds the queue (429 past
it), ``--queue-deadline-s`` sheds requests queued that long (503),
``--age-promote-s`` ages waiters up a tier, and ``--brownout-queue-wait-s``,
``--brownout-drain-s`` and ``--brownout-cap-tokens`` set the brownout
controller. Every failure of a request maps through
``infer/errors.error_payload`` to its status and a ``{"error": {...}}``
body, with ``Retry-After`` in whole seconds where the engine gives a hint.
The window engine admits in arrival order and refuses both fields.

Supervision (the slot engines, as in the JAX server): a failed tick answers
the requests in flight with 503 ``engine_restarting`` and restarts the
engine in-process after ``--restart-backoff-s`` (doubling up to
``--restart-backoff-max-s``); ``--circuit-threshold`` failures within
``--circuit-window-s`` open the circuit (``/healthz`` 503). Crash artifacts
go to ``--flight-dir``; ``--watchdog-timeout-s`` > 0 ends the process when
a worker makes no progress for that long. SIGTERM drains: admission closes
server-wide (503 ``draining`` with Retry-After), the work in flight
finishes within ``--drain-timeout-s``, then ``serve`` returns and the
process exits 0. ``build_server(control=...)`` hands ``begin_drain`` (what
SIGTERM calls) and ``httpd`` to an in-process caller.

Run: ``python -m llm_fine_tune_distributed_tpu_torch.infer.server
--model-dir DIR [--engine continuous|paged|window] [--quantize-kv int8]
[--quantize int8] [--speculative K [--draft-dir DIR]]``. It serves on the GPU;
``--device cpu`` runs on the CPU.
``--quantize int8`` stores the block linears as weight-only int8
(``ops/int8.maybe_quantize``). ``build_server`` serves a Generator that is
already in memory (random weights, for instance) without a model directory.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

import torch

from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
from llm_fine_tune_distributed_tpu_torch.device import resolve_device
from llm_fine_tune_distributed_tpu_torch.infer.batching import PRIORITY_TIERS, BatchingEngine
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.errors import (
    DrainingError,
    ServingError,
    error_payload,
)
from llm_fine_tune_distributed_tpu_torch.infer.generate import (
    Generator,
    load_model_dir,
    load_tokenizer_dir,
)
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.observe.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    prometheus_exposition,
)
from llm_fine_tune_distributed_tpu_torch.ops.int8 import (
    QUANTIZE_MODES,
    check_quantize_mode,
    maybe_quantize,
)

log = logging.getLogger(__name__)

ENGINES = ("continuous", "paged", "window")
_FIELD_CASTS = {
    "max_new_tokens": int,
    "temperature": float,
    "top_p": float,
    "top_k": int,
    "repetition_penalty": float,
}
# request fields of the JAX server whose features are not ported
_UNPORTED_FIELDS = ("adapter", "trace")


def parse_overload_fields(req: dict, kind: str):
    """``priority`` (a tier name) and ``deadline_ms`` (the client's budget
    for the whole request) of a request body -> (priority, deadline_s), with
    the JAX server's 400 messages. Both need a slot engine: the window
    engine has no scheduler tick to enforce either."""
    priority = req.get("priority") or None
    if priority is not None:
        if priority not in PRIORITY_TIERS:
            raise ValueError(f"'priority' must be one of {PRIORITY_TIERS}, got {priority!r}")
        if kind == "window":
            raise ValueError("'priority' needs a continuous/paged engine; this server runs "
                             "the window engine, which admits FIFO")
    deadline_s = None
    if req.get("deadline_ms") is not None:
        deadline_s = float(req["deadline_ms"]) / 1000.0
        if not deadline_s > 0:
            raise ValueError("'deadline_ms' must be a positive number of milliseconds, "
                             f"got {req['deadline_ms']!r}")
        if kind == "window":
            raise ValueError("'deadline_ms' needs a continuous/paged engine; this server runs "
                             "the window engine, which cannot cancel mid-decode")
    return priority, deadline_s


def check_engine(engine: str, quantize_kv: str, speculative_k: int = 0,
                 draft_dir: Optional[str] = None) -> None:
    """Refuse an unknown engine, an int8 KV cache on an engine without
    blocks, a draft model without speculation, or engine-level speculation
    on the window engine, before any weight loads (the JAX server's
    refusals)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (expected one of {ENGINES})")
    if quantize_kv != "none" and engine != "paged":
        raise ValueError(
            "--quantize-kv quantizes the PAGED block pool (per-block int8 "
            "scales indexed by block id); the dense/window caches have no "
            "blocks to scale — pick --engine paged or drop --quantize-kv"
        )
    if draft_dir and not speculative_k:
        raise ValueError(
            "--draft-dir requires --speculative K (the draft model only "
            "runs inside the speculative decode loop)"
        )
    if speculative_k and engine == "window":
        raise ValueError(
            "--speculative K applies to the continuous/paged engines "
            "(engine-level fused draft+verify ticks); the window engine "
            "instead takes per-request speculation via POST /v1/generate "
            "with 'speculative': K — drop --speculative or pick "
            "--engine continuous|paged"
        )


class _Server(ThreadingHTTPServer):
    """The HTTP server; closing it also stops the window engine it keeps
    beside a slot engine."""

    daemon_threads = True
    window_engine = None

    def server_close(self) -> None:
        super().server_close()
        if self.window_engine is not None:
            self.window_engine.close()


class _ClientGone(Exception):
    """A write to the client failed: it closed the connection."""


def _pieces(first: Optional[int], tokens):
    """A slot engine's stream as one-token pieces, its first token already
    read (None: the request ended without one)."""
    if first is None:
        return
    yield [first]
    for t in tokens:
        yield [t]


def _stable_prefix(text: str) -> str:
    """``text`` without its trailing U+FFFD: a byte sequence cut mid
    character decodes to a replacement character that later bytes may
    complete, so a stream holds it back until the next token (or the end)."""
    return text.rstrip("\ufffd")


def build_server(
    generator: Generator,
    *,
    host: str = "127.0.0.1",
    port: int = 8080,
    engine: str = "continuous",
    quantize_kv: str = "none",
    slots: int = 8,
    kv_buf_len: int = 4096,
    kv_block_len: int = 256,
    prefill_chunk: int = 512,
    prompt_bucket: int = 64,
    max_batch: int = 8,
    batch_window_ms: float = 10.0,
    request_timeout_s: Optional[float] = 600.0,
    template_kwargs: Optional[dict] = None,
    speculative_k: int = 0,
    max_queue_depth: int = 256,
    queue_deadline_s: Optional[float] = None,
    priority_default: str = "interactive",
    age_promote_s: float = 5.0,
    brownout_queue_wait_s: float = 2.0,
    brownout_drain_s: float = 10.0,
    brownout_cap_tokens: int = 32,
    drain_timeout_s: float = 30.0,
    restart_backoff_s: float = 0.5,
    restart_backoff_max_s: float = 30.0,
    circuit_threshold: int = 5,
    circuit_window_s: float = 60.0,
    watchdog_timeout_s: float = 0.0,
    flight_dir: Optional[str] = None,
    control: Optional[dict] = None,
):
    """Start an ``engine`` over ``generator`` and bind an HTTP server to it.
    Returns ``(httpd, engine)``; the caller runs ``run_server(httpd,
    engine)`` (or ``httpd.serve_forever`` and, when done,
    ``httpd.shutdown()``, ``httpd.server_close()``, which also stops the
    window engine kept beside a slot engine, ``httpd.window_engine``, and
    ``engine.close()``). ``speculative_k`` > 0 runs the slot engine's ticks
    as fused draft-verify steps (a draft model, if the generator has one).
    ``template_kwargs`` go to the chat template. The overload settings
    (``max_queue_depth`` ... ``brownout_cap_tokens``) and the supervision
    settings (``restart_backoff_s`` ... ``flight_dir``), the JAX server's
    defaults, go to the continuous and paged engines. ``httpd.begin_drain``
    (also ``control["begin_drain"]``, beside ``control["httpd"]``) closes
    admission, waits up to ``drain_timeout_s`` for the engines to drain and
    then shuts the server down."""
    speculative_k = max(0, int(speculative_k or 0))
    check_engine(engine, quantize_kv, speculative_k)
    kind = engine
    # the window engine always exists: under --engine window it serves
    # everything, beside a slot engine started without --speculative it
    # serves the speculative requests
    window = BatchingEngine(generator, max_batch=max_batch, window_ms=batch_window_ms)
    overload = dict(max_queue_depth=max_queue_depth, queue_deadline_s=queue_deadline_s,
                    priority_default=priority_default, age_promote_s=age_promote_s,
                    brownout_queue_wait_s=brownout_queue_wait_s,
                    brownout_drain_s=brownout_drain_s, brownout_cap_tokens=brownout_cap_tokens,
                    restart_backoff_s=restart_backoff_s,
                    restart_backoff_max_s=restart_backoff_max_s,
                    circuit_threshold=circuit_threshold, circuit_window_s=circuit_window_s,
                    watchdog_timeout_s=watchdog_timeout_s, flight_dir=flight_dir)
    drain_state = {"draining": False}
    if kind == "window":
        engine = window
    elif kind == "continuous":
        engine = ContinuousBatchingEngine(generator, slots=slots, buf_len=kv_buf_len,
                                          prompt_bucket=prompt_bucket, speculative_k=speculative_k,
                                          **overload)
    else:
        engine = PagedContinuousBatchingEngine(
            generator, slots=slots, buf_len=kv_buf_len, prompt_bucket=prompt_bucket,
            block_len=kv_block_len, prefill_chunk=prefill_chunk, kv_quant=quantize_kv,
            speculative_k=speculative_k, **overload,
        )

    def snapshot() -> dict:
        if kind == "window":
            return {"engine": kind, "queue_depth": engine.queue_depth, "max_batch": max_batch}
        return {"engine": kind, **engine.stats_snapshot()}

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so /v1/stream may use chunked transfer encoding (every
        # other response carries a Content-Length)
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: one line per request at debug
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, payload, content_type: Optional[str] = None,
                  headers: Optional[dict] = None) -> None:
            body = (payload if isinstance(payload, str) else json.dumps(payload)).encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type or (
                "text/plain" if isinstance(payload, str) else "application/json"))
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        def _send_error(self, exc: BaseException) -> None:
            """Any failure through the taxonomy: its status, the structured
            body, and Retry-After when the engine gave a hint (rounded up to
            a positive whole number of seconds)."""
            status, payload, retry_after = error_payload(exc)
            headers = {}
            if retry_after is not None:
                headers["Retry-After"] = max(1, int(-(-retry_after // 1)))
            self._send(status, payload, headers=headers)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                if drain_state["draining"]:
                    # SIGTERM: stop routing here while the work in flight ends
                    self._send(503, {"status": "draining"},
                               headers={"Retry-After": max(1, int(drain_timeout_s))})
                elif kind != "window" and not engine.healthy:
                    # circuit open or fatal: in-process recovery is over, ask
                    # the orchestrator for a restart
                    self._send(503, {"status": "unhealthy", "circuit_state": engine.circuit_state,
                                     "error": engine.terminal_error.to_dict()})
                else:
                    self._send(200, "ok")
            elif path == "/v1/stats":
                self._send(200, snapshot())
            elif path == "/metrics":
                hists = None if kind == "window" else engine.stats.hist
                self._send(200, prometheus_exposition(snapshot(), hists),
                           content_type=PROMETHEUS_CONTENT_TYPE)
            elif path == "/v1/flight":
                self._flight(query)
            else:
                self._send(404, {"error": "not found"})

        def _flight(self, query: str) -> None:
            """The slot engine's flight recorder, live: the ring the
            supervisor dumps after a crash."""
            if kind == "window":
                self._send(404, {"error": "flight events need a continuous/paged engine (the "
                                          "window engine has no flight recorder)"})
                return
            qs = parse_qs(query)
            try:
                limit = int((qs.get("limit") or [256])[0])
                if limit <= 0:
                    raise ValueError
            except ValueError:
                self._send(400, {"error": f"'limit' must be a positive integer, "
                                          f"got {qs['limit'][0]!r}"})
                return
            self._send(200, {"events": engine.recorder.events()[-limit:]})

        def _parse(self):
            """The request body -> (prompt ids, GenerationConfig, seed, the
            body, priority, deadline_s); ValueError, KeyError or TypeError
            for a bad body."""
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise TypeError("body must be a JSON object")
            unported = [k for k in _UNPORTED_FIELDS if k in req]
            if unported:
                raise ValueError(f"{unported} not supported by this server")
            question = req["question"]
            gen_kwargs = {k: cast(req[k]) for k, cast in _FIELD_CASTS.items() if k in req}
            if "greedy" in req:
                gen_kwargs["do_sample"] = not req["greedy"]
            if "speculative" in req:
                gen_kwargs["speculative_lookup"] = int(req["speculative"])
            priority, deadline_s = parse_overload_fields(req, kind)
            if ((priority is not None or deadline_s is not None)
                    and gen_kwargs.get("speculative_lookup", 0) > 0 and not speculative_k):
                # a speculative request on a slot engine without
                # --speculative rides the window engine, which has no
                # scheduler to honour either field
                raise ValueError(
                    "'priority'/'deadline_ms' with 'speculative' needs the server started "
                    "with --speculative K (on a K=0 engine speculative requests fall back to "
                    "the window engine); drop 'speculative' or restart with --speculative K"
                )
            messages = [
                {"role": "system",
                 "content": req.get("system_prompt", WILDERNESS_EXPERT_SYSTEM_PROMPT)},
                {"role": "user", "content": question},
            ]
            prompt_ids = generator.encode_chat(messages, **(template_kwargs or {}))
            return (prompt_ids, GenerationConfig(**gen_kwargs), int(req.get("seed", 0)), req,
                    priority, deadline_s)

        def do_POST(self):  # noqa: N802
            if self.path not in ("/v1/generate", "/v1/stream"):
                self._send(404, {"error": "not found"})
                return
            if drain_state["draining"]:
                # admission is closed server-wide; the work in flight runs on
                self._send_error(DrainingError("server draining; retry against another replica",
                                               retry_after_s=float(drain_timeout_s)))
                return
            try:
                prompt_ids, gen, seed, req, priority, deadline_s = self._parse()
                stream_chunk = int(req.get("stream_chunk", 8))
                if stream_chunk < 1:
                    raise ValueError(f"stream_chunk must be >= 1, got {stream_chunk}")
                if self.path == "/v1/stream" and gen.speculative_lookup:
                    self._check_stream_speculation()
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            overload = {} if kind == "window" else dict(priority=priority, deadline_s=deadline_s)
            if self.path == "/v1/stream":
                self._stream(prompt_ids, gen, seed, stream_chunk, overload)
                return
            # speculative requests ride the slot batch of an engine started
            # with --speculative K; otherwise the window engine speculates
            # in generate_batch
            if kind != "window" and (gen.speculative_lookup == 0 or speculative_k):
                submit = functools.partial(engine.submit_full, **overload)
            else:
                submit = window.submit_full
            try:
                done = submit(prompt_ids, gen, seed=seed, timeout=request_timeout_s)
                answer = generator.decode_reply(done.result)
            except Exception as e:  # request boundary: report, keep serving
                if not isinstance(e, (ServingError, TimeoutError)):
                    log.exception("generate failed")
                self._send_error(e)
                return
            resp = {"answer": answer}
            if gen.speculative_lookup > 0 and done.spec_acceptance is not None:
                # this request's own draft counts, not its batch's
                resp["speculative"] = {
                    "acceptance_rate": round(done.spec_acceptance, 3),
                    "draft_tokens_proposed": done.draft_tokens_proposed,
                    "draft_tokens_accepted": done.draft_tokens_accepted,
                }
                if done.spec_steps is not None:  # the window engine's whole batch
                    resp["speculative"]["sequential_forwards"] = done.spec_steps
            self._send(200, resp)

        def _check_stream_speculation(self) -> None:
            """A stream speculates only on a slot engine started with
            --speculative K (the JAX server's 400s)."""
            if kind == "window":
                raise ValueError(
                    "'speculative' on /v1/stream needs a continuous/"
                    "paged engine started with --speculative K; with "
                    "--engine window the supported alternatives are: "
                    "POST /v1/generate with 'speculative': K "
                    "(non-streaming speculative decode), or /v1/stream "
                    "without 'speculative' (plain streaming)"
                )
            if not speculative_k:
                raise ValueError(
                    "'speculative' on /v1/stream needs the server "
                    "started with --speculative K (engine-level fused "
                    "verify); supported now: POST /v1/generate with "
                    "'speculative': K (non-streaming speculative "
                    "decode), or /v1/stream without 'speculative' "
                    "(plain streaming)"
                )

        def _stream(self, prompt_ids, gen, seed: int, stream_chunk: int, overload: dict) -> None:
            """Server-Sent Events, one per decoded text delta. On the slot
            engines the request is admitted before the headers go out, so a
            refusal (overflow, brownout, a dead engine) gets its status code
            and Retry-After. A request shed before its first token (a queue
            or client deadline) gets them too: the headers wait for the
            first token. A client that disconnects abandons the request: its
            slot stops decoding for nobody."""
            if kind == "window":
                source = generator.generate_stream(prompt_ids, gen, seed=seed, chunk=stream_chunk)
            else:
                try:
                    tokens = engine.stream(prompt_ids, gen, seed=seed, timeout=request_timeout_s,
                                           **overload)
                    first = next(tokens, None)
                except Exception as e:  # request boundary: report, keep serving
                    if not isinstance(e, (ServingError, TimeoutError)):
                        log.exception("stream admission failed")
                    self._send_error(e)
                    return
                source = _pieces(first, tokens)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._events(source)
            except (_ClientGone, OSError):
                self.close_connection = True
            finally:
                source.close()
                if kind != "window":
                    tokens.close()

        def _events(self, source) -> None:
            def chunk_out(data: bytes) -> None:
                try:
                    self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                except OSError as e:
                    raise _ClientGone from e

            def event(payload: dict, name: Optional[str] = None) -> None:
                head = f"event: {name}\n" if name else ""
                chunk_out(f"{head}data: {json.dumps(payload)}\n\n".encode())

            ids, sent = [], ""
            try:
                for piece in source:
                    ids.extend(piece)
                    text = _stable_prefix(generator.tokenizer.decode(ids, skip_special_tokens=True))
                    if len(text) > len(sent):
                        event({"delta": text[len(sent):]})
                        sent = text
                text = generator.tokenizer.decode(ids, skip_special_tokens=True)
                if len(text) > len(sent):
                    event({"delta": text[len(sent):]})
                event({"done": True, "n_tokens": len(ids)})
            except _ClientGone:
                raise
            except Exception as e:  # the request failed mid-stream: say so, then end
                if not isinstance(e, (ServingError, TimeoutError)):
                    log.exception("stream failed")
                event(error_payload(e)[1]["error"], name="error")
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError as e:
                raise _ClientGone from e

    httpd = _Server((host, port), Handler)
    if window is not engine:
        httpd.window_engine = window

    def begin_drain(signum=None, frame=None) -> None:
        """SIGTERM: close admission, let the work in flight finish within
        ``drain_timeout_s``, then stop the server loop so ``serve`` returns
        and the process exits 0."""
        if drain_state["draining"]:
            return
        drain_state["draining"] = True
        print(f"[serve] drain: admission closed, finishing in-flight work "
              f"(timeout {drain_timeout_s}s)", flush=True)
        engines = [engine] if window is engine else [engine, window]
        for eng in engines:
            eng.begin_drain()

        def finish() -> None:
            deadline = time.monotonic() + float(drain_timeout_s)
            clean = True
            for eng in engines:
                clean = eng.wait_drained(max(0.0, deadline - time.monotonic())) and clean
            print("[serve] drain complete; shutting down" if clean else
                  "[serve] drain timeout: shutting down with requests unresolved", flush=True)
            httpd.shutdown()

        threading.Thread(target=finish, name="drain", daemon=True).start()

    httpd.begin_drain = begin_drain
    httpd.drain_state = drain_state
    if control is not None:
        control["begin_drain"] = begin_drain
        control["httpd"] = httpd
    return httpd, engine


def run_server(httpd, engine) -> None:
    """Serve until interrupted or drained. On the main thread SIGTERM runs
    ``httpd.begin_drain``; elsewhere callers drain through it themselves.
    The server and the engines are closed on the way out."""
    prev = None
    try:
        prev = signal.signal(signal.SIGTERM, httpd.begin_drain)
    except ValueError:
        pass  # not the main thread
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        httpd.server_close()
        engine.close()
        if httpd.drain_state["draining"]:
            print("[serve] drained; exiting", flush=True)


def serve(model_dir: str, *, device=None, host: str = "0.0.0.0", port: int = 8080,
          quantize: str = "none", engine: str = "continuous", quantize_kv: str = "none",
          speculative_k: int = 0, draft_dir: Optional[str] = None, **engine_kw) -> None:
    """Load ``model_dir`` onto ``device`` and serve it until interrupted or
    drained (SIGTERM).
    Weights and compute are bf16 on the GPU and f32 on the CPU (which has no
    fast bf16, and where the tests compare with the JAX package in f32);
    ``quantize="int8"`` then stores the block linears as int8 codes.
    ``draft_dir`` (with ``speculative_k``) loads a draft model of the same
    vocabulary beside the target."""
    check_quantize_mode(quantize)  # before the model loads
    check_engine(engine, quantize_kv, speculative_k, draft_dir)
    device = resolve_device(device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params, model_config = load_model_dir(model_dir, device=device, dtype=compute_dtype)
    params = maybe_quantize(params, quantize)
    draft = {}
    if draft_dir:
        draft_params, draft_config = load_model_dir(draft_dir, device=device, dtype=compute_dtype)
        draft = {"draft_params": draft_params, "draft_config": draft_config}
    generator = Generator(
        params, model_config, load_tokenizer_dir(model_dir),
        compute_dtype=compute_dtype, device=device, **draft,
    )
    httpd, eng = build_server(generator, host=host, port=port, engine=engine,
                              quantize_kv=quantize_kv, speculative_k=speculative_k, **engine_kw)
    spec = f", speculative {speculative_k}" + (f" drafting with {draft_dir}" if draft_dir else "")
    print(f"[serve] listening on http://{host}:{httpd.server_address[1]} "
          f"(engine {engine}, device {device}, {compute_dtype}, weights {quantize}"
          f"{spec if speculative_k else ''})", flush=True)
    run_server(httpd, eng)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="Serve a model over HTTP")
    parser.add_argument("--model-dir", default=os.environ.get("MODEL_DIR", "outputs/best_model"))
    parser.add_argument("--engine", choices=ENGINES, default="continuous",
                        help="continuous: persistent slot batch over a dense KV cache (default); "
                             "paged: the same over a block-paged KV pool with a prefix cache; "
                             "window: drain-a-window batching of whole requests")
    parser.add_argument("--quantize-kv", choices=["none", "int8"], default="none",
                        help="store the KV block pool as int8 with per-block absmax scales "
                             "(--engine paged); decode then reads it through the fused CUDA "
                             "kernel")
    parser.add_argument("--quantize-weights", "--quantize", dest="quantize",
                        choices=QUANTIZE_MODES, default="none",
                        help="weight-only quantization of the block linears (int8; nf4 is "
                             "not ported)")
    parser.add_argument("--slots", type=int, default=8,
                        help="persistent decode slots (continuous, paged)")
    parser.add_argument("--kv-buf-len", type=int, default=4096,
                        help="positions per request, prompt + generated (continuous, paged)")
    parser.add_argument("--kv-block-len", type=int, default=256,
                        help="tokens per KV block (paged)")
    parser.add_argument("--prefill-chunk", type=int, default=512,
                        help="max prompt tokens prefilled per scheduler tick (paged)")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="window engine: max concurrent requests grouped into one batch")
    parser.add_argument("--batch-window-ms", type=float, default=10.0,
                        help="window engine: how long the first request waits for company")
    parser.add_argument("--speculative", type=int, default=0, metavar="K",
                        help="continuous/paged engines: every tick drafts up to K tokens per "
                             "slot whose request asks for speculation and verifies them in one "
                             "forward (requests opt in with 'speculative': K)")
    parser.add_argument("--draft-dir", default=None, metavar="DIR",
                        help="model directory of a draft model of the same vocabulary for "
                             "--speculative (default: prompt lookup)")
    parser.add_argument("--max-queue-depth", type=int, default=256,
                        help="bounded admission: requests beyond this many waiters are shed "
                             "with 429 + Retry-After (0 = unbounded)")
    parser.add_argument("--queue-deadline-s", type=float, default=0.0,
                        help="shed requests still queued after this many seconds BEFORE "
                             "prefill (503, retryable; 0 = no deadline)")
    parser.add_argument("--priority-default", choices=PRIORITY_TIERS, default="interactive",
                        help="continuous/paged engines: priority tier assumed for requests "
                             "that send no 'priority' field (admission orders by aged tier; "
                             "under pressure the lowest tier sheds and preempts first)")
    parser.add_argument("--age-promote-s", type=float, default=5.0,
                        help="anti-starvation: every this-many seconds a queued request "
                             "waits, it is ordered as one tier more important (raw tier "
                             "still governs shedding/preemption)")
    parser.add_argument("--brownout-queue-wait-s", type=float, default=2.0,
                        help="brownout pressure budget: queue-wait EWMA at this many "
                             "seconds counts as pressure 1.0")
    parser.add_argument("--brownout-drain-s", type=float, default=10.0,
                        help="brownout pressure budget: predicted queue drain time at this "
                             "many seconds counts as pressure 1.0")
    parser.add_argument("--brownout-cap-tokens", type=int, default=32,
                        help="brownout stage >= 2: max_new_tokens cap applied to "
                             "best_effort requests admitted during the brownout")
    parser.add_argument("--request-timeout-s", type=float, default=600.0,
                        help="max seconds a request waits for the device before a 503 "
                             "(0 = wait forever)")
    parser.add_argument("--drain-timeout-s", type=float, default=30.0,
                        help="SIGTERM grace: how long in-flight requests may finish before "
                             "the server exits anyway")
    parser.add_argument("--restart-backoff-s", type=float, default=0.5,
                        help="supervisor: delay before the first in-process engine restart "
                             "(doubles per failure in the circuit window)")
    parser.add_argument("--restart-backoff-max-s", type=float, default=30.0,
                        help="supervisor: cap on the exponential restart backoff")
    parser.add_argument("--circuit-threshold", type=int, default=5,
                        help="supervisor: retryable failures within --circuit-window-s that "
                             "open the circuit (engine stops restarting, /healthz goes 503)")
    parser.add_argument("--circuit-window-s", type=float, default=60.0,
                        help="supervisor: sliding window for the circuit-breaker count")
    parser.add_argument("--watchdog-timeout-s", type=float, default=0.0,
                        help="hard-exit if the decode worker makes no progress for this many "
                             "seconds (a wedged device; runtime/watchdog.py). Must exceed the "
                             "worst prefill and the kernels' first build. 0 = off")
    parser.add_argument("--flight-dir", default="outputs/flight_recorder",
                        help="directory for flight-recorder JSON dumps (recent engine events, "
                             "written on a restart and on circuit-open). Empty string disables")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080, help="0 picks a free port")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.quantize == "nf4":
        parser.error("--quantize nf4 is not ported "
                     "(llm_fine_tune_distributed_tpu.ops.nf4.quantize_params_nf4 has it)")
    try:
        check_engine(args.engine, args.quantize_kv, args.speculative, args.draft_dir)
    except ValueError as e:
        parser.error(str(e))
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    serve(
        args.model_dir, device=device, host=args.host, port=args.port, quantize=args.quantize,
        engine=args.engine, quantize_kv=args.quantize_kv, slots=args.slots,
        kv_buf_len=args.kv_buf_len, kv_block_len=args.kv_block_len,
        prefill_chunk=args.prefill_chunk, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms, speculative_k=args.speculative,
        draft_dir=args.draft_dir, max_queue_depth=args.max_queue_depth,
        queue_deadline_s=args.queue_deadline_s or None, priority_default=args.priority_default,
        age_promote_s=args.age_promote_s, brownout_queue_wait_s=args.brownout_queue_wait_s,
        brownout_drain_s=args.brownout_drain_s, brownout_cap_tokens=args.brownout_cap_tokens,
        request_timeout_s=args.request_timeout_s or None, drain_timeout_s=args.drain_timeout_s,
        restart_backoff_s=args.restart_backoff_s, restart_backoff_max_s=args.restart_backoff_max_s,
        circuit_threshold=args.circuit_threshold, circuit_window_s=args.circuit_window_s,
        watchdog_timeout_s=args.watchdog_timeout_s, flight_dir=args.flight_dir or None,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
