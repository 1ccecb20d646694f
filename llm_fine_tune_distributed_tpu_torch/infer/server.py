"""HTTP serving of the port (counterpart of the JAX ``infer/server.py`` for
one engine on one card):

  GET  /healthz      -> 200 "ok"
  POST /v1/generate  {"question": ..., optional "system_prompt", "greedy",
                      "seed", "max_new_tokens", "temperature", "top_p",
                      "top_k", "repetition_penalty", "speculative"}
                     -> {"answer": ...}, plus a "speculative" block (the
                     request's own acceptance rate and draft counts) when
                     it asked to speculate
  POST /v1/stream    the same body (plus "stream_chunk" for the window
                     engine) -> Server-Sent Events over chunked transfer:
                     one ``data: {"delta": ...}`` per decoded text delta,
                     then ``data: {"done": true, "n_tokens": N}``, or
                     ``event: error`` if the request fails mid-stream
  GET  /v1/stats     -> {"engine": ..., **engine.stats_snapshot()}
  GET  /metrics      -> the same snapshot and the latency histograms as
                        Prometheus text

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
import json
import logging
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
from llm_fine_tune_distributed_tpu_torch.device import resolve_device
from llm_fine_tune_distributed_tpu_torch.infer.batching import BatchingEngine
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
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
_UNPORTED_FIELDS = ("adapter", "priority", "deadline_ms", "trace")


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
):
    """Start an ``engine`` over ``generator`` and bind an HTTP server to it.
    Returns ``(httpd, engine)``; the caller runs ``httpd.serve_forever`` and,
    when done, ``httpd.shutdown()``, ``httpd.server_close()`` (which also
    stops the window engine kept beside a slot engine, ``httpd.window_engine``)
    and ``engine.close()``. ``speculative_k`` > 0 runs the slot engine's
    ticks as fused draft-verify steps (a draft model, if the generator has
    one). ``template_kwargs`` go to the chat template."""
    speculative_k = max(0, int(speculative_k or 0))
    check_engine(engine, quantize_kv, speculative_k)
    kind = engine
    # the window engine always exists: under --engine window it serves
    # everything, beside a slot engine started without --speculative it
    # serves the speculative requests
    window = BatchingEngine(generator, max_batch=max_batch, window_ms=batch_window_ms)
    if kind == "window":
        engine = window
    elif kind == "continuous":
        engine = ContinuousBatchingEngine(generator, slots=slots, buf_len=kv_buf_len,
                                          prompt_bucket=prompt_bucket, speculative_k=speculative_k)
    else:
        engine = PagedContinuousBatchingEngine(
            generator, slots=slots, buf_len=kv_buf_len, prompt_bucket=prompt_bucket,
            block_len=kv_block_len, prefill_chunk=prefill_chunk, kv_quant=quantize_kv,
            speculative_k=speculative_k,
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

        def _send(self, code: int, payload, content_type: Optional[str] = None) -> None:
            body = (payload if isinstance(payload, str) else json.dumps(payload)).encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type or (
                "text/plain" if isinstance(payload, str) else "application/json"))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/healthz":
                self._send(200, "ok")
            elif self.path == "/v1/stats":
                self._send(200, snapshot())
            elif self.path == "/metrics":
                hists = None if kind == "window" else engine.stats.hist
                self._send(200, prometheus_exposition(snapshot(), hists),
                           content_type=PROMETHEUS_CONTENT_TYPE)
            else:
                self._send(404, {"error": "not found"})

        def _parse(self):
            """The request body -> (prompt ids, GenerationConfig, seed, the
            body); ValueError, KeyError or TypeError for a bad body."""
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
            messages = [
                {"role": "system",
                 "content": req.get("system_prompt", WILDERNESS_EXPERT_SYSTEM_PROMPT)},
                {"role": "user", "content": question},
            ]
            prompt_ids = generator.encode_chat(messages, **(template_kwargs or {}))
            return prompt_ids, GenerationConfig(**gen_kwargs), int(req.get("seed", 0)), req

        def do_POST(self):  # noqa: N802
            if self.path not in ("/v1/generate", "/v1/stream"):
                self._send(404, {"error": "not found"})
                return
            try:
                prompt_ids, gen, seed, req = self._parse()
                stream_chunk = int(req.get("stream_chunk", 8))
                if stream_chunk < 1:
                    raise ValueError(f"stream_chunk must be >= 1, got {stream_chunk}")
                if self.path == "/v1/stream" and gen.speculative_lookup:
                    self._check_stream_speculation()
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            if self.path == "/v1/stream":
                self._stream(prompt_ids, gen, seed, stream_chunk)
                return
            # speculative requests ride the slot batch of an engine started
            # with --speculative K; otherwise the window engine speculates
            # in generate_batch
            target = engine if gen.speculative_lookup == 0 or speculative_k else window
            try:
                done = target.submit_full(prompt_ids, gen, seed=seed, timeout=request_timeout_s)
                answer = generator.decode_reply(done.result)
            except TimeoutError as e:
                self._send(503, {"error": str(e)})
                return
            except Exception as e:  # request boundary: report, keep serving
                log.exception("generate failed")
                self._send(500, {"error": str(e)})
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

        def _stream(self, prompt_ids, gen, seed: int, stream_chunk: int) -> None:
            """Server-Sent Events, one per decoded text delta. On the slot
            engines the request is admitted before the headers go out, so a
            refusal still gets a status code. A client that disconnects
            abandons the request: its slot stops decoding for nobody."""
            if kind == "window":
                source = generator.generate_stream(prompt_ids, gen, seed=seed, chunk=stream_chunk)
            else:
                try:
                    tokens = engine.stream(prompt_ids, gen, seed=seed, timeout=request_timeout_s)
                except Exception as e:  # request boundary: report, keep serving
                    log.exception("stream admission failed")
                    self._send(500, {"error": str(e)})
                    return
                source = ([t] for t in tokens)
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
                log.exception("stream failed")
                event({"type": type(e).__name__, "message": str(e)}, name="error")
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError as e:
                raise _ClientGone from e

    httpd = _Server((host, port), Handler)
    if window is not engine:
        httpd.window_engine = window
    return httpd, engine


def serve(model_dir: str, *, device=None, host: str = "0.0.0.0", port: int = 8080,
          quantize: str = "none", engine: str = "continuous", quantize_kv: str = "none",
          speculative_k: int = 0, draft_dir: Optional[str] = None, **engine_kw) -> None:
    """Load ``model_dir`` onto ``device`` and serve it until interrupted.
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
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        eng.close()


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
        draft_dir=args.draft_dir,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
