"""HTTP serving of the port (counterpart of the JAX ``infer/server.py`` for
``--engine paged``):

  GET  /healthz      -> 200 "ok"
  POST /v1/generate  {"question": ..., optional "system_prompt", "greedy",
                      "seed", "max_new_tokens", "temperature", "top_p",
                      "top_k", "repetition_penalty"} -> {"answer": ...}

Run: ``python -m llm_fine_tune_distributed_tpu_torch.infer.server
--model-dir DIR --engine paged --quantize-kv int8 [--quantize int8]``. It
serves on the GPU; ``--device cpu`` runs on the CPU. ``--quantize int8``
stores the block linears as weight-only int8 (``ops/int8.maybe_quantize``). ``build_server`` serves a Generator that is
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
from llm_fine_tune_distributed_tpu_torch.infer.engine import PagedContinuousBatchingEngine
from llm_fine_tune_distributed_tpu_torch.infer.generate import (
    Generator,
    load_model_dir,
    load_tokenizer_dir,
)
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.ops.int8 import (
    QUANTIZE_MODES,
    check_quantize_mode,
    maybe_quantize,
)

log = logging.getLogger(__name__)

_FIELD_CASTS = {
    "max_new_tokens": int,
    "temperature": float,
    "top_p": float,
    "top_k": int,
    "repetition_penalty": float,
}
# request fields of the JAX server whose features are not ported
_UNPORTED_FIELDS = ("speculative", "adapter", "priority", "deadline_ms", "trace")


def build_server(
    generator: Generator,
    *,
    host: str = "127.0.0.1",
    port: int = 8080,
    quantize_kv: str = "none",
    slots: int = 8,
    kv_buf_len: int = 4096,
    kv_block_len: int = 256,
    prefill_chunk: int = 512,
    prompt_bucket: int = 64,
    request_timeout_s: Optional[float] = 600.0,
    template_kwargs: Optional[dict] = None,
):
    """Start a paged engine over ``generator`` and bind an HTTP server to
    it. Returns ``(httpd, engine)``; the caller runs ``httpd.serve_forever``
    and, when done, ``httpd.shutdown()``, ``httpd.server_close()`` and
    ``engine.close()``. ``template_kwargs`` go to the chat template."""
    engine = PagedContinuousBatchingEngine(
        generator, slots=slots, buf_len=kv_buf_len, prompt_bucket=prompt_bucket,
        block_len=kv_block_len, prefill_chunk=prefill_chunk, kv_quant=quantize_kv,
    )

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: one line per request at debug
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, payload) -> None:
            body = (payload if isinstance(payload, str) else json.dumps(payload)).encode()
            self.send_response(code)
            self.send_header(
                "Content-Type", "text/plain" if isinstance(payload, str) else "application/json"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/healthz":
                self._send(200, "ok")
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/generate":
                self._send(404, {"error": "not found"})
                return
            try:
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
                gen = GenerationConfig(**gen_kwargs)
                seed = int(req.get("seed", 0))
                messages = [
                    {"role": "system",
                     "content": req.get("system_prompt", WILDERNESS_EXPERT_SYSTEM_PROMPT)},
                    {"role": "user", "content": question},
                ]
                prompt_ids = generator.encode_chat(messages, **(template_kwargs or {}))
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                ids = engine.submit(prompt_ids, gen, seed=seed, timeout=request_timeout_s)
                answer = generator.decode_reply(ids)
            except TimeoutError as e:
                self._send(503, {"error": str(e)})
                return
            except Exception as e:  # request boundary: report, keep serving
                log.exception("generate failed")
                self._send(500, {"error": str(e)})
                return
            self._send(200, {"answer": answer})

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    return httpd, engine


def serve(model_dir: str, *, device=None, host: str = "0.0.0.0", port: int = 8080,
          quantize: str = "none", **engine_kw) -> None:
    """Load ``model_dir`` onto ``device`` and serve it until interrupted.
    Weights and compute are bf16 on the GPU and f32 on the CPU (which has no
    fast bf16, and where the tests compare with the JAX package in f32);
    ``quantize="int8"`` then stores the block linears as int8 codes."""
    check_quantize_mode(quantize)  # before the model loads
    device = resolve_device(device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params, model_config = load_model_dir(model_dir, device=device, dtype=compute_dtype)
    params = maybe_quantize(params, quantize)
    generator = Generator(
        params, model_config, load_tokenizer_dir(model_dir),
        compute_dtype=compute_dtype, device=device,
    )
    httpd, engine = build_server(generator, host=host, port=port, **engine_kw)
    print(f"[serve] listening on http://{host}:{httpd.server_address[1]} "
          f"(device {device}, {compute_dtype}, weights {quantize})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.close()


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="Serve a model over HTTP (paged KV engine)")
    parser.add_argument("--model-dir", default=os.environ.get("MODEL_DIR", "outputs/best_model"))
    parser.add_argument("--engine", choices=["paged"], default="paged",
                        help="the block-paged continuous batching engine (the only one ported)")
    parser.add_argument("--quantize-kv", choices=["none", "int8"], default="none",
                        help="store the KV block pool as int8 with per-block absmax scales; "
                             "decode then reads it through the fused CUDA kernel")
    parser.add_argument("--quantize-weights", "--quantize", dest="quantize",
                        choices=QUANTIZE_MODES, default="none",
                        help="weight-only quantization of the block linears (int8; nf4 is "
                             "not ported)")
    parser.add_argument("--slots", type=int, default=8, help="persistent decode slots")
    parser.add_argument("--kv-buf-len", type=int, default=4096,
                        help="positions per request (prompt + generated)")
    parser.add_argument("--kv-block-len", type=int, default=256, help="tokens per KV block")
    parser.add_argument("--prefill-chunk", type=int, default=512,
                        help="max prompt tokens prefilled per scheduler tick")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080, help="0 picks a free port")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.quantize == "nf4":
        parser.error("--quantize nf4 is not ported "
                     "(llm_fine_tune_distributed_tpu.ops.nf4.quantize_params_nf4 has it)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    serve(
        args.model_dir, device=device, host=args.host, port=args.port, quantize=args.quantize,
        quantize_kv=args.quantize_kv, slots=args.slots, kv_buf_len=args.kv_buf_len,
        kv_block_len=args.kv_block_len, prefill_chunk=args.prefill_chunk,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
