"""The question-answering CLI shared by ``ask_tuned_model`` and
``ask_original_model`` (counterpart of the JAX ``infer/cli.py``): the same
argparse surface and sampling defaults, plus ``--device``. It runs on the
GPU (bf16) unless ``--device cpu`` is given (f32), and without a GPU it
exits non-zero.

``--speculative K`` decodes with K drafts per step (prompt lookup, or the
draft model of ``--draft-dir``); with ``--serve`` it sets the slot engine's
draft depth, and requests opt in with ``"speculative": K``.

``--quantize int8|nf4`` stores the block linears as weight-only int8 or NF4
(``ops/int8.maybe_quantize``). Every flag combination it refuses, and a flag
whose feature is not ported (``--tp``), stops it before any weight is
loaded.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

_JAX = "llm_fine_tune_distributed_tpu"
# sampling knobs are per-request fields of POST /v1/generate under --serve
_SAMPLING_FLAGS = ("max_new_tokens", "temperature", "top_p", "top_k",
                   "repetition_penalty", "greedy", "seed")


def run_ask_cli(
    argv: Optional[list],
    *,
    description: str,
    default_model_dir: str,
    model_dir_env: str,
    missing_dir_help: str,
    template_kwargs: Optional[dict] = None,
) -> int:
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import QUANTIZE_MODES

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("question", nargs="*", help="question for the model (omit with --serve)")
    parser.add_argument("--model-dir", default=os.environ.get(model_dir_env, default_model_dir),
                        help="directory with config.json + *.safetensors (+ tokenizer)")
    # sampling defaults = the reference's ask_tuned_model.py
    parser.add_argument("--max-new-tokens", type=int, default=3768)
    parser.add_argument("--temperature", type=float, default=0.6)
    parser.add_argument("--top-p", type=float, default=0.95)
    parser.add_argument("--top-k", type=int, default=40)
    parser.add_argument("--repetition-penalty", type=float, default=1.1)
    parser.add_argument("--greedy", action="store_true", help="disable sampling")
    parser.add_argument("--speculative", type=int, default=0, metavar="K",
                        help="speculative decoding with K drafts per step (greedy verifies by "
                             "exact match, sampled by rejection sampling, which keeps the "
                             "output distribution); drafts come from prompt lookup, or from "
                             "the draft model of --draft-dir")
    parser.add_argument("--draft-dir", default=None, metavar="DIR",
                        help="model directory of a small draft model of the same vocabulary "
                             "for --speculative")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quantize", choices=QUANTIZE_MODES, default="none",
                        help="weight-only quantization of the block linears: int8 halves "
                             "their bytes on the card, nf4 (4-bit codes, block 64, double "
                             "quant) cuts them to about 0.26")
    parser.add_argument("--tp", type=int, default=1, metavar="N",
                        help="tensor-parallel inference (not ported: 1 only)")
    parser.add_argument("--serve", action="store_true",
                        help="run the HTTP server (infer/server.py) instead of answering once")
    parser.add_argument("--engine", choices=("continuous", "paged", "window"), default="continuous",
                        help="--serve engine: continuous (default), paged or window")
    parser.add_argument("--host", default="0.0.0.0", help="--serve bind address")
    parser.add_argument("--port", type=int, default=8080, help="--serve port")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default, bf16) or cpu (f32)")
    args = parser.parse_args(argv)
    question = " ".join(args.question)
    if args.draft_dir and not args.speculative:
        parser.error("--draft-dir requires --speculative K")
    if args.tp != 1:
        parser.error(f"--tp {args.tp} is not ported ({_JAX}.infer.generate.make_tp_mesh has it)")
    if not args.model_dir or not os.path.isdir(args.model_dir):
        print(f"Error: model directory not found: {args.model_dir!r}")
        print(missing_dir_help)
        return 1
    if args.serve:
        if question:
            parser.error("--serve takes no question (clients POST /v1/generate)")
        ignored = [f"--{k.replace('_', '-')}" for k in _SAMPLING_FLAGS
                   if getattr(args, k) != parser.get_default(k)]
        if ignored:
            parser.error(f"{' '.join(ignored)} have no effect with --serve: sampling options "
                         "are per-request fields of POST /v1/generate")
        from llm_fine_tune_distributed_tpu_torch.infer.server import check_engine

        try:
            check_engine(args.engine, "none", args.speculative, args.draft_dir)
        except ValueError as e:
            parser.error(str(e))
    elif not question:
        parser.error("a question is required (or pass --serve)")
    elif args.engine != parser.get_default("engine"):
        parser.error("--engine picks the --serve engine; a question is answered by "
                     "Generator.generate_ids")

    import torch

    from llm_fine_tune_distributed_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.exit(2, f"error: {e}\n")

    if args.serve:
        from llm_fine_tune_distributed_tpu_torch.infer.server import serve

        serve(args.model_dir, device=device, host=args.host, port=args.port,
              quantize=args.quantize, engine=args.engine, template_kwargs=template_kwargs,
              speculative_k=args.speculative, draft_dir=args.draft_dir)
        return 0

    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.infer import (
        GenerationConfig,
        Generator,
        load_model_dir,
        load_tokenizer_dir,
    )
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import maybe_quantize

    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    on_card = device.type == "cuda"
    print(f"Loading model from {args.model_dir} ...")
    t0 = time.monotonic()
    before = torch.cuda.memory_allocated(device) if on_card else 0
    params, model_config = load_model_dir(args.model_dir, device=device, dtype=compute_dtype)
    params = maybe_quantize(params, args.quantize)
    draft = {}
    if args.draft_dir:
        draft_params, draft_config = load_model_dir(args.draft_dir, device=device,
                                                    dtype=compute_dtype)
        draft = {"draft_params": draft_params, "draft_config": draft_config}
    generator = Generator(params, model_config, load_tokenizer_dir(args.model_dir),
                          compute_dtype=compute_dtype, device=device, **draft)
    if on_card:
        torch.cuda.synchronize(device)
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    allocated = (f", memory_allocated +{torch.cuda.memory_allocated(device) - before} bytes"
                 if on_card else "")
    print(f"Loaded in {time.monotonic() - t0:.3f} s: {weight_bytes} bytes of weights on "
          f"{device} ({compute_dtype}, quantize {args.quantize}{allocated})")
    if args.draft_dir:
        print(f"Draft model for speculation: {args.draft_dir}")

    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens, do_sample=not args.greedy,
        temperature=args.temperature, top_p=args.top_p, top_k=args.top_k,
        repetition_penalty=args.repetition_penalty, speculative_lookup=args.speculative,
    )
    messages = [
        {"role": "system", "content": WILDERNESS_EXPERT_SYSTEM_PROMPT},
        {"role": "user", "content": question},
    ]
    print(f"\nQuestion: {question}\n")
    t0 = time.monotonic()
    ids = generator.generate_ids(generator.encode_chat(messages, **(template_kwargs or {})),
                                 gen, seed=args.seed)
    answer = generator.decode_reply(ids)
    seconds = time.monotonic() - t0
    print(f"Answer: {answer}")
    print(f"[ask] {len(ids)} tokens in {seconds:.3f} s ({len(ids) / seconds:.2f} tokens/s)")
    if args.speculative and generator.last_acceptance_rate is not None:
        print(f"[speculative] {generator.last_spec_steps} sequential forwards, "
              f"draft acceptance {100 * generator.last_acceptance_rate:.0f}%")
    return 0
