#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It drives ``llm_fine_tune_distributed_tpu_torch`` (never JAX) phase by phase
and stops with a non-zero exit at the first failure:

1. the card's name and power limit, torch and CUDA versions;
2. builds the port's CUDA kernels from ``csrc/`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at
   SmolLM3-3B's attention shapes, and times both with CUDA events;
4. serves SmolLM3-3B at full width (random bf16 weights from a seed) over
   HTTP from an int8 block-paged KV pool: one request, then 4 concurrent
   ones; every decode step must go through the kernel;
5. one full-width decode step in f32 through ``forward``, with the kernel
   and with its plain version, to a relative logit bound;
6. where a decode step's time goes at the main path's occupancy
   (``torch.profiler`` over a few steps, device kernels grouped by name).

Its last three lines are JSON: a summary of the run, ``{"kernels": [...]}``
(one entry per kernel of the path) and ``{"ok": true, "device": {...}}``. Without a GPU it exits non-zero before
printing either.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import torch

DEVICE = "cuda"
# SmolLM3-3B serving geometry of the smoke (the server's defaults)
SLOTS, KV_BUF_LEN, KV_BLOCK_LEN, PREFILL_CHUNK, PROMPT_BUCKET = 8, 4096, 256, 512, 64
MAX_NEW_TOKENS = 32
QUESTIONS = (
    "How do I purify water from a stream?",
    "What knot should I use to tie a tarp to a tree?",
    "How can I tell if my car's coolant is low?",
    "What are the steps to treat a minor burn?",
)
WARMUP_QUESTION = "How many cups are in a gallon?"
# tolerances of the kernel against its plain version: in f32 both differ
# only in summation order; in bf16 both compute in f32 and round once, so
# they differ by at most one bf16 ulp, which is at most 2**-7 of the value
# (atol covers values near zero)
F32_TOL = 1e-5
BF16_ATOL, BF16_RTOL = 1e-5, 2.0**-7
TOLERANCE = f"f32 max|d| <= {F32_TOL}; bf16 |d| <= {BF16_ATOL} + 2**-7 x |plain|"
# full-width f32 decode step, kernel against plain: relative to max |logit|
LOGIT_REL_TOL = 1e-4
TIMING_REPS = 25

# Published peaks of the H100 SXM5 (NVIDIA data sheet, dense): HBM3
# bytes/s, bf16 tensor-core flop/s, f32 (non-tensor) flop/s.
H100_SXM_PEAKS = (3.35e12, 989e12, 67e12)


def _peaks(name: str):
    """The bound's peaks, for the card this port is measured on."""
    if "H100" not in name or "HBM3" not in name:
        raise RuntimeError(f"no peak rates for {name!r}: bound_ms is defined for the "
                           "H100 SXM (e.g. 'NVIDIA H100 80GB HBM3')")
    return H100_SXM_PEAKS


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# ---------------------------------------------------------------------------
# kernel cases and timing
# ---------------------------------------------------------------------------


def _pools(num_blocks, L, hkv, d, gen):
    k = torch.randint(-127, 128, (num_blocks, L, hkv, d), generator=gen, device=DEVICE, dtype=torch.int8)
    v = torch.randint(-127, 128, (num_blocks, L, hkv, d), generator=gen, device=DEVICE, dtype=torch.int8)
    ks = torch.rand(num_blocks, hkv, generator=gen, device=DEVICE) * 2 + 0.05
    vs = torch.rand(num_blocks, hkv, generator=gen, device=DEVICE) * 2 + 0.05
    for t in (k, v, ks, vs):
        t[0] = 0  # the null block: zero codes, zero scale
    return k, v, ks, vs


def _tables(lengths, nb, L, shared_prefix_blocks, num_blocks, dead_rows):
    """Null-padded tables; rows share their first ``shared_prefix_blocks``
    blocks as the prefix cache maps them; dead rows get all-null tables, as
    the engine gives them."""
    tables = torch.zeros(len(lengths), nb, dtype=torch.int32)
    free = (torch.randperm(num_blocks - 1, generator=torch.Generator().manual_seed(1)) + 1).tolist()
    prefix = [free.pop() for _ in range(shared_prefix_blocks)]
    for r, n in enumerate(lengths):
        if r in dead_rows:
            continue
        used = -(-n // L)
        ids = prefix[: min(used, shared_prefix_blocks)]
        ids += [free.pop() for _ in range(used - len(ids))]
        tables[r, :used] = torch.tensor(ids, dtype=torch.int32)
    return tables.to(DEVICE)


def make_case(lengths, nb, dtype, *, shared_prefix_blocks=0, dead_rows=(), hq=16, hkv=4,
              d=128, L=KV_BLOCK_LEN, num_blocks=154, seed=0):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    k, v, ks, vs = _pools(num_blocks, L, hkv, d, gen)
    tables = _tables(lengths, nb, L, shared_prefix_blocks, num_blocks, dead_rows)
    q = torch.randn(len(lengths), 1, hq, d, generator=gen, device=DEVICE).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    return (q, k, v, ks, vs, tables), lens


def bound(args, lens, peaks):
    """Least time for the work these inputs need: each touched block read
    once (K and V codes and scales), q, tables, lengths read and the output
    written once; operations 4*d per (position, query head)."""
    q, k, _, _, _, tables = args
    _, L, hkv, d = k.shape
    hq = q.shape[2]
    touched = set()
    for row, n in zip(tables.tolist(), lens.tolist()):
        touched.update(row[: min(-(-n // L), len(row))])
    nbytes = (len(touched) * (L * hkv * d * 2 + hkv * 4 * 2)
              + 2 * q.numel() * q.element_size() + tables.numel() * 4 + lens.numel() * 4)
    flops = sum(lens.tolist()) * hq * d * 4
    mem_rate, bf16_rate, f32_rate = peaks
    t_bytes = nbytes / mem_rate
    t_ops = flops / (bf16_rate if q.dtype == torch.bfloat16 else f32_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def time_ms(fn, reps=TIMING_REPS):
    """Median of ``reps`` single launches, CUDA events around each, with the
    50 MB L2 flushed before each (decode finds the pool cold)."""
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.int32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(kernel, plain, args, lens):
    out = kernel(*args, lengths=lens)
    torch.cuda.synchronize()
    ref = plain(*args, lengths=lens)
    diff = (out.float() - ref.float()).abs()
    return out, ref, diff


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def card_info():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def check_close(name, kernel, plain, args, lens):
    """The kernel against its plain version on the same inputs, to
    ``TOLERANCE``; returns the largest |difference| and the plain output."""
    out, ref, diff = compare(kernel, plain, args, lens)
    check(bool(torch.isfinite(out).all()), f"{name}: kernel output not finite")
    err = diff.max().item()
    if out.dtype == torch.float32:
        check(err <= F32_TOL, f"{name}: f32 kernel vs plain max|d| {err:.3e} > {F32_TOL}")
    else:
        over = (diff > BF16_ATOL + BF16_RTOL * ref.float().abs()).sum().item()
        check(over == 0, f"{name}: bf16 kernel vs plain: {over} elements beyond "
                         f"{BF16_ATOL} + 2**-7 x |plain| (max|d| {err:.3e})")
    phase(3, f"{name} {out.dtype}: max|kernel-plain| {err:.3e}, max|plain| "
             f"{ref.float().abs().max().item():.3e}")
    return err


def kernel_phase(fa, peaks, live_lengths):
    """Kernel against plain at SmolLM3 shapes; returns the timing record."""
    kernel, plain = fa.paged_decode_attention, fa.paged_decode_attention_reference
    ragged = [1, 255, 256, 257, 1500, 4096, 3000, 777]
    for dtype in (torch.float32, torch.bfloat16):
        args, lens = make_case(ragged, 17, dtype, shared_prefix_blocks=5)
        check_close("ragged b=8 hq=16 hkv=4 d=128 L=256 nb=17", kernel, plain, args, lens)

    record = {}
    n_live = len(live_lengths)
    cases = {
        # the main path's decode step: live rows mid-generation sharing the
        # system prompt's 5 full blocks, dead rows (length 1) on null tables
        "live": (live_lengths + [1] * (SLOTS - n_live),
                 1 << (max(-(-n // KV_BLOCK_LEN) for n in live_lengths) - 1).bit_length(),
                 5, range(n_live, SLOTS)),
        "full": ([KV_BUF_LEN] * SLOTS, KV_BUF_LEN // KV_BLOCK_LEN, 0, ()),
    }
    for name, (lengths, nb, shared, dead) in cases.items():
        f32_args, lens = make_case(lengths, nb, torch.float32, shared_prefix_blocks=shared,
                                   dead_rows=dead, seed=3)
        check_close(name, kernel, plain, f32_args, lens)
        args, lens = make_case(lengths, nb, torch.bfloat16, shared_prefix_blocks=shared,
                               dead_rows=dead, seed=3)
        err = check_close(name, kernel, plain, args, lens)
        ms = time_ms(lambda: kernel(*args, lengths=lens))
        plain_ms = time_ms(lambda: plain(*args, lengths=lens))
        bound_ms, bound_by, nbytes = bound(args, lens, peaks)
        record[name] = {
            "lengths": lengths, "nb": nb, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes,
        }
        phase(3, f"{name} occupancy lengths={lengths} nb={nb}: kernel {ms:.4f} ms, "
                 f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                 f"{nbytes / 1e6:.2f} MB)")
    return record


def serve_phase(server_mod, fa, generator):
    """The main path: the port's HTTP server over a paged int8 engine."""
    fa.paged_decode_attention.launches = 0  # count the main path's launches only
    httpd, engine = server_mod.build_server(
        generator, host="127.0.0.1", port=0, quantize_kv="int8", slots=SLOTS,
        kv_buf_len=KV_BUF_LEN, kv_block_len=KV_BLOCK_LEN, prefill_chunk=PREFILL_CHUNK,
        prompt_bucket=PROMPT_BUCKET,
    )
    # observe each request's generated ids (the HTTP answer is text)
    results = []
    submit = engine.submit

    def recording_submit(prompt_ids, gen, seed=0, timeout=None):
        ids = submit(prompt_ids, gen, seed=seed, timeout=timeout)
        results.append((list(prompt_ids), list(ids)))
        return ids

    engine.submit = recording_submit
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(question, out, i):
        body = json.dumps({"question": question, "greedy": True,
                           "max_new_tokens": MAX_NEW_TOKENS}).encode()
        req = urllib.request.Request(base + "/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        t0 = time.monotonic()
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, json.loads(r.read())
        t1 = time.monotonic()
        out[i] = (status, body, t1 - t0, t1)

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            check(r.status == 200 and r.read() == b"ok", "/healthz did not answer 200 ok")
        phase(4, "GET /healthz -> 200 ok")
        warm = [None]
        post(WARMUP_QUESTION, warm, 0)
        check(warm[0][0] == 200, f"warm-up request: HTTP {warm[0][0]}")
        warm_stats = engine.stats_snapshot()
        phase(4, f"warm-up request: HTTP 200 in {warm[0][2]:.3f} s")
        outs = [None] * len(QUESTIONS)
        threads = [threading.Thread(target=post, args=(q, outs, i)) for i, q in enumerate(QUESTIONS)]
        window_start = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
            check(not t.is_alive(), "a request did not finish")
        stats = engine.stats_snapshot()
        launches = fa.paged_decode_attention.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        thread.join(30)

    for i, o in enumerate(outs):
        check(o is not None and o[0] == 200 and isinstance(o[1].get("answer"), str),
              f"request {i}: {o}")
    check(len(results) == 1 + len(QUESTIONS), f"{len(results)} requests recorded")
    for prompt, ids in results:
        check(1 <= len(ids) <= MAX_NEW_TOKENS, f"a request generated {len(ids)} tokens")
        check(all(0 <= t < generator.config.vocab_size for t in ids), "token id out of range")
    layers = generator.config.num_layers
    check(stats["decode_steps"] > 0, "no decode step ran")
    check(launches == layers * stats["decode_steps"],
          f"kernel launches {launches} != {layers} layers x {stats['decode_steps']} decode steps")
    check(stats["prefix_hits"] >= 1, "no prefix-cache hit")
    # end to end: every token the 4 requests generated over the window's
    # wall time, first submit to last answer (prefill ticks included)
    gen_tok = sum(len(r[1]) for r in results[1:])
    window_s = max(o[3] for o in outs) - window_start
    # the step layer: decode tokens over the decode ticks' time only
    dec_tok = stats["decode_tokens"] - warm_stats["decode_tokens"]
    dec_s = stats["decode_s"] - warm_stats["decode_s"]
    ttft = stats["ttft_s"][1:]
    phase(4, f"4 concurrent requests: HTTP 200 x4, tokens {[len(r[1]) for r in results[1:]]}, "
             f"prompt tokens {[len(r[0]) for r in results[1:]]}, "
             f"prefix hits {stats['prefix_hits']} ({stats['prefix_tokens_reused']} tokens reused)")
    phase(4, f"kernel launches {launches} == {layers} x {stats['decode_steps']} decode steps")
    return {
        "launches": launches,
        "decode_steps": stats["decode_steps"],
        "prefix_hits": stats["prefix_hits"],
        "prefix_tokens_reused": stats["prefix_tokens_reused"],
        "prompt_tokens": [len(r[0]) for r in results],
        "generated_tokens": [len(r[1]) for r in results],
        "tokens_per_s_concurrent": gen_tok / window_s,
        "window_s": window_s,
        "decode_tick_tokens_per_s": dec_tok / dec_s if dec_s > 0 else None,
        "decode_step_ms_mean": 1e3 * stats["decode_s"] / stats["decode_steps"],
        "ttft_s_warmup": stats["ttft_s"][0],
        "ttft_s_concurrent": ttft,
        "request_s_concurrent": [o[2] for o in outs],
        "kv_pool_bytes": sum(t.numel() * t.element_size()
                             for e in engine.pool["layers"].values() for t in e.values()),
    }


def f32_step_phase(tf, fa, params_bf16, config, prompt_ids):
    """One full-width decode step in f32 through ``forward``: the kernel
    against its plain version on the same prefilled int8 pool."""
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    params = {k: v.float() for k, v in params_bf16.items()}
    plen = len(prompt_ids)
    L = KV_BLOCK_LEN
    nblocks = -(-(plen + 1) // L)
    pool = tf.init_paged_cache(config, 1 + nblocks, L, kv_quant="int8", device=DEVICE)
    table = torch.arange(1, 1 + nblocks, dtype=torch.int32, device=DEVICE)[None, :]
    ids = torch.tensor([prompt_ids], dtype=torch.long, device=DEVICE)
    with torch.no_grad():
        logits, _ = tf.forward(params, ids, config, cache=pool, cache_pos=0,
                               block_tables=table, compute_dtype=torch.float32)
        nxt = logits[:, -1].argmax(-1)[:, None]
        pos = torch.tensor([plen], dtype=torch.long, device=DEVICE)
        out = {}
        for name, fn in (("kernel", fa.paged_decode_attention),
                         ("plain", fa.paged_decode_attention_reference)):
            step_pool = {"layers": {i: {n: t.clone() for n, t in e.items()}
                                    for i, e in pool["layers"].items()}}
            out[name], _ = tf.forward(params, nxt, config, cache=step_pool, cache_pos=pos,
                                      block_tables=table, compute_dtype=torch.float32,
                                      decode_attention=fn)
    torch.cuda.synchronize()
    a, b = out["kernel"], out["plain"]
    check(bool(torch.isfinite(a).all()), "f32 decode logits not finite")
    check(a.shape == (1, 1, config.vocab_size), f"logits shape {tuple(a.shape)}")
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    check(err <= LOGIT_REL_TOL * scale,
          f"f32 decode step: max|dlogits| {err:.3e} > {LOGIT_REL_TOL} x max|logits| {scale:.3e}")
    phase(5, f"f32 decode step after a {plen}-token prefill: max|dlogits| {err:.3e} "
             f"(bound {LOGIT_REL_TOL * scale:.3e} = {LOGIT_REL_TOL} x {scale:.3e})")
    del params
    return {"max_abs_dlogits": err, "max_abs_logits": scale, "prompt_tokens": plen}


def _device_events(prof):
    """(name, start_us, end_us) of every device-side event of a profile."""
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def profile_phase(generator, prompts, steps=5):
    """Decode steps at the main path's occupancy (the prompts prefilled into
    slots 0..n-1 of a fresh int8 pool, the other slots dead), timed with a
    synchronize around them and then profiled: device time by kernel name
    and the device's busy share of the wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    L = KV_BLOCK_LEN
    table_blocks = -(-(KV_BUF_LEN + PROMPT_BUCKET) // L)
    num_blocks = 1 + (SLOTS + 1) * table_blocks
    pool, state = generator.init_paged_state(SLOTS, num_blocks, L, kv_quant="int8")
    table = np.zeros((SLOTS, table_blocks), np.int32)
    greedy = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False)
    nxt = 1
    for slot, p in enumerate(prompts):
        bucket = -(-len(p) // PROMPT_BUCKET) * PROMPT_BUCKET
        need = -(-(bucket + steps + 2) // L)
        table[slot, :need] = np.arange(nxt, nxt + need)
        nxt += need
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : len(p)] = p
        seen = np.zeros((1, generator.config.vocab_size), bool)
        seen[0, p] = True
        generator.paged_prefill_final(pool, state, table[slot: slot + 1], padded, 0, len(p),
                                      seen, slot, greedy, 0)
    live = np.arange(SLOTS) < len(prompts)
    in_use = max(-(-(len(p) + steps + 2) // L) for p in prompts)
    nb = 1 << (in_use - 1).bit_length()
    tables = np.ascontiguousarray(np.where(live[:, None], table, 0)[:, :nb])
    for _ in range(2):
        generator.paged_step(pool, state, live, tables)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        generator.paged_step(pool, state, live, tables)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            generator.paged_step(pool, state, live, tables)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    events = _device_events(prof)
    by_name: dict = {}
    for name, a, b in events:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (b - a), n + 1)
    busy = 0.0
    end = None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    result = {
        "steps": steps, "live_rows": len(prompts), "nb": nb,
        "step_ms": step_ms,
        "profiled_step_ms": wall_us / 1e3 / steps,
        "device_busy_share": busy / wall_us if events else None,
        "device_kernels_per_step": len(events) / steps,
        "top_kernels": [
            {"name": name[:90], "ms_per_step": tot / 1e3 / steps, "calls_per_step": n / steps}
            for name, (tot, n) in top
        ],
    }
    phase(6, f"decode step at {len(prompts)} live rows, nb={nb}: {step_ms:.2f} ms "
             f"({result['profiled_step_ms']:.2f} ms profiled), device busy "
             f"{100 * (result['device_busy_share'] or 0):.1f}%, "
             f"{result['device_kernels_per_step']:.0f} device kernels per step")
    for row in result["top_kernels"]:
        phase(6, f"  {row['ms_per_step']:8.3f} ms/step  {row['calls_per_step']:6.1f} calls  {row['name']}")
    if not events:
        phase(6, "the profiler recorded no device events")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible to torch; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa

    t_start = time.monotonic()
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    phase(1, f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
             f"python {sys.version.split()[0]}")
    peaks = _peaks(kind)

    t0 = time.monotonic()
    _build.load("paged_decode")
    built = _build.build_log.get("paged_decode")
    phase(2, f"paged_decode built in {time.monotonic() - t0:.1f} s"
             + ("" if built else " (library already in build/)"))

    config = get_preset("smollm3_3b")
    tokenizer = ByteChatMLTokenizer()
    prompts = [tokenizer.apply_chat_template(
        [{"role": "system", "content": WILDERNESS_EXPERT_SYSTEM_PROMPT},
         {"role": "user", "content": q}], tokenize=True, add_generation_prompt=True)
        for q in QUESTIONS]
    # the kernel at the main path's decode shapes: the 4 concurrent requests
    # halfway through their tokens
    live_lengths = [len(p) + MAX_NEW_TOKENS // 2 for p in prompts]
    kernels = kernel_phase(fa, peaks, live_lengths)

    t0 = time.monotonic()
    params = tf.init_params(config, seed=0, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in params.values())
    phase(4, f"smollm3_3b random bf16 weights: {nparams / 1e9:.3f} B params, "
             f"{sum(t.numel() * t.element_size() for t in params.values()) / 1e9:.2f} GB "
             f"in {time.monotonic() - t0:.1f} s")
    generator = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.bfloat16,
                                  device=DEVICE)
    served = serve_phase(server_mod, fa, generator)
    phase(4, f"{kind} ({card}): {served['tokens_per_s_concurrent']:.1f} tokens/s over the "
             f"4 concurrent requests' {served['window_s']:.3f} s window, "
             f"{served['decode_tick_tokens_per_s']:.1f} tokens/s over their decode ticks, "
             f"mean decode step {served['decode_step_ms_mean']:.2f} ms, "
             f"TTFT warm-up {served['ttft_s_warmup']:.3f} s, concurrent "
             f"{[round(t, 3) for t in served['ttft_s_concurrent']]} s, "
             f"int8 KV pool {served['kv_pool_bytes'] / 1e9:.3f} GB")

    step = f32_step_phase(tf, fa, params, config, prompts[0])
    profiled = profile_phase(generator, prompts)

    live, full = kernels["live"], kernels["full"]
    line = {"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "llm_fine_tune_distributed_tpu_torch/csrc/paged_decode.cu",
        "replaces": "llm_fine_tune_distributed_tpu/ops/flash_attention.py:353",
        "launches": served["launches"],
        "max_abs_err": live["max_abs_err"],
        "tolerance": TOLERANCE,
        "ms": live["ms"],
        "plain_ms": live["plain_ms"],
        "bound_ms": live["bound_ms"],
        "bound_by": live["bound_by"],
        "library_ms": None,
        "shapes": {"live": {"lengths": live["lengths"], "nb": live["nb"]},
                   "full": {"lengths": full["lengths"], "nb": full["nb"]}},
        "full_occupancy": {k: full[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
    }]}
    summary = {"card": card, "serve": served, "f32_decode_step": step,
               "decode_profile": profiled, "build_s": built["seconds"] if built else None,
               "total_s": time.monotonic() - t_start}
    print(json.dumps({"summary": summary}), flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
