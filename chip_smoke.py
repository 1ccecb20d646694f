#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It drives ``llm_fine_tune_distributed_tpu_torch`` (never JAX) phase by phase
and stops with a non-zero exit at the first failure:

1. the card's name and power limit, torch and CUDA versions;
2. builds the port's CUDA kernels from ``csrc/`` with nvcc, one process per
   source, all at once;
3. holds the paged decode kernel against its plain PyTorch version on the
   card, at SmolLM3-3B's attention shapes, and times both with CUDA events;
4. serves SmolLM3-3B at full width (random bf16 weights from a seed) over
   HTTP from an int8 block-paged KV pool: one request, then 4 concurrent
   ones; every decode step must go through the kernel;
5. one full-width decode step in f32 through ``forward``, with the kernel
   and with its plain version, to a relative logit bound;
6. where a decode step's time goes at the main path's occupancy
   (``torch.profiler`` over a few steps, device kernels grouped by name);
7. holds the flash-attention forward, dq and dk/dv kernels against their
   plain versions (f32 and bf16, ragged and packed segments) and times them
   beside ``scaled_dot_product_attention`` at the training shapes;
8. trains SmolLM3-3B at full width (random weights from a seed) for 3
   optimizer steps through ``SFTTrainer`` with the reference recipe: every
   attention must go through the flash kernels, frozen leaves stay
   bit-equal, ``best_model/`` loads back; then profiles one microbatch;
9. one full-width f32 microbatch through the loss function, with the
   kernels and with their plain versions: the loss and every gradient;
10. holds the w8a8 int8 matmul kernel bitwise against its plain version at
   the frozen trunk's projection shapes (M = 8192) and ragged ones, and times
   it beside ``torch._int_mm`` and a bf16 ``torch.matmul``;
11. trains SmolLM3-3B as in phase 8 with ``frozen_compute="int8"``: layers
   0-33 run every projection through the w8a8 kernel under no_grad, the
   last two layers through the flash kernels; launches as derived, the
   trunk's codes bit-unchanged, ``best_model/`` holds the decoded trunk;
12. one full-width f32 microbatch with the int8 trunk, the w8a8 kernel
   against its plain version (plain attention in both): loss and gradients.

Its last three lines are JSON: a summary of the run, ``{"kernels": [...]}``
(one entry per kernel of the paths) and ``{"ok": true, "device": {...}}``.
Without a GPU it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
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


# ---------------------------------------------------------------------------
# phase 7: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

# the training smoke's attention shapes: SmolLM3-3B heads at seq 1024, one
# microbatch of 8 rows with ragged lengths, and one packed case
FLASH_SHAPE = dict(b=8, s=1024, hq=16, hkv=4, d=128)
FLASH_LENGTHS = (1024, 1000, 700, 513, 512, 300, 129, 1)
# f32: the JAX package's own bands (tests/test_flash_attention.py); bf16:
# both sides compute in f32 (so differ by at most the f32 band) and round
# once to bf16, one ulp <= 2**-7 of the value
FLASH_F32_TOL = {"o": 2e-5, "lse": 2e-5, "dq": 5e-5, "dk": 5e-5, "dv": 5e-5}
FLASH_TOLERANCE = ("f32 max|d| <= 2e-5 (O, LSE), 5e-5 (dq, dk, dv); bf16 |d| <= "
                   "the f32 band + 2**-7 x |plain|")


def flash_segments_case(kind, b, s):
    """int32 [b, s] segments: "ragged" is the right-padding mask of
    FLASH_LENGTHS; "packed" gives each row a few packed segments (ids
    1, 2, ...) and a pad tail (0)."""
    seg = torch.zeros(b, s, dtype=torch.int32)
    gen = torch.Generator().manual_seed(7)
    for r in range(b):
        if kind == "ragged":
            seg[r, : FLASH_LENGTHS[r % len(FLASH_LENGTHS)]] = 1
        else:
            pos, sid = 0, 1
            end = s - int(torch.randint(0, s // 4, (1,), generator=gen))
            while pos < end:
                n = int(torch.randint(1, s // 3, (1,), generator=gen))
                seg[r, pos: min(pos + n, end)] = sid
                pos, sid = pos + n, sid + 1
    return seg.to(DEVICE)


def flash_inputs(dtype, seed=0, b=None):
    shape = dict(FLASH_SHAPE, **({"b": b} if b else {}))
    b, s, hq, hkv, d = (shape[k] for k in ("b", "s", "hq", "hkv", "d"))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(b, s, hq, d, generator=gen, device=DEVICE).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen, device=DEVICE).to(dtype)
    do = torch.randn(b, s, hq, d, generator=gen, device=DEVICE).to(dtype)
    return q, k, v, do


def visible_pairs(seg):
    """(query, key) pairs the mask lets through: sum over rows and queries
    of the keys at or before the query with its segment id."""
    total = 0
    for row in seg.tolist():
        counts: dict = {}
        for sid in row:
            counts[sid] = counts.get(sid, 0) + 1
            total += counts[sid]
    return total


def flash_bounds(q, k, seg, peaks):
    """{kernel: (bound_ms, bound_by)} for this run's inputs: flops 4d per
    visible pair and query head for the forward (q k^T and p V), 6d for dq
    (q k^T, dO V^T, ds K), 8d for dk/dv (those and ds^T q, p^T dO); bytes
    each input read once and each output written once."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    e = q.element_size()
    pairs = visible_pairs(seg) * hq
    qb, kvb, segb, statb = b * s * hq * d * e, b * s * hkv * d * e, b * s * 4, b * hq * s * 4
    mem_rate, bf16_rate, f32_rate = peaks
    rate = bf16_rate if q.dtype == torch.bfloat16 else f32_rate
    work = {
        "flash_fwd": (4 * d * pairs, qb + 2 * kvb + segb + qb + statb),
        "flash_bwd_dq": (6 * d * pairs, 2 * qb + 2 * kvb + segb + 2 * statb + qb),
        "flash_bwd_dkv": (8 * d * pairs, 2 * qb + 2 * kvb + segb + 2 * statb + 2 * kvb),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / rate, nbytes / mem_rate
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


def flash_check(fa, dtype, kind):
    """Each flash kernel against its plain version on the same inputs (the
    backward kernels get the plain forward's LSE and delta); returns
    {output: max|d|} and fails beyond FLASH_F32_TOL / the bf16 bound."""
    q, k, v, do = flash_inputs(dtype, seed=1 if kind == "packed" else 0)
    seg = flash_segments_case(kind, q.shape[0], q.shape[1])
    o, lse = fa.flash_fwd(q, k, v, seg)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, seg)
    delta = fa.flash_delta(o_ref, do)
    dq = fa.flash_bwd_dq(q, k, v, seg, lse_ref, delta, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, seg, lse_ref, delta, do)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, seg, lse_ref, delta, do)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, seg, lse_ref, delta, do)
    errs = {}
    for name, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                           ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        check(bool(torch.isfinite(got).all()), f"flash {kind} {dtype} {name}: not finite")
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        band = FLASH_F32_TOL[name]
        if got.dtype == torch.float32:
            check(err <= band, f"flash {kind} f32 {name}: max|kernel-plain| {err:.3e} > {band}")
        else:
            over = (diff > band + 2.0**-7 * ref.float().abs()).sum().item()
            check(over == 0, f"flash {kind} bf16 {name}: {over} elements beyond {band} + "
                             f"2**-7 x |plain| (max|d| {err:.3e})")
        errs[name] = err
        phase(7, f"{kind} {str(dtype).split('.')[-1]} {name}: max|kernel-plain| {err:.3e}, "
                 f"max|plain| {ref.float().abs().max().item():.3e}")
    return errs


def sdpa_times(q, k, v, do, seg):
    """The library yardstick, never called by the port:
    ``scaled_dot_product_attention`` with the same boolean mask, forward and
    (under autograd) its backward, on head-major copies of the inputs."""
    import torch.nn.functional as F

    groups = q.shape[2] // k.shape[2]
    s = q.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool, device=DEVICE).tril()
    mask = (causal & (seg[:, :, None] == seg[:, None, :]))[:, None]
    qh = q.transpose(1, 2).contiguous().requires_grad_()
    kh = k.transpose(1, 2).repeat_interleave(groups, dim=1).contiguous().requires_grad_()
    vh = v.transpose(1, 2).repeat_interleave(groups, dim=1).contiguous().requires_grad_()
    doh = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True))
    return fwd_ms, bwd_ms


def flash_kernel_phase(fa, peaks):
    """Phase 7: correctness in f32 and bf16 on ragged and packed segments,
    then times at the training smoke's shapes in bf16 (ragged)."""
    errs = {torch.float32: {}, torch.bfloat16: {}}
    for dtype in errs:
        for kind in ("ragged", "packed"):
            for name, err in flash_check(fa, dtype, kind).items():
                errs[dtype][name] = max(errs[dtype].get(name, 0.0), err)
    q, k, v, do = flash_inputs(torch.bfloat16)
    seg = flash_segments_case("ragged", q.shape[0], q.shape[1])
    o, lse = fa.flash_fwd(q, k, v, seg)
    delta = fa.flash_delta(o, do)
    timed = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, seg),
                      lambda: fa.flash_attention_fwd_reference(q, k, v, seg)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, seg, lse, delta, do),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, seg, lse, delta, do)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, seg, lse, delta, do)),
    }
    bounds = flash_bounds(q, k, seg, peaks)
    sdpa_fwd_ms, sdpa_bwd_ms = sdpa_times(q, k, v, do, seg)
    record = {}
    for name, (kernel, plain) in timed.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        bound_ms, bound_by, flops, nbytes = bounds[name]
        library_ms = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms
        outputs = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
                   "flash_bwd_dkv": ("dk", "dv")}[name]
        err = {dtype: max(e[o] for o in outputs) for dtype, e in errs.items()}
        record[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms,
                        "max_abs_err": err[torch.bfloat16], "max_abs_err_f32": err[torch.float32],
                        "flops": flops, "bytes": nbytes}
        phase(7, f"{name} bf16 b=8 s=1024 hq=16 hkv=4 d=128 ragged: kernel {ms:.3f} ms, "
                 f"plain {plain_ms:.3f} ms, SDPA {'forward' if name == 'flash_fwd' else 'backward'} "
                 f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                 f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
                 f"{ms / library_ms:.1f}x SDPA")
    return record


# ---------------------------------------------------------------------------
# phases 8-9: SFT training of SmolLM3-3B through the port's trainer
# ---------------------------------------------------------------------------

TRAIN_ROWS = 120  # -> 108 train rows, 12 validation rows, 3 steps of 32
TRAIN_PROMPT = "You are a wilderness survival expert."
# full-width f32 microbatch, kernels against plain versions: the loss to
# 1e-5 relative, each trainable leaf's gradient to 1e-4 of its largest entry
LOSS_REL_TOL, GRAD_REL_TOL = 1e-5, 1e-4


def train_counters(fa, mm):
    return {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv, "w8a8_matmul": mm.w8a8_matmul}


def train_phase(fa, mm, workdir, frozen_compute="bf16"):
    """The main training path: ``SFTTrainer`` on SmolLM3-3B at full width
    (random weights from a seed), the reference recipe, 3 optimizer steps
    over 120 rows of the repo's dataset; phase 8 with the plain frozen
    layers, phase 11 with ``frozen_compute="int8"``. Returns (record,
    trainer)."""
    import os

    from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
    from llm_fine_tune_distributed_tpu_torch.infer.generate import load_model_dir
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import dequantize_int8
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    phase_no = 8 if frozen_compute == "bf16" else 11

    data_dir = os.path.join(workdir, "data")
    os.makedirs(data_dir)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "final_qa_data_unique.jsonl")) as f:
        lines = [next(f) for _ in range(TRAIN_ROWS)]
    with open(os.path.join(data_dir, "final_qa_data_unique.jsonl"), "w") as f:
        f.writelines(lines)
    out_dir = os.path.join(workdir, "out")
    config = TrainConfig(model_name="smollm3-3b-random", model_preset="smollm3_3b",
                         tokenizer_path="byte-chatml", data_dir=data_dir, output_dir=out_dir,
                         epochs=1, system_prompt=TRAIN_PROMPT, logging_steps=1,
                         frozen_compute=frozen_compute)
    t0 = time.monotonic()
    trainer = SFTTrainer(config, device=DEVICE)
    torch.cuda.synchronize()
    mc = trainer.model_config
    trunk = trainer.frozen_boundary
    phase(phase_no, f"SFTTrainer ready in {time.monotonic() - t0:.1f} s: {mc.name}, "
                    f"{trainer.trainable_report}, {trainer.n_train} train / {trainer.n_val} validation "
                    f"rows, {trainer.total_steps} steps, remat "
                    f"{config.resolved_remat_policy(mc)}, frozen_compute {frozen_compute} "
                    f"(trunk: layers [0, {trunk}))")
    frozen_before = {k: v.clone() for k, v in trainer.state.frozen.items()}
    trainable_before = {k: v.detach().clone() for k, v in trainer.state.trainable.items()}
    real_rows = trainer.train_arrays["attention_mask"].sum(axis=1)
    phase(phase_no, f"train rows: {int(real_rows.min())}..{int(real_rows.max())} real tokens of "
                    f"{config.max_seq_length}, {int((real_rows < config.max_seq_length).sum())} of "
                    f"{len(real_rows)} padded")

    counters = train_counters(fa, mm)
    for fn in counters.values():  # count the main path's launches only
        fn.launches = 0
    t0 = time.monotonic()
    summary = trainer.train()
    launches = {name: fn.launches for name, fn in counters.items()}
    phase(phase_no, f"train() returned in {time.monotonic() - t0:.1f} s (artifacts included)")

    history = trainer.metrics.history
    meter = trainer.throughput
    losses = [h["loss"] for h in history]
    grad_norms = [h["grad_norm"] for h in history]
    check(all(np.isfinite(losses)) and all(np.isfinite(grad_norms)), f"non-finite loss {losses}")
    check(np.isfinite(summary["final_eval_loss"]), f"eval loss {summary['final_eval_loss']}")
    for k, v in trainer.state.frozen.items():
        check(torch.equal(v, frozen_before[k]), f"frozen leaf {k} changed")
    for k, v in trainer.state.trainable.items():
        check(not torch.equal(v.detach(), trainable_before[k]), f"trainable leaf {k} did not move")
    n_int8 = sum(k.endswith("_int8") for k in frozen_before)
    phase(phase_no, f"{len(frozen_before)} frozen leaves bit-unchanged ({n_int8} int8 code leaves and "
                    f"their scales among them), {len(trainable_before)} trainable leaves moved")
    del frozen_before, trainable_before

    # launches: the trunk's layers run one forward per microbatch (no
    # backward, no replay), each of its 7 projections through w8a8; the other
    # layers a forward, its remat replay and a backward; every layer one
    # forward per eval batch
    layers, accum, steps = mc.num_layers, config.gradient_accumulation_steps, len(meter.step_s)
    eval_batches = -(-trainer.n_val // (config.eval_batch_size or config.per_device_batch_size))
    evals = 1 + (steps // config.eval_steps if config.eval_steps else 0)
    replays = 1 if config.gradient_checkpointing else 0
    top = layers - trunk
    expected = {
        "flash_fwd": (trunk * accum * steps + top * accum * steps * (1 + replays)
                      + layers * eval_batches * evals),
        "flash_bwd_dq": top * accum * steps,
        "flash_bwd_dkv": top * accum * steps,
        "w8a8_matmul": trunk * 7 * (accum * steps + eval_batches * evals),
    }
    phase(phase_no, f"kernel launches {launches}, derived {expected}: {trunk} trunk layers x {accum} "
                    f"microbatches x {steps} steps + {top} layers x {accum} x {steps} x (1 + {replays} "
                    f"remat replay) forwards + {layers} x {eval_batches} eval batches x {evals} eval(s); "
                    f"backward {top} x {accum} x {steps}; w8a8 {trunk} x 7 projections x ({accum} x "
                    f"{steps} + {eval_batches} x {evals})")
    check(launches == expected, f"launches {launches} != derived {expected}")

    best_dir = os.path.join(out_dir, "best_model")
    for name in ("training_history.json", "training_summary.json"):
        check(os.path.exists(os.path.join(out_dir, name)), f"{name} missing")
    loaded, loaded_config = load_model_dir(best_dir, device=DEVICE)
    check(loaded_config == mc, "best_model/config.json does not give the trained config")
    state = {**trainer.state.trainable, **trainer.state.frozen}
    exported = {k[: -len("_int8")] if k.endswith(".kernel_int8") else k
                for k in state if not k.endswith(".kernel_int8_scale")}
    check(set(loaded) == exported, "best_model/ leaves differ from the trained state")
    for k, v in state.items():
        if k.endswith(".kernel_int8_scale"):
            continue
        if k.endswith(".kernel_int8"):  # the trunk, decoded
            k, v = k[: -len("_int8")], dequantize_int8({"int8": v, "int8_scale": state[k + "_scale"]},
                                                        torch.float32)
        check(torch.equal(loaded[k], v.detach().to(torch.bfloat16)), f"best_model/{k} differs")
    del loaded
    phase(phase_no, f"best_model/ loads through load_model_dir: {len(exported)} leaves equal the trained "
                    f"state in bf16 ({n_int8} of them the decoded int8 trunk)")

    steady = slice(1, None)  # steps 2-3: the first step pays first-use costs
    step_s = meter.step_s[steady]
    step_ms = statistics.median(step_s) * 1e3
    samples_per_s = config.per_device_batch_size * accum * len(step_s) / sum(step_s)
    real_tokens_per_s = sum(meter.step_real_tokens[steady]) / sum(step_s)
    peak = torch.cuda.max_memory_allocated()
    train_peak = history[-1]["device_peak_bytes_in_use"]  # at the last step, before the export
    record = {
        "losses": losses, "grad_norms": grad_norms, "logged_steps": [h["step"] for h in history],
        "eval_loss": summary["final_eval_loss"],
        "eval_loss_answer": trainer._last_eval_answer,
        "step_s": meter.step_s, "step_ms_median_steps_2_3": step_ms,
        "samples_per_s_per_card": samples_per_s, "real_tokens_per_s_per_card": real_tokens_per_s,
        "padded_tokens_per_s_per_card": samples_per_s * config.max_seq_length,
        "max_memory_allocated_bytes": peak, "train_peak_bytes": train_peak,
        "launches": launches, "expected_launches": expected,
        "summary": summary,
    }
    phase(phase_no, f"losses {[round(x, 4) for x in losses]} at steps {record['logged_steps']}, "
                    f"grad_norm {[round(x, 4) for x in grad_norms]}, eval_loss "
                    f"{summary['final_eval_loss']:.4f}")
    phase(phase_no, f"steps 2-3: median step {step_ms:.1f} ms, {samples_per_s:.2f} samples/s/card, "
                    f"{real_tokens_per_s:.0f} real tokens/s/card, max_memory_allocated "
                    f"{peak / 1e9:.2f} GB ({train_peak / 1e9:.2f} GB at the last step, before the export)")
    return record, trainer


def f32_microbatch_phase(trainer, fa, mm):
    """One full-width microbatch (batch 2, seq 1024) in f32 through the same
    loss function, kernels against plain versions: the loss and every
    trainable leaf's gradient. Phase 9 (no trunk): the flash kernels against
    the plain attention. Phase 12 (the int8 trunk): the w8a8 kernel against
    its plain version, with the plain attention in both runs."""
    import dataclasses

    from llm_fine_tune_distributed_tpu_torch.ops.attention import attention, attention_plain
    from llm_fine_tune_distributed_tpu_torch.train.step import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    config = dataclasses.replace(trainer.config, compute_dtype="float32")
    mc = trainer.model_config
    trunk = trainer.frozen_boundary
    phase_no = 12 if trunk else 9
    if trunk:
        runs = {"kernel": dict(attention_fn=attention_plain, trunk_matmul=mm.int8_w8a8_matmul),
                "plain": dict(attention_fn=attention_plain, trunk_matmul=mm.int8_w8a8_matmul_plain)}
        counted = {"w8a8_matmul": mm.w8a8_matmul}
    else:
        runs = {"kernel": dict(attention_fn=attention), "plain": dict(attention_fn=attention_plain)}
        counted = {k: v for k, v in train_counters(fa, mm).items() if k != "w8a8_matmul"}
    # int8 codes and their f32 scales stay as they are
    frozen = {k: v.float() if v.is_floating_point() else v for k, v in trainer.state.frozen.items()}
    trainable = {k: v.detach().float().clone().requires_grad_() for k, v in trainer.state.trainable.items()}
    arrays = trainer.train_arrays
    batch = {k: torch.from_numpy(arrays[k][:2]).to(DEVICE)
             for k in ("input_ids", "loss_mask", "attention_mask")}
    out = {}
    for name, kw in runs.items():
        before = {c: f.launches for c, f in counted.items()}
        loss, _ = make_loss_fn(mc, config, frozen_layers=trunk, **kw)(trainable, frozen, batch)
        grads = torch.autograd.grad(loss, list(trainable.values()))
        torch.cuda.synchronize()
        out[name] = (loss.detach(), grads)
        ran = {c: f.launches - before[c] for c, f in counted.items()}
        check((min(ran.values()) > 0) == (name == "kernel"), f"{name} run launched {ran}")
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    check(bool(torch.isfinite(lk)) and all(bool(torch.isfinite(g).all()) for g in gk),
          "f32 microbatch: non-finite loss or gradient")
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    check(loss_rel <= LOSS_REL_TOL, f"f32 microbatch loss {lk.item()} vs plain {lp.item()}")
    worst = 0.0
    for name, a, b in zip(trainable, gk, gp):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        check(err <= GRAD_REL_TOL * scale, f"f32 grad {name}: max|d| {err:.3e} > "
                                           f"{GRAD_REL_TOL} x {scale:.3e}")
        worst = max(worst, err / scale)
    bit_equal = bool(torch.equal(lk, lp)) and all(torch.equal(a, b) for a, b in zip(gk, gp))
    phase(phase_no, f"f32 microbatch b=2 s=1024 at full width{', int8 trunk' if trunk else ''}: loss "
                    f"kernel {lk.item():.6f} plain {lp.item():.6f} (rel {loss_rel:.2e}); worst "
                    f"trainable-leaf grad max|d|/max|g| {worst:.2e} over {len(trainable)} leaves; "
                    f"bit-equal: {bit_equal}")
    return {"loss_kernel": lk.item(), "loss_plain": lp.item(), "loss_rel": loss_rel,
            "grad_rel_worst": worst, "bit_equal": bit_equal}


def train_profile_phase(trainer, mm):
    """Where one training microbatch's time goes (forward and backward of
    batch 8 at seq 1024, remat included): ``torch.profiler`` device time by
    kernel name, the flash and w8a8 kernels' shares, the row quantizer's
    share (its calls inside a ``record_function`` range, for this profile
    only: the range's span on the device timeline) and the device's busy
    share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from llm_fine_tune_distributed_tpu_torch.train.step import make_loss_fn

    trunk = trainer.frozen_boundary
    phase_no = 11 if trunk else 8
    loss_fn = make_loss_fn(trainer.model_config, trainer.config, frozen_layers=trunk)
    quantize = mm.quantize_rows_int8

    def ranged_quantize(x):
        with record_function("quantize_rows_int8"):
            return quantize(x)
    arrays = trainer.train_arrays
    n = trainer.config.per_device_batch_size
    batch = {k: torch.from_numpy(arrays[k][:n]).to(DEVICE)
             for k in ("input_ids", "loss_mask", "attention_mask")}
    params = list(trainer.state.trainable.values())

    def micro():
        loss, _ = loss_fn(trainer.state.trainable, trainer.state.frozen, batch)
        torch.autograd.grad(loss, params)

    micro()
    torch.cuda.synchronize()
    mm.quantize_rows_int8 = ranged_quantize
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            micro()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    finally:
        mm.quantize_rows_int8 = quantize
    # the range shows on the device timeline as one annotation per call,
    # spanning its kernels: its time, and not a kernel of its own
    events = _device_events(prof)
    quant_us = sum(b - a for name, a, b in events if name == "quantize_rows_int8")
    events = [e for e in events if e[0] != "quantize_rows_int8"]
    by_name: dict = {}
    for name, a, b in events:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (b - a), cnt + 1)
    total = sum(t for t, _ in by_name.values())
    flash = sum(t for name, (t, _) in by_name.items() if "flash_" in name)
    w8a8 = sum(t for name, (t, _) in by_name.items() if "w8a8_kernel" in name)
    busy, end = 0.0, None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    result = {
        "microbatch_ms": wall_us / 1e3,
        "device_busy_share": busy / wall_us if events else None,
        "device_ms": total / 1e3,
        "flash_kernels_ms": flash / 1e3,
        "flash_share_of_device_time": flash / total if total else None,
        "w8a8_kernel_ms": w8a8 / 1e3,
        "w8a8_share_of_device_time": w8a8 / total if total else None,
        "quantize_rows_ms": quant_us / 1e3,
        "quantize_rows_share_of_device_time": quant_us / total if total else None,
        "top_kernels": [{"name": name[:90], "ms": t / 1e3, "calls": c} for name, (t, c) in top],
    }
    phase(phase_no, f"profiled microbatch (b=8, s=1024, fwd+bwd with remat): {result['microbatch_ms']:.1f} "
                    f"ms wall, device busy {100 * (result['device_busy_share'] or 0):.1f}%, of "
                    f"{result['device_ms']:.1f} ms device time: flash kernels "
                    f"{result['flash_kernels_ms']:.1f} ms, w8a8 kernel {result['w8a8_kernel_ms']:.1f} ms, "
                    f"row quantization {result['quantize_rows_ms']:.1f} ms")
    for row in result["top_kernels"]:
        phase(phase_no, f"  {row['ms']:8.3f} ms  {row['calls']:5d} calls  {row['name']}")
    if not events:
        phase(phase_no, "the profiler recorded no device events")
    return result


# ---------------------------------------------------------------------------
# phase 10: the w8a8 int8 matmul against its plain version
# ---------------------------------------------------------------------------

# the frozen trunk's projections at the recipe's microbatch (8 x 1024 rows):
# (name, K, N, projections of this shape per layer)
W8A8_M = 8192
W8A8_SHAPES = (("q_proj/o_proj", 2048, 2048, 2), ("k_proj/v_proj", 2048, 512, 2),
               ("gate_proj/up_proj", 2048, 11008, 2), ("down_proj", 11008, 2048, 1))
# extra cases: an f32 output, and ragged M and N (N = 100 is no multiple of 4,
# so the kernel takes its byte-wise edge loads and unpaired stores)
W8A8_EXTRA = (("f32 q_proj", 8192, 2048, 2048, torch.float32),
              ("ragged gate_proj", 1000, 2048, 11008, torch.bfloat16),
              ("ragged N=100", 1000, 2048, 100, torch.bfloat16))
INT8_OPS_PER_S = 1979e12  # H100 SXM5 data sheet, dense int8 tensor-core rate
W8A8_TOLERANCE = "bitwise (torch.equal): the int32 sum is exact and both round once"


def w8a8_inputs(m, k, n, seed=0):
    """Trunk-like operands made on the card: activations quantized per row,
    a 0.02-scale weight quantized per column."""
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import quantize_int8
    from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import quantize_rows_int8

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=DEVICE).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=DEVICE).mul_(0.02)
    q = quantize_int8(w)
    xq, xs = quantize_rows_int8(x)
    return x, w.to(torch.bfloat16), xq, xs, q["int8"], q["int8_scale"]


def w8a8_bound(m, k, n, out_bytes, peaks):
    """Least time: 2*M*N*K int8 operations at the dense int8 rate, or the
    codes, scales and output moved once at the memory rate."""
    nbytes = m * k + k * n + 4 * m + 4 * n + m * n * out_bytes
    t_ops, t_bytes = 2 * m * n * k / INT8_OPS_PER_S, nbytes / peaks[0]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", nbytes


def int_mm_ms(xq, wq):
    """``torch._int_mm``'s time, or None where it refuses the shape."""
    try:
        torch._int_mm(xq, wq)
    except RuntimeError as e:
        phase(10, f"torch._int_mm refused ({xq.shape[0]}, {xq.shape[1]}, {wq.shape[1]}): {e}")
        return None
    return time_ms(lambda: torch._int_mm(xq, wq))


def w8a8_kernel_phase(mm, peaks):
    """Phase 10: the kernel bitwise against its plain version at every case,
    then times at the trunk's shapes beside the plain version,
    ``torch._int_mm`` (int8 x int8 -> int32 only: no row/column scales, no
    cast) and a bf16 ``torch.matmul`` of the same shape (the bf16 trunk's
    projection). Returns the kernels-line record: times summed over one
    trunk layer's 7 projections."""
    shapes = []
    for name, k, n, count in W8A8_SHAPES:
        shapes.append((name, W8A8_M, k, n, torch.bfloat16, count))
    shapes += [(name, m, k, n, dt, 0) for name, m, k, n, dt in W8A8_EXTRA]
    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "library_kmajor_ms": 0.0, "bf16_matmul_ms": 0.0, "quantize_rows_ms": 0.0}
    per_shape = []
    for i, (name, m, k, n, dt, count) in enumerate(shapes):
        x, w, xq, xs, wq, ws = w8a8_inputs(m, k, n, seed=i)
        out = mm.w8a8_matmul(xq, xs, wq, ws, dt)
        torch.cuda.synchronize()
        ref = mm.int8_w8a8_matmul_reference(xq, xs, wq, ws, dt)
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.equal(out, ref), f"w8a8 {name} ({m}, {k}, {n}) {dt}: kernel differs from "
                                     f"plain, max|d| {err:.3e}")
        del out, ref
        bound_ms, bound_by, nbytes = w8a8_bound(m, k, n, torch.finfo(dt).bits // 8, peaks)
        row = {"name": name, "m": m, "k": k, "n": n, "dtype": str(dt).split(".")[-1],
               "per_layer": count, "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": nbytes}
        if count:  # a shape of the main path: time it
            row["ms"] = time_ms(lambda: mm.w8a8_matmul(xq, xs, wq, ws, dt))
            row["plain_ms"] = time_ms(lambda: mm.int8_w8a8_matmul_reference(xq, xs, wq, ws, dt))
            row["library_ms"] = int_mm_ms(xq, wq)
            # the same call with a K-major copy of wq (cuBLASLt's int8 layout)
            row["library_kmajor_ms"] = int_mm_ms(xq, wq.t().contiguous().t())
            row["bf16_matmul_ms"] = time_ms(lambda: x @ w)
            row["quantize_rows_ms"] = time_ms(lambda: mm.quantize_rows_int8(x))
            for key in layer:
                layer[key] = None if None in (layer[key], row[key]) else layer[key] + count * row[key]
            phase(10, f"{name} M={m} K={k} N={n} bf16: kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, torch._int_mm {row['library_ms']} ms "
                      f"({row['library_kmajor_ms']} ms with wq K-major), bf16 "
                      f"matmul {row['bf16_matmul_ms']:.4f} ms, row quantization "
                      f"{row['quantize_rows_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                      f"{2 * m * n * k / 1e9:.0f} GOP, {nbytes / 1e6:.1f} MB); bitwise equal")
        else:
            phase(10, f"{name} M={m} K={k} N={n} {row['dtype']}: bitwise equal to plain")
        per_shape.append(row)
        del x, w, xq, xs, wq, ws
    phase(10, f"one trunk layer (7 projections at M={W8A8_M}): kernel {layer['ms']:.3f} ms, plain "
              f"{layer['plain_ms']:.3f} ms, torch._int_mm {layer['library_ms']} ms "
              f"({layer['library_kmajor_ms']} ms with wq K-major), bf16 "
              f"matmul {layer['bf16_matmul_ms']:.3f} ms, bound {layer['bound_ms']:.3f} ms; row "
              f"quantization of the 7 inputs {layer['quantize_rows_ms']:.3f} ms")
    return {**layer, "bound_by": "operations", "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "shapes": per_shape}


def kernel_entry(name, source, replaces, launches, rec):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **{k: rec[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible to torch; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import gc
    import tempfile

    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
    from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as mm

    t_start = time.monotonic()
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    phase(1, f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
             f"python {sys.version.split()[0]}")
    peaks = _peaks(kind)

    t0 = time.monotonic()
    sources = ("paged_decode", "flash_fwd", "flash_bwd", "w8a8_matmul")
    _build.build_all(sources)  # one nvcc per source, all at once
    build_s = time.monotonic() - t0
    phase(2, f"{', '.join(sources)} built in {build_s:.1f} s"
             + ("" if _build.build_log else " (libraries already in build/)"))
    for name, log in _build.build_log.items():
        regs = sorted({line.split("Used ")[1].split(",")[0] for line in log["ptxas"].splitlines()
                       if "Used " in line})
        phase(2, f"  {name}: {log['seconds']:.1f} s, registers per thread {regs}")

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
    del generator, params  # free the serving phases' tensors before training
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    flash = flash_kernel_phase(fa, peaks)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        trained, trainer = train_phase(fa, mm, workdir)
    train_profile = train_profile_phase(trainer, mm)
    microbatch = f32_microbatch_phase(trainer, fa, mm)
    del trainer  # free phase 8's state before the int8 trunk's
    gc.collect()
    torch.cuda.empty_cache()

    w8a8 = w8a8_kernel_phase(mm, peaks)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_int8_") as workdir:
        trained_i8, trainer = train_phase(fa, mm, workdir, frozen_compute="int8")
    first, first_i8 = trained["losses"][0], trained_i8["losses"][0]
    check(abs(first_i8 - first) <= 0.02 * abs(first),
          f"int8-trunk first loss {first_i8} vs phase 8's {first}: beyond 2% relative")
    phase(11, f"first-step loss {first_i8:.4f} vs phase 8's {first:.4f} "
              f"(rel {abs(first_i8 - first) / abs(first):.2e}); steps 2-3 median step "
              f"{trained_i8['step_ms_median_steps_2_3']:.1f} ms vs {trained['step_ms_median_steps_2_3']:.1f}, "
              f"{trained_i8['samples_per_s_per_card']:.2f} vs {trained['samples_per_s_per_card']:.2f} "
              f"samples/s/card, {trained_i8['real_tokens_per_s_per_card']:.0f} vs "
              f"{trained['real_tokens_per_s_per_card']:.0f} real tokens/s/card, peak memory at the "
              f"last step {trained_i8['train_peak_bytes'] / 1e9:.2f} vs "
              f"{trained['train_peak_bytes'] / 1e9:.2f} GB")
    train_profile_i8 = train_profile_phase(trainer, mm)
    microbatch_i8 = f32_microbatch_phase(trainer, fa, mm)
    del trainer

    live, full = kernels["live"], kernels["full"]
    paged = kernel_entry("paged_decode_attention",
                         "llm_fine_tune_distributed_tpu_torch/csrc/paged_decode.cu",
                         "llm_fine_tune_distributed_tpu/ops/flash_attention.py:353",
                         served["launches"], {**live, "library_ms": None})
    paged.update({
        "tolerance": TOLERANCE,
        "shapes": {"live": {"lengths": live["lengths"], "nb": live["nb"]},
                   "full": {"lengths": full["lengths"], "nb": full["nb"]}},
        "full_occupancy": {k: full[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
    })
    flash_sources = {
        "flash_fwd": ("flash_fwd.cu", "llm_fine_tune_distributed_tpu/ops/flash_attention.py:51"),
        "flash_bwd_dq": ("flash_bwd.cu", "llm_fine_tune_distributed_tpu/ops/flash_attention.py:133"),
        "flash_bwd_dkv": ("flash_bwd.cu", "llm_fine_tune_distributed_tpu/ops/flash_attention.py:167"),
    }
    entries = [paged]
    for name, (src, replaces) in flash_sources.items():
        entry = kernel_entry(name, f"llm_fine_tune_distributed_tpu_torch/csrc/{src}", replaces,
                             trained["launches"][name], flash[name])
        entry.update({"tolerance": FLASH_TOLERANCE,
                      "max_abs_err_f32": flash[name]["max_abs_err_f32"],
                      "shapes": {k: FLASH_SHAPE[k] for k in FLASH_SHAPE} | {
                          "dtype": "bf16", "lengths": list(FLASH_LENGTHS)},
                      "library": "scaled_dot_product_attention "
                                 + ("forward" if name == "flash_fwd" else "backward (dq, dk, dv)")})
        entries.append(entry)
    w8a8_entry = kernel_entry("w8a8_matmul", "llm_fine_tune_distributed_tpu_torch/csrc/w8a8_matmul.cu",
                              "llm_fine_tune_distributed_tpu/ops/int8_matmul.py:89",
                              trained_i8["launches"]["w8a8_matmul"], w8a8)
    w8a8_entry.update({
        "tolerance": W8A8_TOLERANCE,
        "times_are": f"sums over one trunk layer's 7 projections at M={W8A8_M}, bf16 output",
        "library": "torch._int_mm (int8 x int8 -> int32, no scales and no cast)",
        "library_kmajor_ms": w8a8["library_kmajor_ms"], "bf16_matmul_ms": w8a8["bf16_matmul_ms"],
        "quantize_rows_ms": w8a8["quantize_rows_ms"],
        "shapes": w8a8["shapes"],
    })
    entries.append(w8a8_entry)
    summary = {"card": card, "serve": served, "f32_decode_step": step,
               "decode_profile": profiled, "build_s": build_s, "train": trained,
               "train_profile": train_profile, "f32_microbatch": microbatch,
               "train_int8": trained_i8, "train_profile_int8": train_profile_i8,
               "f32_microbatch_int8": microbatch_i8, "total_s": time.monotonic() - t_start}
    phase(12, f"total_s {summary['total_s']:.1f}")
    print(json.dumps({"summary": summary}), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
