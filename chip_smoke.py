#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It drives ``llm_fine_tune_distributed_tpu_torch`` (never JAX) phase by phase
and stops with a non-zero exit at the first failure:

1. the card's name and power limit, torch and CUDA versions;
2. builds the port's CUDA kernels from ``csrc/`` with nvcc, one process per
   source, all at once, and fails if the ptxas report kept beside each
   library (built now or before) is missing a tensor-core flash kernel, the
   w8a8 kernel or any of the 32 paged decode instantiations, or shows one
   spilling registers;
3. holds the paged decode kernel against its plain PyTorch version on the
   card, at SmolLM3-3B's attention shapes (ragged, the main path's live
   rows, 8 full rows, one row of 4096), and times both with CUDA events
   beside the byte bound;
4. serves SmolLM3-3B at full width (random bf16 weights from a seed) over
   HTTP from an int8 block-paged KV pool: one request, then 4 concurrent
   ones; every decode step must go through the kernel;
5. one full-width decode step in f32 through ``forward``, with the kernel
   and with its plain version, to a relative logit bound;
6. where a decode step's time goes at the main path's occupancy
   (``torch.profiler`` over a few steps, device kernels grouped by name);
7. holds the flash-attention forward, dq and dk/dv kernels to their plain
   versions (f32: the CUDA-core kernels, to the JAX package's bands; bf16:
   the tensor-core kernels within 2x the error of
   ``scaled_dot_product_attention`` in bf16 of an f32 truth, over the whole
   tensor and row by row, at d 128 and 64, ragged and packed segments; planted
   dq and dk/dv faults must fail the row rule), has the kernels count the
   tile pairs they compute against ``flash_tile_pairs``, and times them
   beside SDPA at the training shapes, with and without pairs to skip;
8. trains SmolLM3-3B at full width (random weights from a seed) for 3
   optimizer steps through ``SFTTrainer`` with the reference recipe: every
   attention must go through the flash kernels, frozen leaves stay
   bit-equal, the losses stay within 0.5% of the recorded ones,
   ``best_model/`` loads back; then profiles one microbatch, which must show
   the tensor-core flash kernels by name; the kernels count the tile pairs
   they compute on every training microbatch's own padding, and one
   microbatch runs again with every token marked real (nothing to skip);
9. one full-width f32 microbatch through the loss function, with the
   kernels and with their plain versions: the loss and every gradient;
10. holds the w8a8 int8 matmul kernel on K-major codes bitwise against its
   plain version at the frozen trunk's projection shapes (M = 8192) and
   ragged ones (K off the 128-byte step and off 16 included), and times it
   beside ``torch._int_mm`` on the same codes and a bf16 ``torch.matmul``;
11. trains SmolLM3-3B as in phase 8 with ``frozen_compute="int8"``: layers
   0-33 run every projection through the w8a8 kernel under no_grad, the
   last two layers through the flash kernels; launches as derived, the
   trunk's codes K-major and bit-unchanged, peak memory at most 28.5 GB,
   ``best_model/`` holds the decoded trunk;
12. one full-width f32 microbatch with the int8 trunk, the w8a8 kernel
   against its plain version (plain attention in both): loss and gradients;
13. (after phase 6, on phase 4's weights cast to f32) dense-cache greedy
   generation of one ~1.43k-token prompt: ``Generator.generate_ids`` for 9
   tokens, and ``forward`` over an ``init_cache`` buffer step by step, each
   step's logits within 1e-4 x max|logit| of a no-cache ``forward`` over the
   prompt and the tokens so far; the paged engine (bf16-layout pool) on the
   same prompt must give the same tokens wherever the top-2 logit margin
   exceeds twice that bound;
14. (after phase 9, once phase 8's trainer is freed) asks phase 8's
   ``best_model/`` the question through ``cli.ask_main`` (greedy, 32 new
   tokens), in bf16 and with ``--quantize int8``: both answer, and the int8
   weights take at most 3.4 GB on the card; then profiles a decode step of
   phase 4's random weights as phase 6 does, serves them after
   ``maybe_quantize(..., "int8")`` from an int8 KV pool as phase 4 does
   (launches == 36 x decode steps) and profiles a step again;
15. (right after phase 4, on its generator) phase 4's traffic through
   ``build_server(engine="continuous")`` (a dense 8 x 4096 cache) and
   ``engine="window"``: HTTP 200, each request's greedy tokens equal a solo
   run's up to the first step whose top-2 margin is within rounding (twice
   the solo step's measured difference from a no-cache forward, at least
   phase 13's f32 rule), ``/v1/stats`` and ``/metrics`` counting the tokens
   and requests served, no paged decode launch; then one question through
   ``POST /v1/stream`` on ``continuous`` and on ``paged`` with an int8 pool,
   its deltas equal to the ``/v1/generate`` answer and the paged one's
   launches 36 x its decode steps;
16. (right after phase 15, on its generator) speculation, K = 4, through the
   server: (a) ``--engine continuous --speculative 4`` with prompt lookup,
   phase 15's traffic with ``"speculative": 4``, then one repetitive
   question; (b) the same on ``--engine paged --quantize-kv int8`` (no paged
   decode launch: a verify of K+1 positions takes the dequantizing gather,
   as in JAX; the blocks in use back to the prefix cache's after the
   requests); (c) continuous with the target's own parameter dict as the
   draft (a dense 8 x 4096 draft cache, acceptance at least 0.9); every
   request's tokens held to its solo run by phase 15's margin rule (16b
   adds twice the int8 pool's measured logit error); (e) one plain and one
   speculative continuous tick profiled by kernel name, and spec ticks (prompt
   lookup, self-draft) run under ``torch.cuda.set_sync_debug_mode("error")``
   but for the one transfer of their tokens; (d) (beside phase 14) the ask
   CLI with ``--speculative 4``, then with ``--draft-dir`` phase 8's
   ``best_model/``: the answer's tokens equal the plain ask's, or the solo
   run's by the margin rule.

Times (``time_ms``) are CUDA-event medians after an L2 flush and a spin
kernel of ``SPIN_MS``, calibrated on the card in phase 1. Its last three
lines are JSON: a summary of the run, ``{"kernels": [...]}``
(one entry per kernel of the paths) and ``{"ok": true, "device": {...}}``.
Without a GPU it exits non-zero before printing either.

``python3 chip_smoke.py --flash-ab DIR [DIR ...]`` times instead the paged
decode, flash and w8a8 kernels of one or more checkouts of this repo with
this script's ``time_ms``, for an A/B of two commits within one call: each
DIR (the root of a checkout, for example the parent's ``git archive``
unpacked under ``build/``) runs in a process of its own, in the order given (parent,
change, change, parent), builds its own ``csrc/`` and times its
``paged_decode_attention`` at phase 3's live, full and single shapes, its
``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` and SDPA at phase 7's
shape, with the spin and without it (how earlier records were timed), the
flash kernels again with every row one segment (nothing to skip), and its
``w8a8_matmul`` over one trunk layer's 7 projections at M = 8192 on codes
made by its own ``parallel.freeze.quantize_trunk_int8``. One JSON line per
checkout; the last line lists them all.
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
BATCH_WINDOW_MS = 10.0  # phase 15's window engine (the server's default)
QUESTIONS = (
    "How do I purify water from a stream?",
    "What knot should I use to tie a tarp to a tree?",
    "How can I tell if my car's coolant is low?",
    "What are the steps to treat a minor burn?",
)
WARMUP_QUESTION = "How many cups are in a gallon?"
# phase 16: a question whose prompt repeats itself, for prompt lookup
REPETITIVE_QUESTION = " ".join(["Boil the water for one full minute before you drink it."] * 6)
SPEC_K = 4  # phase 16's draft depth
SELF_DRAFT_MIN_ACCEPTANCE = 0.9
# tolerances of the kernel against its plain version: in f32 both differ
# only in summation order; in bf16 both compute in f32 and round once, so
# they differ by at most one bf16 ulp, which is at most 2**-7 of the value
# (atol covers values near zero)
F32_TOL = 1e-5
BF16_ATOL, BF16_RTOL = 1e-5, 2.0**-7
TOLERANCE = f"f32 max|d| <= {F32_TOL}; bf16 |d| <= {BF16_ATOL} + 2**-7 x |plain|"
# full-width f32 decode step, kernel against plain: relative to max |logit|
LOGIT_REL_TOL = 1e-4
# phase 13: tokens after the prefill's first; phase 14: the int8 weights' cap
DENSE_STEPS = 8
INT8_WEIGHT_BYTES_MAX = 3.4e9
# what the paged decode kernel is, for the kernels line
PAGED_DESIGN = ("each row's positions split over thread blocks (grid split x kv head x row, "
                "split 64-256 positions from host shapes), 16-byte cp.async K/V tiles through a "
                "3-stage ring, codes to f32 by byte_perm, f32 softmax and p.V on CUDA cores, "
                "last-block merge of the splits' (m, l, acc) by an atomic ticket; one launch "
                "per call")
TIMING_REPS = 25
SPIN_MS = 1.0  # the spin before each timed launch: longer than a wrapper's host work
_SPIN: dict = {}  # torch.cuda._sleep cycles for SPIN_MS on this card, and their measured ms

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


def _event_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` alone, in ms."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def calibrate_spin():
    """The ``torch.cuda._sleep`` cycles that keep this card busy SPIN_MS, from
    an event-timed trial of 10**6 cycles (no clock rate is assumed); returns
    (cycles, the chosen spin's own event-timed ms)."""
    trial = 1_000_000
    torch.cuda._sleep(trial)
    trial_ms = _event_ms(lambda: torch.cuda._sleep(trial))
    cycles = int(trial * SPIN_MS / trial_ms)
    _SPIN.update(cycles=cycles, ms=_event_ms(lambda: torch.cuda._sleep(cycles)))
    check(0.5 * SPIN_MS <= _SPIN["ms"] <= 2 * SPIN_MS, f"spin kernel calibration: {_SPIN}")
    return _SPIN["cycles"], _SPIN["ms"]


def time_ms(fn, reps=TIMING_REPS, spin=True):
    """Median of ``reps`` single launches, CUDA events around each, with the
    L2 flushed before each (decode finds the pool cold). With ``spin`` (every
    time this script reports), a spin kernel of SPIN_MS after the flush keeps
    the card busy while the host runs the wrapper's Python and launches, so
    the start event fires just before the first kernel and the time is the
    device's, not the host's. Without it (how earlier records were timed)
    host work beyond the flush's own time lands in the window."""
    if spin and not _SPIN:
        calibrate_spin()
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.int32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(_SPIN["cycles"])
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


def live_lengths(tokenizer_cls, system_prompt):
    """The main path's decode lengths: the 4 concurrent requests' prompts
    (byte-chatml, the default system prompt) halfway through their tokens."""
    tokenizer = tokenizer_cls()
    prompts = [tokenizer.apply_chat_template(
        [{"role": "system", "content": system_prompt}, {"role": "user", "content": q}],
        tokenize=True, add_generation_prompt=True) for q in QUESTIONS]
    return prompts, [len(p) + MAX_NEW_TOKENS // 2 for p in prompts]


def paged_cases(live):
    """{name: (lengths, nb, shared prefix blocks, dead rows)} of the timed
    paged decode shapes."""
    n_live = len(live)
    return {
        # the main path's decode step: live rows mid-generation sharing the
        # system prompt's 5 full blocks, dead rows (length 1) on null tables
        "live": (live + [1] * (SLOTS - n_live),
                 1 << (max(-(-n // KV_BLOCK_LEN) for n in live) - 1).bit_length(),
                 5, range(n_live, SLOTS)),
        "full": ([KV_BUF_LEN] * SLOTS, KV_BUF_LEN // KV_BLOCK_LEN, 0, ()),
        # one request at the longest context: the card is filled by splits alone
        "single": ([KV_BUF_LEN], KV_BUF_LEN // KV_BLOCK_LEN, 0, ()),
    }


def paged_ms(fa, live, spin=True):
    """{case: kernel ms} of ``paged_decode_attention`` at the timed shapes
    (bf16), for ``--flash-ab``."""
    out = {}
    for name, (lengths, nb, shared, dead) in paged_cases(live).items():
        args, lens = make_case(lengths, nb, torch.bfloat16, shared_prefix_blocks=shared,
                               dead_rows=dead, seed=3)
        out[name] = time_ms(lambda: fa.paged_decode_attention(*args, lengths=lens), spin=spin)
    return out


def kernel_phase(fa, peaks, live):
    """Kernel against plain at SmolLM3 shapes; returns the timing record."""
    kernel, plain = fa.paged_decode_attention, fa.paged_decode_attention_reference
    ragged = [1, 255, 256, 257, 1500, 4096, 3000, 777]
    for dtype in (torch.float32, torch.bfloat16):
        args, lens = make_case(ragged, 17, dtype, shared_prefix_blocks=5)
        check_close("ragged b=8 hq=16 hkv=4 d=128 L=256 nb=17", kernel, plain, args, lens)

    record = {}
    for name, (lengths, nb, shared, dead) in paged_cases(live).items():
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
            "bytes": nbytes, "share_of_bound": bound_ms / ms,
            "split_len": fa.paged_decode_split_len(
                len(lengths), args[1].shape[2], nb, KV_BLOCK_LEN,
                torch.cuda.get_device_properties(0).multi_processor_count),
        }
        phase(3, f"{name} lengths={lengths} nb={nb}: kernel {ms:.4f} ms, "
                 f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                 f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound, "
                 f"split {record[name]['split_len']} positions")
    return record


def _hist(engine, name):
    """(sum, count) of one of a slot engine's latency histograms."""
    h = engine.stats.hist[name]
    return h.sum, h.total


def _prometheus_samples(text):
    """A /metrics body parsed line by line: {sample name: value}; fails on a
    line that is neither a TYPE line nor a sample."""
    samples = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            check(len(line.split(" ")) == 4, f"/metrics: bad TYPE line {line!r}")
            continue
        name, _, value = line.rpartition(" ")
        check(bool(name), f"/metrics: bad line {line!r}")
        samples[name] = float(value)
    return samples


def _http(base, path, body=None, timeout=600):
    """(status, body bytes, wall seconds, end time) of one request."""
    req = urllib.request.Request(base + path, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        status, data = r.status, r.read()
    t1 = time.monotonic()
    return status, data, t1 - t0, t1


class _Serving:
    """``build_server`` on a thread, its engine's ``submit`` and ``stream``
    recording each request's (prompt ids, generated ids); stopped on exit."""

    def __init__(self, server_mod, generator, **kw):
        self.httpd, self.engine = server_mod.build_server(generator, host="127.0.0.1", port=0, **kw)
        self.results = []
        submit_full = self.engine.submit_full

        def recording_submit_full(prompt_ids, gen, seed=0, timeout=None):
            req = submit_full(prompt_ids, gen, seed=seed, timeout=timeout)
            self.results.append((list(prompt_ids), list(req.result)))
            return req

        self.engine.submit_full = recording_submit_full
        stream = getattr(self.engine, "stream", None)  # the slot engines

        def recording_stream(prompt_ids, gen, seed=0, timeout=None):
            tokens, ids = stream(prompt_ids, gen, seed=seed, timeout=timeout), []
            self.results.append((list(prompt_ids), ids))

            def each():
                try:
                    for tok in tokens:
                        ids.append(tok)
                        yield tok
                finally:
                    tokens.close()

            return each()

        if stream is not None:
            self.engine.stream = recording_stream
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.close()
        self.thread.join(30)


def serve_phase(server_mod, fa, generator, phase_no=4, engine="paged", spec=0):
    """The port's HTTP server with one engine: one warm-up request, then the
    4 concurrent ones. ``paged`` (phases 4 and 14) serves from an int8 KV
    pool, and every decode step must go through the kernel; ``continuous``
    and ``window`` (phase 15) run dense caches and must never launch it.
    ``spec`` = K (phase 16): the slot engine runs with ``speculative_k`` K,
    every request asks for ``"speculative": K`` and answers with its block;
    every tick is a verify of K+1 positions, which never takes the paged
    decode kernel; then one repetitive question."""
    kw = dict(engine=engine, slots=SLOTS, kv_buf_len=KV_BUF_LEN, prompt_bucket=PROMPT_BUCKET)
    if engine == "paged":
        kw.update(quantize_kv="int8", kv_block_len=KV_BLOCK_LEN, prefill_chunk=PREFILL_CHUNK)
    elif engine == "window":
        kw.update(max_batch=SLOTS, batch_window_ms=BATCH_WINDOW_MS)
    extra = {}
    if spec:
        kw["speculative_k"] = spec
        extra = {"speculative": spec}
    fa.paged_decode_attention.launches = 0  # count this run's launches only
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with _Serving(server_mod, generator, **kw) as srv:
        torch.cuda.synchronize()
        engine_bytes = torch.cuda.memory_allocated() - before
        eng, base = srv.engine, srv.base
        status, body, _, _ = _http(base, "/healthz")
        check(status == 200 and body == b"ok", "/healthz did not answer 200 ok")
        phase(phase_no, f"{engine}: GET /healthz -> 200 ok")
        warm = _http(base, "/v1/generate", {"question": WARMUP_QUESTION, "greedy": True,
                                            "max_new_tokens": MAX_NEW_TOKENS, **extra})
        check(warm[0] == 200, f"warm-up request: HTTP {warm[0]}")
        slot_engine = engine != "window"
        if slot_engine:
            warm_stats = eng.stats_snapshot()
            warm_hist = {k: _hist(eng, k) for k in ("ttft_s", "decode_tick_s")}
        phase(phase_no, f"{engine}: warm-up request: HTTP 200 in {warm[2]:.3f} s")
        outs = [None] * len(QUESTIONS)

        def post(i):
            outs[i] = _http(base, "/v1/generate", {"question": QUESTIONS[i], "greedy": True,
                                                   "max_new_tokens": MAX_NEW_TOKENS, **extra})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(QUESTIONS))]
        window_start = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
            check(not t.is_alive(), "a request did not finish")
        launches = fa.paged_decode_attention.launches
        status, stats_body, _, _ = _http(base, "/v1/stats")
        check(status == 200, f"/v1/stats: HTTP {status}")
        stats = json.loads(stats_body)
        status, metrics_body, _, _ = _http(base, "/metrics")
        check(status == 200, f"/metrics: HTTP {status}")
        samples = _prometheus_samples(metrics_body.decode())
        hist = {k: _hist(eng, k) for k in ("ttft_s", "decode_tick_s")} if slot_engine else {}
        results = list(srv.results)
        if spec:
            rep = _http(base, "/v1/generate", {"question": REPETITIVE_QUESTION, "greedy": True,
                                               "max_new_tokens": MAX_NEW_TOKENS, **extra})
            check(rep[0] == 200, f"{engine} repetitive question: HTTP {rep[0]}")
            idle = eng.stats_snapshot()
            launches = fa.paged_decode_attention.launches  # the repetitive question's too
            draft_cache_bytes = sum(t.numel() * t.element_size() for e in
                                    (eng._dcache or {"layers": {}})["layers"].values()
                                    for t in e.values())

    for i, o in enumerate(outs):
        check(o is not None and o[0] == 200 and isinstance(json.loads(o[1]).get("answer"), str),
              f"{engine} request {i}: {o}")
    check(len(results) == 1 + len(QUESTIONS), f"{len(results)} requests recorded")
    for prompt, ids in results:
        check(1 <= len(ids) <= MAX_NEW_TOKENS, f"a request generated {len(ids)} tokens")
        check(all(0 <= t < generator.config.vocab_size for t in ids), "token id out of range")
    check(stats["engine"] == engine and samples[f'serving_info{{engine="{engine}"}}'] == 1,
          f"/v1/stats or /metrics does not name the {engine} engine")
    gen_tok = sum(len(r[1]) for r in results[1:])
    window_s = max(o[3] for o in outs) - window_start
    out = {
        "engine": engine,
        "launches": launches,
        "prompt_tokens": [len(r[0]) for r in results],
        "generated_tokens": [len(r[1]) for r in results],
        "results": results,
        "tokens_per_s_concurrent": gen_tok / window_s,
        "window_s": window_s,
        "request_s_concurrent": [o[2] for o in outs],
        "request_s_warmup": warm[2],
        "engine_bytes": engine_bytes,
    }
    layers = generator.config.num_layers
    if not slot_engine:
        check(launches == 0, f"the window engine launched the paged decode kernel {launches} times")
        check(stats["queue_depth"] == 0 and samples["serving_queue_depth"] == 0,
              f"window /v1/stats {stats}")
        phase(phase_no, f"window: 4 concurrent requests: HTTP 200 x4, tokens "
                        f"{out['generated_tokens'][1:]}, paged decode launches 0")
        return out
    served = sum(out["generated_tokens"])
    check(stats["tokens_served"] == served,
          f"/v1/stats tokens_served {stats['tokens_served']} != {served} tokens returned")
    check(stats["requests_completed"] == len(results),
          f"/v1/stats requests_completed {stats['requests_completed']} != {len(results)}")
    check(samples["serving_tokens_served_total"] == stats["tokens_served"],
          f"/metrics serving_tokens_served_total {samples['serving_tokens_served_total']} != "
          f"{stats['tokens_served']}")
    check(stats["decode_steps"] > 0, "no decode step ran")
    if engine == "paged" and not spec:
        check(launches == layers * stats["decode_steps"],
              f"kernel launches {launches} != {layers} layers x {stats['decode_steps']} decode steps")
        check(stats["prefix_hits"] >= 1, "no prefix-cache hit")
    elif engine == "paged":
        check(launches == 0, f"paged decode launched {launches} times over speculative ticks "
                             "(a verify of K+1 positions takes the dequantizing gather)")
        check(stats["prefix_hits"] >= 1, "no prefix-cache hit")
        check(idle["blocks_in_use"] == idle["prefix_cache_blocks"],
              f"blocks in use {idle['blocks_in_use']} after the requests, the prefix cache "
              f"holds {idle['prefix_cache_blocks']}: a request's blocks were not returned")
        out["blocks_in_use_idle"] = idle["blocks_in_use"]
    else:
        check(launches == 0, f"the {engine} engine launched the paged decode kernel {launches} times")
    dec_tok = stats["decode_tokens"] - warm_stats["decode_tokens"]
    dec_s = hist["decode_tick_s"][0] - warm_hist["decode_tick_s"][0]
    ticks = hist["decode_tick_s"][1] - warm_hist["decode_tick_s"][1]
    ttft_n = hist["ttft_s"][1] - warm_hist["ttft_s"][1]
    out.update({
        "decode_steps": stats["decode_steps"],
        "prefix_tokens_reused": stats["prefix_tokens_reused"],
        "tokens_served": stats["tokens_served"],
        "decode_tick_tokens_per_s": dec_tok / dec_s if dec_s > 0 else None,
        "decode_step_ms_mean": 1e3 * hist["decode_tick_s"][0] / hist["decode_tick_s"][1],
        "decode_step_ms_mean_concurrent": 1e3 * dec_s / ticks if ticks else None,
        "ttft_s_warmup": warm_hist["ttft_s"][0],
        "ttft_s_concurrent_mean": (hist["ttft_s"][0] - warm_hist["ttft_s"][0]) / ttft_n,
    })
    phase(phase_no, f"{engine}: 4 concurrent requests: HTTP 200 x4, tokens "
                    f"{out['generated_tokens'][1:]}, prompt tokens {out['prompt_tokens'][1:]}, "
                    f"/v1/stats tokens_served {stats['tokens_served']} == /metrics, "
                    f"requests_completed {stats['requests_completed']}")
    if spec:
        blocks = [json.loads(o[1]).get("speculative") for o in outs]
        check(all(b is not None and 0.0 <= b["acceptance_rate"] <= 1.0 for b in blocks),
              f"{engine}: a response lacks its speculative block: {blocks}")
        check(stats["draft_tokens_accepted"] <= stats["draft_tokens_proposed"],
              f"{engine}: accepted {stats['draft_tokens_accepted']} > proposed")
        out.update({
            "speculative_blocks": blocks,
            "repetitive": json.loads(rep[1]).get("speculative"),
            "draft_tokens_proposed": stats["draft_tokens_proposed"],
            "draft_tokens_accepted": stats["draft_tokens_accepted"],
            "draft_acceptance_rate": stats["draft_acceptance_rate"],
            "mean_tokens_per_step": stats["mean_tokens_per_step"],
            "draft_cache_bytes": draft_cache_bytes,
        })
        check(out["repetitive"] is not None, f"{engine}: the repetitive question has no block")
        phase(phase_no, f"{engine} --speculative {spec}: draft acceptance "
                        f"{stats['draft_acceptance_rate']:.3f} ({stats['draft_tokens_accepted']} of "
                        f"{stats['draft_tokens_proposed']}), {stats['mean_tokens_per_step']:.3f} "
                        f"tokens per step; repetitive question: {out['repetitive']}")
    if engine == "paged":
        out["prefix_hits"] = stats["prefix_hits"]
        out["kv_pool_bytes"] = sum(t.numel() * t.element_size()
                                   for e in eng.pool["layers"].values() for t in e.values())
        phase(phase_no, f"prefix hits {stats['prefix_hits']} ({stats['prefix_tokens_reused']} "
                        f"tokens reused); kernel launches {launches} == {layers} x "
                        f"{stats['decode_steps']} decode steps")
    else:
        out["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for e in eng._cache["layers"].values() for t in e.values())
        phase(phase_no, f"{engine}: paged decode launches 0 over {stats['decode_steps']} decode "
                        f"steps")
    return out


def solo_decode(tf, gen_mod, generator, prompt_ids, n):
    """A request's solo greedy run, as ``generate_ids`` runs it (batch 1,
    the generator's prompt bucket, the default repetition penalty), step by
    step: each step's token, the top-2 margin of its penalized logits and
    its max |logit|, and the logits themselves. The tokens must equal
    ``generate_ids``'s."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import (
        GenerationConfig,
        apply_repetition_penalty,
    )

    greedy = GenerationConfig(max_new_tokens=n, do_sample=False)
    config, dtype = generator.config, generator.compute_dtype
    plen = len(prompt_ids)
    bucket = -(-plen // gen_mod._PROMPT_BUCKET) * gen_mod._PROMPT_BUCKET
    cache = tf.init_cache(config, 1, bucket + n, dtype=dtype, device=DEVICE)
    padded = torch.zeros(1, bucket, dtype=torch.long, device=DEVICE)
    padded[0, :plen] = torch.tensor(prompt_ids, device=DEVICE)
    seen = torch.zeros(1, config.vocab_size, dtype=torch.bool, device=DEVICE)
    seen[0, padded[0, :plen]] = True
    lens = torch.tensor([plen], device=DEVICE)
    steps, all_logits, tok = [], [], None
    with torch.no_grad():
        hidden, _ = tf.forward(generator.params, padded, config, cache=cache, cache_pos=0,
                               compute_dtype=dtype, output_hidden=True)
        logits = tf.unembed(generator.params, hidden[:, plen - 1], config, compute_dtype=dtype)
        for t in range(n):
            if t:  # token t reads token t - 1 at position plen + t - 1
                logits = generator._step_logits(tok[:, None], cache, lens + (t - 1))
            pen = apply_repetition_penalty(logits, seen, greedy.repetition_penalty)
            top2 = torch.topk(pen[0], 2).values
            tok = torch.argmax(pen, dim=-1)
            seen[0, tok] = True
            all_logits.append(logits[0])
            steps.append({"token": int(tok), "margin": (top2[0] - top2[1]).item(),
                          "max_abs_logits": logits.abs().max().item()})
    tokens = generator._trim_at_eos([st["token"] for st in steps])
    check(tokens == generator.generate_ids(prompt_ids, greedy),
          "the solo step loop does not reproduce generate_ids")
    return tokens, steps, all_logits


def margin_agreement(tf, generator, label, prompt, got, solo, floor=0.0):
    """Tokens of an engine against the solo run: equal up to the first step
    whose solo top-2 margin is within reach of rounding, where another
    GEMM's order may flip the argmax; a difference at a wider margin fails.
    The bound is phase 13's construction at the run's precision: the larger
    of 2 x 1e-4 x max|logit| (phase 13's f32 rule) and twice the measured
    max|dlogits| between the solo run's cached logits at that step and a
    no-cache forward over the same context (in bf16 the logits' own
    rounding, one ulp = 2**-7 of their magnitude, is above the f32 rule).
    ``floor`` raises the bound where the engine's logits carry another
    error, the int8 KV pool's (phase 16b). Returns (tokens agreeing, the
    check at the first difference or None)."""
    tokens, steps, logits = solo
    for t, (a, b) in enumerate(zip(got, tokens)):
        if a != b:
            ctx = torch.tensor([list(prompt) + tokens[:t]], device=DEVICE)
            with torch.no_grad():
                hidden, _ = tf.forward(generator.params, ctx, generator.config,
                                       compute_dtype=generator.compute_dtype, output_hidden=True)
                plain = tf.unembed(generator.params, hidden[:, -1], generator.config,
                                   compute_dtype=generator.compute_dtype)[0]
            dlogits = (plain - logits[t]).abs().max().item()
            bound = max(2 * LOGIT_REL_TOL * steps[t]["max_abs_logits"], 2 * dlogits, floor)
            at = {"token": t, "got": a, "solo": b, "margin": steps[t]["margin"],
                  "max_abs_dlogits_no_cache": dlogits, "bound": bound}
            check(steps[t]["margin"] <= bound,
                  f"{label}: token {t} is {a}, solo {b}, at a solo top-2 margin "
                  f"{steps[t]['margin']:.3e} > {bound:.3e} (no-cache max|dlogits| {dlogits:.3e})")
            return t, at
    check(len(got) == len(tokens), f"{label}: {len(got)} tokens, solo {len(tokens)}")
    return len(got), None


def _sse(base, body):
    """POST /v1/stream -> (status, [(event, payload)], seconds to the first
    event, seconds to the end)."""
    import http.client

    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    t0 = time.monotonic()
    first = None
    try:
        conn.request("POST", "/v1/stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.getheader("Content-Type") == "text/event-stream",
              f"/v1/stream Content-Type {resp.getheader('Content-Type')}")
        raw = b""
        while True:
            piece = resp.read1(65536)
            if not piece:
                break
            if first is None:
                first = time.monotonic() - t0
            raw += piece
    finally:
        conn.close()
    events = []
    for block in raw.decode().split("\n\n"):
        if block:
            lines = block.split("\n")
            name = lines[0][len("event: "):] if lines[0].startswith("event: ") else "message"
            check(lines[-1].startswith("data: "), f"/v1/stream: bad event {block!r}")
            events.append((name, json.loads(lines[-1][len("data: "):])))
    return resp.status, events, first, time.monotonic() - t0


def stream_phase(server_mod, fa, generator, engine):
    """Phase 15c: one greedy question through POST /v1/stream, its deltas
    held to the /v1/generate answer of the same request. Each runs on a
    fresh server: a freed int8 block keeps its scale, so the paged engine's
    tokens depend on its pool's history."""
    kw = dict(engine=engine, slots=SLOTS, kv_buf_len=KV_BUF_LEN, prompt_bucket=PROMPT_BUCKET)
    if engine == "paged":
        kw.update(quantize_kv="int8", kv_block_len=KV_BLOCK_LEN, prefill_chunk=PREFILL_CHUNK)
    body = {"question": QUESTIONS[0], "greedy": True, "max_new_tokens": MAX_NEW_TOKENS}
    with _Serving(server_mod, generator, **kw) as srv:
        status, data, _, _ = _http(srv.base, "/v1/generate", body)
        (_, generated), = srv.results
    check(status == 200, f"{engine} /v1/generate: HTTP {status}")
    answer = json.loads(data)["answer"]
    fa.paged_decode_attention.launches = 0  # count the stream's launches only
    with _Serving(server_mod, generator, **kw) as srv:
        status, events, first_s, total_s = _sse(srv.base, body)
        launches = fa.paged_decode_attention.launches
        stats = srv.engine.stats_snapshot()
        (_, streamed), = srv.results
        ttft_s = _hist(srv.engine, "ttft_s")[0]
    check(streamed == generated, f"{engine}: /v1/stream's tokens {streamed} != /v1/generate's "
                                 f"{generated}")
    check(status == 200, f"{engine} /v1/stream: HTTP {status}")
    check(all(name == "message" for name, _ in events), f"{engine} /v1/stream: {events[-1]}")
    *deltas, done = [payload for _, payload in events]
    check(done == {"done": True, "n_tokens": stats["tokens_served"]},
          f"{engine} /v1/stream: last event {done}, tokens_served {stats['tokens_served']}")
    text = "".join(d["delta"] for d in deltas)
    check(text.strip() == answer,
          f"{engine} /v1/stream deltas {text.strip()!r} != /v1/generate {answer!r}")
    layers = generator.config.num_layers
    want = layers * stats["decode_steps"] if engine == "paged" else 0
    check(launches == want, f"{engine} /v1/stream: {launches} paged decode launches, want {want}")
    steps = f" == {layers} x {stats['decode_steps']} decode steps" if engine == "paged" else ""
    phase(15, f"{engine} /v1/stream: HTTP 200, {done['n_tokens']} tokens == /v1/generate's, "
              f"{len(deltas)} deltas == its answer ({len(answer)} chars), engine TTFT "
              f"{ttft_s:.3f} s, first event {first_s:.3f} s, whole stream {total_s:.3f} s, "
              f"paged decode launches {launches}{steps}")
    return {"deltas": len(deltas), "n_tokens": done["n_tokens"], "answer_chars": len(answer),
            "ttft_s": ttft_s, "first_event_s": first_s, "stream_s": total_s,
            "launches": launches, "decode_steps": stats["decode_steps"]}


def engines_phase(tf, gen_mod, server_mod, fa, generator):
    """Phase 15: phase 4's traffic on the dense engines (continuous, then
    window), their tokens held to solo runs by the margin rule; then
    /v1/stream on continuous and paged."""
    runs = {e: serve_phase(server_mod, fa, generator, phase_no=15, engine=e)
            for e in ("continuous", "window")}
    solo = {}
    for prompt, _ in runs["continuous"]["results"][1:]:
        solo[tuple(prompt)] = solo_decode(tf, gen_mod, generator, prompt, MAX_NEW_TOKENS)
    for engine, rec in runs.items():
        agree, first_diff = [], []
        for i, (prompt, ids) in enumerate(rec["results"][1:]):
            n, at = margin_agreement(tf, generator, f"{engine} request {i}", prompt, ids,
                                     solo[tuple(prompt)])
            agree.append(n)
            first_diff.append(at)
        rec["tokens_agreeing_with_solo"] = agree
        rec["first_difference"] = first_diff
        rec["solo_tokens"] = [len(solo[tuple(p)][0]) for p, _ in rec["results"][1:]]
        phase(15, f"{engine}: tokens equal to the solo run's, per request: {agree} of "
                  f"{rec['solo_tokens']}")
        for i, at in enumerate(first_diff):
            if at:
                phase(15, f"  {engine} request {i}: token {at['token']} differs at a solo top-2 "
                          f"margin {at['margin']:.3e} <= bound {at['bound']:.3e} (no-cache "
                          f"max|dlogits| {at['max_abs_dlogits_no_cache']:.3e})")
    cont, win = runs["continuous"], runs["window"]
    phase(15, f"continuous: {cont['tokens_per_s_concurrent']:.1f} tokens/s over the 4 concurrent "
              f"requests' {cont['window_s']:.3f} s window, TTFT (engine ttft_s) mean "
              f"{cont['ttft_s_concurrent_mean']:.3f} s (warm-up {cont['ttft_s_warmup']:.3f} s), "
              f"mean decode tick {cont['decode_step_ms_mean_concurrent']:.2f} ms, dense cache "
              f"{cont['cache_bytes']} bytes ({cont['cache_bytes'] / 1e9:.3f} GB; memory_allocated "
              f"+{cont['engine_bytes']} at the engine's start)")
    phase(15, f"window: {win['tokens_per_s_concurrent']:.1f} tokens/s over the 4 concurrent "
              f"requests' {win['window_s']:.3f} s window, TTFT (request wall time, the whole "
              f"answer) mean {statistics.mean(win['request_s_concurrent']):.3f} s, decode tick not "
              f"measured (one generate_batch per group)")
    mc = generator.config
    want = (2 * mc.num_layers * SLOTS * KV_BUF_LEN * mc.num_kv_heads * mc.resolved_head_dim
            * torch.finfo(generator.compute_dtype).bits // 8)
    check(cont["cache_bytes"] == want, f"dense cache {cont['cache_bytes']} bytes != {want}")
    check(want <= cont["engine_bytes"] <= want + 2**26,
          f"memory_allocated grew {cont['engine_bytes']} bytes at the engine's start, cache {want}")
    streams = {e: stream_phase(server_mod, fa, generator, e) for e in ("continuous", "paged")}
    tokens = [ids for _, ids in runs["continuous"]["results"][1:]]
    for rec in runs.values():
        rec.pop("results")
    # phase 16 holds its tokens to the same solo runs (popped there)
    return {**runs, "stream": streams, "solo": solo, "continuous_tokens": tokens}


def int8_kv_noise(tf, generator, prompt):
    """max|dlogits| of the last prompt position between a prefill through a
    fresh int8 block pool and the dense solo prefill: the int8 KV pool's own
    error, which phase 16b's margin rule allows beside bf16 rounding."""
    config, dtype = generator.config, generator.compute_dtype
    L = KV_BLOCK_LEN
    nblocks = -(-len(prompt) // L)
    pool = tf.init_paged_cache(config, 1 + nblocks, L, dtype=dtype, kv_quant="int8",
                               device=DEVICE)
    table = torch.arange(1, 1 + nblocks, dtype=torch.int32, device=DEVICE)[None, :]
    ids = torch.tensor([list(prompt)], device=DEVICE)
    with torch.no_grad():
        paged, _ = tf.forward(generator.params, ids, config, cache=pool, cache_pos=0,
                              block_tables=table, compute_dtype=dtype, output_hidden=True)
        dense, _ = tf.forward(generator.params, ids, config, compute_dtype=dtype,
                              output_hidden=True)
        a = tf.unembed(generator.params, paged[:, -1], config, compute_dtype=dtype)
        b = tf.unembed(generator.params, dense[:, -1], config, compute_dtype=dtype)
    return (a - b).abs().max().item()


def hold_to_solo(tf, generator, label, rec, solo, floor=0.0):
    """Each of a run's 4 requests against its solo run by the margin rule;
    the agreeing counts go into ``rec``."""
    agree, first_diff = [], []
    for i, (prompt, ids) in enumerate(rec["results"][1:]):
        n, at = margin_agreement(tf, generator, f"{label} request {i}", prompt, ids,
                                 solo[tuple(prompt)], floor=floor)
        agree.append(n)
        first_diff.append(at)
    rec["tokens_agreeing_with_solo"] = agree
    rec["first_difference"] = first_diff
    phase(16, f"{label}: tokens equal to the solo run's, per request: {agree} of "
              f"{[len(solo[tuple(p)][0]) for p, _ in rec['results'][1:]]}")
    for i, at in enumerate(first_diff):
        if at:
            phase(16, f"  {label} request {i}: token {at['token']} differs at a solo top-2 "
                      f"margin {at['margin']:.3e} <= bound {at['bound']:.3e}")


def dense_slots(generator, prompts):
    """A fresh dense 8 x 4096 slot state with the prompts prefilled into
    slots 0..n-1 (greedy): (cache, state, live, each slot's tokens so far)."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    greedy = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                              speculative_lookup=SPEC_K)
    cache, state = generator.init_slot_state(SLOTS, KV_BUF_LEN)
    ctx = []
    for slot, p in enumerate(prompts):
        bucket = -(-len(p) // PROMPT_BUCKET) * PROMPT_BUCKET
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : len(p)] = p
        first = generator.slot_prefill(cache, state, padded, len(p), slot, greedy, 0)
        ctx.append(list(p) + [first])
    return cache, state, np.arange(SLOTS) < len(prompts), ctx


def lookup_drafts(engine_mod, ctx):
    """Prompt-lookup drafts of the live slots' contexts, as the engine
    proposes them: ``(drafts [SLOTS, K], n_draft [SLOTS])``."""
    drafts = np.zeros((SLOTS, SPEC_K), np.int64)
    n_draft = np.zeros((SLOTS,), np.int64)
    for slot, c in enumerate(ctx):
        found = engine_mod._prompt_lookup(np.asarray(c, np.int64), SPEC_K)
        drafts[slot, : found.size] = found
        n_draft[slot] = found.size
    return drafts, n_draft


def without_syncs(gen_mod, run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("error")``, but for
    the spec tick's one transfer of its tokens (``_spec_readback``): any
    other synchronizing call in the tick raises."""
    orig = gen_mod.Generator.__dict__["_spec_readback"]

    def guarded(toks, n_emit):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return orig.__func__(toks, n_emit)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    gen_mod.Generator._spec_readback = staticmethod(guarded)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        gen_mod.Generator._spec_readback = orig


def record_rejections(generator):
    """Wrap ``generator``'s spec verify: for every live slot whose run ended
    on a rejected draft, the gap between the verify's penalized logit of
    its own token and of the draft (>= 0), kept on the device. Returns the
    list of (gaps [S], rejected [S]) per tick; ``rejection_gaps`` reads it."""
    verify = generator._spec_verify
    pending = []

    def recording(state, live, drafts, n_draft, logits_all):
        seen = state["seen"].clone()
        toks, n_emit, live_t = verify(state, live, drafts, n_draft, logits_all)
        slots, k1 = toks.shape
        rows = torch.arange(slots, device=toks.device)
        i = (n_emit - 1).clamp(min=0)  # the run's last position
        for j in range(k1 - 1):  # the tokens taken before position i
            seen[rows, toks[:, j].clamp(min=0)] |= (j < i) & (toks[:, j] >= 0)
        logits = logits_all[rows, i]
        pen = state["repetition_penalty"][:, None]
        pen = torch.where(seen, torch.where(logits > 0, logits / pen, logits * pen), logits)
        d = drafts[rows, i.clamp(max=k1 - 2)]
        gap = pen[rows, toks[rows, i].clamp(min=0)] - pen[rows, d]
        pending.append((gap, live_t & (i < n_draft)))
        return toks, n_emit, live_t

    generator._spec_verify = recording
    return pending


def rejection_gaps(pending):
    return [g for gap, rejected in pending for g, r in zip(gap.tolist(), rejected.tolist()) if r]


def self_draft_f32(gen_mod, engine_mod, generator, prompts):
    """Phase 16c in f32 (phase 13's precision): the 4 prompts through a
    continuous engine whose draft is the target, in process. Rounding sits
    at 2**-24, far below the random model's bf16 near-ties, so acceptance
    must reach 0.9 here (1.0 on the CPU)."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    params = {k: v.float() for k, v in generator.params.items()}
    gen32 = gen_mod.Generator(params, generator.config, generator.tokenizer,
                              compute_dtype=torch.float32, device=DEVICE, draft_params=params,
                              draft_config=generator.config)
    engine = engine_mod.ContinuousBatchingEngine(gen32, slots=SLOTS, buf_len=KV_BUF_LEN,
                                                 prompt_bucket=PROMPT_BUCKET, speculative_k=SPEC_K)
    cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                           speculative_lookup=SPEC_K)
    try:
        done = [None] * len(prompts)
        threads = [threading.Thread(target=lambda i=i: done.__setitem__(
            i, engine.submit_full(prompts[i], cfg, timeout=600))) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
            check(not t.is_alive(), "an f32 self-draft request did not finish")
        stats = engine.stats_snapshot()
    finally:
        engine.close()
    rate = stats["draft_acceptance_rate"]
    check(all(r is not None and len(r.result) >= 1 for r in done), "f32 self-draft: no answer")
    check(rate >= SELF_DRAFT_MIN_ACCEPTANCE,
          f"f32 self-draft acceptance {rate:.3f} < {SELF_DRAFT_MIN_ACCEPTANCE}")
    phase(16, f"16c in f32: self-draft acceptance {rate:.3f} ({stats['draft_tokens_accepted']} of "
              f"{stats['draft_tokens_proposed']}), {stats['mean_tokens_per_step']:.3f} tokens per "
              f"step (limit {SELF_DRAFT_MIN_ACCEPTANCE})")
    del engine, gen32, params
    gc_cuda()
    return {k: stats[k] for k in ("draft_tokens_proposed", "draft_tokens_accepted",
                                  "draft_acceptance_rate", "mean_tokens_per_step",
                                  "decode_steps")}


def spec_phase(tf, gen_mod, engine_mod, server_mod, fa, generator, engines, served, prompts):
    """Phase 16: speculation (K = 4) through the server on phase 4's
    weights and traffic: (a) continuous with prompt lookup, (b) paged over
    an int8 pool, (c) continuous with the target as its own draft; each
    request's tokens held to its solo run by phase 15's margin rule; then
    (e) one plain and one speculative continuous tick profiled, and spec
    ticks run with every synchronizing call but the tokens' transfer an
    error."""
    solo = engines.pop("solo")
    plain_tokens = engines.pop("continuous_tokens")
    out = {"seconds": {}}
    t0 = time.monotonic()

    def lap(name):
        nonlocal t0
        out["seconds"][name] = time.monotonic() - t0
        phase(16, f"16{name} took {out['seconds'][name]:.1f} s")
        t0 = time.monotonic()

    rec = serve_phase(server_mod, fa, generator, phase_no=16, engine="continuous", spec=SPEC_K)
    hold_to_solo(tf, generator, "16a continuous --speculative 4", rec, solo)
    rec["tokens_agreeing_with_phase_15"] = [
        next((t for t, (a, b) in enumerate(zip(ids, want)) if a != b), min(len(ids), len(want)))
        for (_, ids), want in zip(rec["results"][1:], plain_tokens)]
    out["continuous"] = rec
    lap("a")

    noise = int8_kv_noise(tf, generator, prompts[0])
    rec = serve_phase(server_mod, fa, generator, phase_no=16, engine="paged", spec=SPEC_K)
    rec["int8_kv_max_abs_dlogits"] = noise
    hold_to_solo(tf, generator, "16b paged int8 --speculative 4", rec, solo, floor=2 * noise)
    phase4 = {tuple(p): ids for p, ids in served["results"][1:]}
    held = {"results": [(None, None)] + [(p, phase4[tuple(p)]) for p, _ in rec["results"][1:]]}
    hold_to_solo(tf, generator, "16b phase 4's own tokens (paged int8, plain)", held, solo,
                 floor=2 * noise)
    rec["phase_4_tokens_agreeing_with_solo"] = held["tokens_agreeing_with_solo"]
    rec["tokens_agreeing_with_phase_4"] = [
        next((t for t, (a, b) in enumerate(zip(ids, phase4[tuple(p)])) if a != b),
             min(len(ids), len(phase4[tuple(p)])))
        for p, ids in rec["results"][1:]]
    phase(16, f"16b: int8 KV max|dlogits| at the prompt's last position {noise:.3e} (bound floor "
              f"{2 * noise:.3e}); tokens equal to phase 4's: {rec['tokens_agreeing_with_phase_4']}")
    out["paged_int8"] = rec
    lap("b")

    self_gen = gen_mod.Generator(generator.params, generator.config, generator.tokenizer,
                                 compute_dtype=generator.compute_dtype, device=DEVICE,
                                 draft_params=generator.params, draft_config=generator.config)
    check(self_gen.draft_params is self_gen.params and all(
        self_gen.params[k] is generator.params[k] for k in generator.params),
        "the self-draft holds a second copy of the weights")
    pending = record_rejections(self_gen)
    rec = serve_phase(server_mod, fa, self_gen, phase_no=16, engine="continuous", spec=SPEC_K)
    rejected = rejection_gaps(pending)
    del self_gen._spec_verify  # the class's own again
    hold_to_solo(tf, generator, "16c continuous self-draft", rec, solo)
    mc = generator.config
    want = (2 * mc.num_layers * SLOTS * KV_BUF_LEN * mc.num_kv_heads * mc.resolved_head_dim
            * torch.finfo(generator.compute_dtype).bits // 8)
    check(rec["draft_cache_bytes"] == want,
          f"draft cache {rec['draft_cache_bytes']} bytes != {want} (dense 8 x 4096 bf16)")
    # a draft equal to the target disagrees with the verify only where bf16
    # rounding can flip the argmax: every rejected draft must sit within
    # the margin rule's bound (the largest phase 15 and 16a-c measured) of
    # the verify's choice
    bounds = [at["bound"] for r in (engines["continuous"], out["continuous"], rec)
              for at in r["first_difference"] if at]
    gap_bound = max(bounds) if bounds else 0.0
    rec["rejected_drafts"] = len(rejected)
    rec["largest_rejection_gap"] = max(rejected, default=0.0)
    rec["rejection_gap_bound"] = gap_bound
    check(rec["largest_rejection_gap"] <= gap_bound,
          f"a self-draft was rejected where the verify preferred its own token by "
          f"{rec['largest_rejection_gap']:.3e} > the margin rule's {gap_bound:.3e}")
    phase(16, f"16c: {len(rejected)} rejected self-drafts (acceptance "
              f"{rec['draft_acceptance_rate']:.3f}), each where the verify's penalized logit of its "
              f"own token exceeds the draft's by at most {rec['largest_rejection_gap']:.3e} "
              f"(bound {gap_bound:.3e}: bf16 near-ties)")
    out["self_draft"] = rec
    out["self_draft_f32"] = self_draft_f32(gen_mod, engine_mod, generator, prompts)
    lap("c")
    for name in ("continuous", "paged_int8", "self_draft"):
        r = out[name]
        r.pop("results")
        phase(16, f"{name}: {r['tokens_per_s_concurrent']:.1f} tokens/s over the 4 concurrent "
                  f"requests' {r['window_s']:.3f} s window, engine TTFT mean "
                  f"{r['ttft_s_concurrent_mean']:.3f} s (warm-up {r['ttft_s_warmup']:.3f} s), "
                  f"mean decode tick {r['decode_step_ms_mean_concurrent']:.2f} ms, draft "
                  f"acceptance {r['draft_acceptance_rate']:.3f}, {r['mean_tokens_per_step']:.3f} "
                  f"tokens per step, repetitive question {r['repetitive']}"
                  + (f", draft cache {r['draft_cache_bytes']} bytes" if r["draft_cache_bytes"]
                     else ""))

    # (e) one plain and one speculative tick at 4 live rows of 8, profiled
    cache0, state0, live, _ = dense_slots(generator, prompts)
    plain = profile_ticks(lambda: generator.slot_step(cache0, state0, live), 5)
    cache, state, live, ctx = dense_slots(generator, prompts)

    def spec_tick():
        drafts, n_draft = lookup_drafts(engine_mod, ctx)
        toks, n_emit = generator.spec_slot_step(cache, state, live, drafts, n_draft)
        for slot in range(len(ctx)):
            ctx[slot] += toks[slot, : n_emit[slot]].tolist()
        return n_emit

    spec = profile_ticks(spec_tick, 5)
    emitted = spec_tick()[: len(prompts)]
    # host time spreads between calls: time both again in turns, spec then
    # plain, on the states already warm
    for name, rec, tick in (("speculative", spec, spec_tick),
                            ("plain", plain, lambda: generator.slot_step(cache0, state0, live))):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(5):
            tick()
        torch.cuda.synchronize()
        rec["step_ms_again"] = (time.monotonic() - t0) * 1e3 / 5
    del cache, state, cache0, state0
    for name, r in (("plain", plain), ("speculative", spec)):
        phase(16, f"16e {name} continuous tick at {len(prompts)} live rows of {SLOTS}: "
                  f"{r['step_ms']:.2f} ms, again {r['step_ms_again']:.2f} ms "
                  f"({r['profiled_step_ms']:.2f} ms profiled), device busy "
                  f"{100 * (r['device_busy_share'] or 0):.1f}%, {r['device_kernels_per_step']:.0f} "
                  f"device kernels and {r['device_ms_per_step']:.3f} ms of device time per tick")
        for row in r["top_kernels"]:
            phase(16, f"  {row['ms_per_step']:8.3f} ms/tick  {row['calls_per_step']:6.1f} calls  "
                      f"{row['name']}")
    out["tick_profile"] = {"plain": plain, "speculative": spec,
                           "tokens_per_tick_last": emitted.tolist()}

    # spec ticks with every synchronizing call but the transfer an error
    synced = {}
    cache, state, live, ctx = dense_slots(generator, prompts)
    drafts, n_draft = lookup_drafts(engine_mod, ctx)
    synced["dense_lookup"] = without_syncs(
        gen_mod, lambda: generator.spec_slot_step(cache, state, live, drafts, n_draft))[1]
    del cache, state
    cache, state, live, ctx = dense_slots(self_gen, prompts)
    dcache = self_gen.init_draft_slot_cache(SLOTS, KV_BUF_LEN)
    for slot, c in enumerate(ctx):
        padded = np.zeros((1, -(-(len(c) - 1) // PROMPT_BUCKET) * PROMPT_BUCKET), np.int64)
        padded[0, : len(c) - 1] = c[:-1]
        self_gen.draft_slot_prefill(dcache, padded, slot)
    window = np.zeros((SLOTS, SPEC_K + 1), np.int64)
    start = np.zeros((SLOTS,), np.int64)
    for slot, c in enumerate(ctx):
        start[slot] = len(c) - 1 - SPEC_K
        window[slot] = c[start[slot]:]
    n_draft = np.where(live, SPEC_K, 0)
    synced["dense_self_draft"] = without_syncs(gen_mod, lambda: self_gen.spec_slot_step(
        cache, state, live, self_gen.draft_slot_step(dcache, state, window, start), n_draft))[1]
    del cache, state, dcache
    pool, state, live, tables, _, ctx = paged_slots(generator, prompts, 5)
    drafts, n_draft = lookup_drafts(engine_mod, ctx)
    synced["paged_int8_lookup"] = without_syncs(
        gen_mod, lambda: generator.spec_paged_step(pool, state, live, tables, drafts, n_draft))[1]
    del pool, state
    synced = {k: v.tolist() for k, v in synced.items()}
    live_rows = len(prompts)
    check(all(1 <= n <= SPEC_K + 1 for v in synced.values() for n in v[:live_rows])
          and not any(n for v in synced.values() for n in v[live_rows:]),
          f"a spec tick emitted {synced}: each live slot 1..K+1 tokens, a dead one none")
    phase(16, f"spec ticks under set_sync_debug_mode('error') but for the tokens' transfer: "
              f"tokens per slot {synced}")
    out["sync_free_ticks"] = synced
    del self_gen
    gc_cuda()
    lap("e")
    return out


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


def paged_slots(generator, prompts, steps):
    """A fresh int8 pool of the main path's geometry with the prompts
    prefilled into slots 0..n-1 (greedy), blocks for ``steps`` + 2 more
    positions each: (pool, state, live, tables at the nb bucket, nb, each
    slot's tokens so far)."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    L = KV_BLOCK_LEN
    table_blocks = -(-(KV_BUF_LEN + PROMPT_BUCKET) // L)
    num_blocks = 1 + (SLOTS + 1) * table_blocks
    pool, state = generator.init_paged_state(SLOTS, num_blocks, L, kv_quant="int8")
    table = np.zeros((SLOTS, table_blocks), np.int32)
    greedy = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False)
    nxt = 1
    ctx = []
    for slot, p in enumerate(prompts):
        bucket = -(-len(p) // PROMPT_BUCKET) * PROMPT_BUCKET
        need = -(-(bucket + steps + 2) // L)
        table[slot, :need] = np.arange(nxt, nxt + need)
        nxt += need
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : len(p)] = p
        seen = np.zeros((1, generator.config.vocab_size), bool)
        seen[0, p] = True
        first = generator.paged_prefill_final(pool, state, table[slot: slot + 1], padded, 0,
                                              len(p), seen, slot, greedy, 0)
        ctx.append(list(p) + [first])
    live = np.arange(SLOTS) < len(prompts)
    in_use = max(-(-(len(p) + steps + 2) // L) for p in prompts)
    nb = 1 << (in_use - 1).bit_length()
    tables = np.ascontiguousarray(np.where(live[:, None], table, 0)[:, :nb])
    return pool, state, live, tables, nb, ctx


def profile_phase(generator, prompts, steps=5, phase_no=6):
    """Decode steps at the main path's occupancy (the prompts prefilled into
    slots 0..n-1 of a fresh int8 pool, the other slots dead), timed with a
    synchronize around them and then profiled: device time by kernel name
    and the device's busy share of the wall time."""
    pool, state, live, tables, nb, _ = paged_slots(generator, prompts, steps)
    result = {"steps": steps, "live_rows": len(prompts), "nb": nb,
              **profile_ticks(lambda: generator.paged_step(pool, state, live, tables), steps)}
    phase(phase_no, f"decode step at {len(prompts)} live rows, nb={nb}: {result['step_ms']:.2f} ms "
             f"({result['profiled_step_ms']:.2f} ms profiled), device busy "
             f"{100 * (result['device_busy_share'] or 0):.1f}%, "
             f"{result['device_kernels_per_step']:.0f} device kernels per step, "
             f"{result['device_ms_per_step']:.3f} ms of device time per step")
    for row in result["top_kernels"]:
        phase(phase_no, f"  {row['ms_per_step']:8.3f} ms/step  {row['calls_per_step']:6.1f} calls  {row['name']}")
    if not result["device_kernels_per_step"]:
        phase(phase_no, "the profiler recorded no device events")
    return result


def profile_ticks(tick, steps):
    """``tick()`` twice to warm up, ``steps`` times timed with a
    synchronize around them, then ``steps`` times under ``torch.profiler``:
    device time by kernel name and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        tick()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        tick()
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            tick()
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
    return {
        "step_ms": step_ms,
        "profiled_step_ms": wall_us / 1e3 / steps,
        "device_busy_share": busy / wall_us if events else None,
        "device_kernels_per_step": len(events) / steps,
        "device_ms_per_step": sum(b - a for _, a, b in events) / 1e3 / steps,
        "top_kernels": [
            {"name": name[:90], "ms_per_step": tot / 1e3 / steps, "calls_per_step": n / steps}
            for name, (tot, n) in top
        ],
    }


def dense_phase(tf, gen_mod, engine_mod, params_bf16, config, tokenizer, prompt_ids):
    """Phase 13: dense-cache greedy generation at full width in f32, held
    step by step against a no-cache forward and token by token against the
    paged engine on a bf16-layout pool."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    params = {k: v.float() for k, v in params_bf16.items()}
    greedy = GenerationConfig(max_new_tokens=DENSE_STEPS + 1, do_sample=False,
                              repetition_penalty=1.0)
    generator = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.float32,
                                  eos_token_ids=[], device=DEVICE)
    t0 = time.monotonic()
    dense = generator.generate_ids(prompt_ids, greedy)
    dense_s = time.monotonic() - t0
    check(len(dense) == DENSE_STEPS + 1, f"generate_ids gave {len(dense)} tokens")

    plen = len(prompt_ids)
    bucket = -(-plen // gen_mod._PROMPT_BUCKET) * gen_mod._PROMPT_BUCKET
    cache = tf.init_cache(config, 1, bucket + DENSE_STEPS + 1, dtype=torch.float32, device=DEVICE)
    padded = torch.zeros(1, bucket, dtype=torch.long, device=DEVICE)
    padded[0, :plen] = torch.tensor(prompt_ids, device=DEVICE)

    def last_logits(hidden, at):
        return tf.unembed(params, hidden[:, at], config, compute_dtype=torch.float32)[0]

    steps = []
    with torch.no_grad():
        hidden, _ = tf.forward(params, padded, config, cache=cache, cache_pos=0,
                               compute_dtype=torch.float32, output_hidden=True)
        cached = last_logits(hidden, plen - 1)
        for t in range(DENSE_STEPS + 1):
            if t:  # token t reads token t - 1 at position plen + t - 1
                tok = torch.tensor([[dense[t - 1]]], device=DEVICE)
                hidden, _ = tf.forward(params, tok, config, cache=cache, cache_pos=plen + t - 1,
                                       compute_dtype=torch.float32, output_hidden=True)
                cached = last_logits(hidden, -1)
            full = torch.tensor([list(prompt_ids) + dense[:t]], device=DEVICE)
            hidden, _ = tf.forward(params, full, config, compute_dtype=torch.float32,
                                   output_hidden=True)
            plain = last_logits(hidden, -1)
            top2 = torch.topk(cached, 2).values
            steps.append({"max_abs_dlogits": (cached - plain).abs().max().item(),
                          "max_abs_logits": plain.abs().max().item(),
                          "margin": (top2[0] - top2[1]).item(),
                          "argmax": int(cached.argmax())})
    for t, st in enumerate(steps):
        bound = LOGIT_REL_TOL * st["max_abs_logits"]
        check(st["max_abs_dlogits"] <= bound,
              f"dense step {t}: max|dlogits| {st['max_abs_dlogits']:.3e} > {bound:.3e}")
        check(st["argmax"] == dense[t], f"dense step {t}: argmax {st['argmax']} != {dense[t]}")
    phase(13, f"dense cache, f32, {plen}-token prompt: {DENSE_STEPS} decode steps, max|dlogits| "
              f"vs a no-cache forward {max(st['max_abs_dlogits'] for st in steps):.3e} (bound "
              f"{LOGIT_REL_TOL} x max|logit|, at least "
              f"{min(LOGIT_REL_TOL * st['max_abs_logits'] for st in steps):.3e}); "
              f"generate_ids {dense_s:.3f} s for {len(dense)} tokens")

    engine = engine_mod.PagedContinuousBatchingEngine(
        generator, slots=1, buf_len=2048, prompt_bucket=PROMPT_BUCKET, block_len=KV_BLOCK_LEN,
        prefill_chunk=PREFILL_CHUNK, kv_quant="none")
    try:
        paged = engine.submit(prompt_ids, greedy, timeout=600)
    finally:
        engine.close()
    agree = 0
    for t, (a, b) in enumerate(zip(dense, paged)):
        if a != b:  # the contexts differ from here on
            bound = 2 * LOGIT_REL_TOL * steps[t]["max_abs_logits"]
            check(steps[t]["margin"] <= bound,
                  f"step {t}: dense token {a} != paged {b} at top-2 margin "
                  f"{steps[t]['margin']:.3e} > {bound:.3e}")
            break
        agree += 1
    check(len(paged) == len(dense), f"paged engine gave {len(paged)} tokens")
    margin = min(st["margin"] for st in steps[:agree + 1])  # the steps compared
    phase(13, f"paged engine (f32, bf16-layout pool): {agree} of {len(dense)} tokens equal the "
              f"dense path's; smallest top-2 logit margin {margin:.3e}")
    del params, generator, cache
    return {"prompt_tokens": plen, "tokens": dense, "paged_tokens": paged,
            "tokens_agreeing": agree, "smallest_margin": margin, "steps": steps,
            "generate_ids_s": dense_s}


ASK_PATTERNS = {
    "load": r"Loaded in (\S+) s: (\d+) bytes of weights on .* memory_allocated \+(\d+) bytes",
    "answer": r"^Answer: (.*)$",
    "rate": r"^\[ask\] (\d+) tokens in (\S+) s \((\S+) tokens/s\)",
}


def ask_phase(cli_mod, model_dir):
    """Phase 14a: ``cli.ask_main`` on phase 8's ``best_model/``, greedy, in
    bf16 and with ``--quantize int8``; its output is echoed and parsed."""
    import contextlib
    import io
    import re

    out = {}
    for quantize in ("none", "int8"):
        argv = ["--model-dir", model_dir, "--greedy", "--max-new-tokens", str(MAX_NEW_TOKENS),
                "--quantize", quantize, QUESTIONS[0]]
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli_mod.ask_main(argv)
        wall = time.monotonic() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            phase(14, f"  | {line}")
        check(rc == 0, f"ask_main --quantize {quantize} returned {rc}")
        found = {k: re.search(p, text, re.M) for k, p in ASK_PATTERNS.items()}
        check(all(found.values()), f"ask_main --quantize {quantize}: output lacks "
                                   f"{[k for k, m in found.items() if not m]}")
        load_s, weight_bytes, allocated = found["load"].groups()
        tokens, gen_s, rate = found["rate"].groups()
        out[quantize] = {"load_s": float(load_s), "weight_bytes": int(weight_bytes),
                         "memory_allocated_bytes": int(allocated), "tokens": int(tokens),
                         "generate_s": float(gen_s), "tokens_per_s": float(rate),
                         "wall_s": wall, "answer": found["answer"].group(1)}
        gc_cuda()
        r = out[quantize]
        phase(14, f"ask --quantize {quantize}: load {r['load_s']:.3f} s, weights on the card "
                  f"{r['memory_allocated_bytes'] / 1e9:.3f} GB (memory_allocated; tensors "
                  f"{r['weight_bytes'] / 1e9:.3f} GB), {r['tokens']} tokens in "
                  f"{r['generate_s']:.3f} s ({r['tokens_per_s']:.2f} tokens/s), wall to the "
                  f"answer {wall:.3f} s")
    check(out["int8"]["memory_allocated_bytes"] <= INT8_WEIGHT_BYTES_MAX,
          f"int8 weights take {out['int8']['memory_allocated_bytes']} bytes > "
          f"{INT8_WEIGHT_BYTES_MAX:.3g}")
    return out


def ask_spec_phase(cli_mod, tf, gen_mod, model_dir, recorded, plain_generator):
    """Phase 16d: ``cli.ask_main`` on phase 8's ``best_model/`` with
    ``--speculative 4`` (prompt lookup), then with ``--draft-dir`` the same
    directory (a self-draft). ``recorded`` holds the (prompt, token ids) of
    every ``Generator.generate_ids`` call, phase 14's bf16 ask first, whose
    Generator is ``plain_generator``; each speculative answer's tokens are
    held to it, and where they differ, to the solo run by phase 15's margin
    rule."""
    import contextlib
    import io
    import re

    t_start = time.monotonic()
    plain_prompt, plain_ids = recorded[0]
    out = {}
    for label, extra in (("lookup", []), ("draft_dir", ["--draft-dir", model_dir])):
        n = len(recorded)
        argv = ["--model-dir", model_dir, "--greedy", "--max-new-tokens", str(MAX_NEW_TOKENS),
                "--speculative", str(SPEC_K)] + extra + [QUESTIONS[0]]
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli_mod.ask_main(argv)
        wall = time.monotonic() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            phase(16, f"  | {line}")
        check(rc == 0, f"ask_main --speculative ({label}) returned {rc}")
        ((prompt, ids),) = recorded[n:]
        check(prompt == plain_prompt, "the speculative ask built another prompt")
        rate = re.search(ASK_PATTERNS["rate"], text, re.M)
        spec = re.search(r"^\[speculative\] (\d+) sequential forwards, draft acceptance (\d+)%",
                         text, re.M)
        check(rate is not None and spec is not None, f"ask --speculative ({label}): output lacks "
                                                     "its [ask] or [speculative] line")
        out[label] = {"tokens": int(rate.group(1)), "generate_s": float(rate.group(2)),
                      "tokens_per_s": float(rate.group(3)), "wall_s": wall,
                      "sequential_forwards": int(spec.group(1)),
                      "acceptance_percent": int(spec.group(2)), "ids": ids}
        gc_cuda()
    solo = None
    for label, r in out.items():
        ids = r.pop("ids")
        agree = next((t for t, (a, b) in enumerate(zip(ids, plain_ids)) if a != b), None)
        if agree is None and len(ids) == len(plain_ids):
            r["tokens_agreeing_with_plain"] = len(ids)
        else:  # a difference: hold both to the solo run of the same weights
            if solo is None:
                solo = solo_decode(tf, gen_mod, plain_generator, plain_prompt, MAX_NEW_TOKENS)
                margin_agreement(tf, plain_generator, "16d plain ask", plain_prompt, plain_ids,
                                 solo)
            r["tokens_agreeing_with_solo"], r["first_difference"] = margin_agreement(
                tf, plain_generator, f"16d ask --speculative ({label})", plain_prompt, ids, solo)
            r["tokens_agreeing_with_plain"] = agree if agree is not None else min(
                len(ids), len(plain_ids))
        phase(16, f"16d ask --speculative {SPEC_K} ({label}): {r['tokens']} tokens in "
                  f"{r['generate_s']:.3f} s ({r['tokens_per_s']:.2f} tokens/s), wall to the answer "
                  f"{r['wall_s']:.3f} s, {r['sequential_forwards']} sequential forwards, draft "
                  f"acceptance {r['acceptance_percent']}%, tokens equal to the plain ask's "
                  f"{r['tokens_agreeing_with_plain']} of {len(plain_ids)}")
    out["seconds"] = time.monotonic() - t_start
    phase(16, f"16d took {out['seconds']:.1f} s")
    return out


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def int8_weights_serve_phase(tf, gen_mod, server_mod, fa, config, tokenizer, prompts):
    """Phase 14b: phase 4's random weights profiled as in phase 6 (the bf16
    baseline at this point of the run), then as weight-only int8 served
    from an int8 KV pool as in phase 4 and profiled again."""
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import maybe_quantize

    before = torch.cuda.memory_allocated()
    params = tf.init_params(config, seed=0, device=DEVICE, dtype=torch.bfloat16)
    generator = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.bfloat16,
                                  device=DEVICE)
    profiled_bf16 = profile_phase(generator, prompts, phase_no=14)
    del generator  # its dict holds the bf16 kernels that quantizing drops
    maybe_quantize(params, "int8")
    torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated() - before
    phase(14, f"smollm3_3b random weights, weight-only int8: {weight_bytes / 1e9:.3f} GB on the "
              f"card (memory_allocated)")
    generator = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.bfloat16,
                                  device=DEVICE)
    served = serve_phase(server_mod, fa, generator, phase_no=14)
    served["weight_bytes"] = weight_bytes
    phase(14, f"int8 weights: {served['tokens_per_s_concurrent']:.1f} tokens/s over the 4 "
              f"concurrent requests' {served['window_s']:.3f} s window, mean decode step "
              f"{served['decode_step_ms_mean']:.2f} ms, TTFT warm-up {served['ttft_s_warmup']:.3f} s, "
              f"concurrent mean {served['ttft_s_concurrent_mean']:.3f} s")
    profiled = profile_phase(generator, prompts, phase_no=14)
    del generator, params
    gc_cuda()
    return served, profiled, profiled_bf16


# ---------------------------------------------------------------------------
# phase 7: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

# the training smoke's attention shapes: SmolLM3-3B heads at seq 1024, one
# microbatch of 8 rows with ragged lengths, and one packed case
FLASH_SHAPE = dict(b=8, s=1024, hq=16, hkv=4, d=128)
FLASH_LENGTHS = (1024, 1000, 700, 513, 512, 300, 129, 1)
# f32 inputs (the CUDA-core kernels): the JAX package's own bands
# (tests/test_flash_attention.py), kernel against plain on the same inputs
FLASH_F32_TOL = {"o": 2e-5, "lse": 2e-5, "dq": 5e-5, "dk": 5e-5, "dv": 5e-5}
# bf16 inputs: the tensor-core kernels take P and dS as bf16 operands, so
# they are held as FlashAttention's own tests hold theirs: the max error
# against an f32 truth (the plain version on the inputs upcast) within 2x
# that of SDPA in bf16 on the same inputs, plus 1e-5. LSE's scores are exact
# bf16 products summed in f32, so only the order of the sum differs.
FLASH_SDPA_FACTOR, FLASH_SDPA_ATOL, FLASH_LSE_TOL = 2.0, 1e-5, 1e-4
# The same rule row by row (a row: the d entries of one position and head),
# so that small rows (dk/dv of late keys, O and dq of short segments) are held to
# their own scale: max|kernel - truth| over the row <= 2 x SDPA's in that row
# + half a bf16 ulp of the row's largest |truth| + 1e-5.
FLASH_ROW_HALF_ULP = 2.0**-8
# planted faults that the row rule must fail (bf16, ragged, d 128): dk/dv
# with the diagonal pair of one key tile dropped, dk without one query
# head's share; dq with the diagonal pair of one query tile dropped, and dq
# without one key tile's share
FLASH_FAULT_TILE, FLASH_FAULT_HEAD, FLASH_FAULT_KEY_TILE = 12, 1, 3
FLASH_TOLERANCE = ("bf16 tensor cores (flash_fwd, flash_bwd_dq, flash_bwd_dkv): O, dq, dk, dv "
                   "max|kernel - f32 truth| <= 2 x SDPA bf16's + 1e-5 over the tensor, and per row <= "
                   "2 x SDPA's in the row + 2**-8 x the row's max|truth| + 1e-5; LSE <= 1e-4; f32 "
                   "(CUDA cores): max|kernel - plain| <= 2e-5 (O, LSE), 5e-5 (dq, dk, dv)")
FLASH_DESIGN = {
    "flash_fwd": ("flash_fwd_tc_kernel", "bf16 mma.sync m16n8k16, cp.async ring, segment-aware "
                                         "tile skipping; f32: CUDA-core flash_fwd_kernel"),
    "flash_bwd_dq": ("flash_bwd_dq_tc_kernel", "bf16 mma.sync m16n8k16 (S, dP, dS K), cp.async "
                                               "ring, segment-aware tile skipping; f32: CUDA-core "
                                               "flash_bwd_dq_kernel"),
    "flash_bwd_dkv": ("flash_bwd_dkv_tc_kernel", "bf16 mma.sync m16n8k16, cp.async ring, "
                                                 "segment-aware tile skipping; f32: CUDA-core "
                                                 "flash_bwd_dkv_kernel"),
}


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


def flash_inputs(dtype, seed=0, b=None, d=None):
    shape = dict(FLASH_SHAPE, **({"b": b} if b else {}), **({"d": d} if d else {}))
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


def sdpa_bf16(q, k, v, do, seg):
    """The bf16 yardstick, never called by the port: O, dq and dk/dv (summed
    over each kv head's query group) of ``scaled_dot_product_attention`` in
    bf16 with the same boolean mask, in the port's layout, as f32."""
    import torch.nn.functional as F

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    causal = torch.ones(s, s, dtype=torch.bool, device=DEVICE).tril()
    mask = (causal & (seg[:, :, None] == seg[:, None, :]))[:, None]
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh = k.transpose(1, 2).repeat_interleave(groups, dim=1).detach().requires_grad_()
    vh = v.transpose(1, 2).repeat_interleave(groups, dim=1).detach().requires_grad_()
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    gq, gk, gv = torch.autograd.grad(out, (qh, kh, vh), do.transpose(1, 2))
    fold = lambda x: x.float().reshape(b, hkv, groups, s, d).sum(2).transpose(1, 2)  # noqa: E731
    return out.detach().transpose(1, 2).float(), gq.transpose(1, 2).float(), fold(gk), fold(gv)


def row_rule(got, truth, sdpa):
    """The SDPA-relative rule row by row (rows: the last dim): (rows beyond
    their limit, rows, the largest max|got - truth| / limit of a row)."""
    err = (got.float() - truth).abs().amax(-1)
    limit = (FLASH_SDPA_FACTOR * (sdpa - truth).abs().amax(-1)
             + FLASH_ROW_HALF_ULP * truth.abs().amax(-1) + FLASH_SDPA_ATOL)
    return int((err > limit).sum()), err.numel(), float((err / limit).max())


def fault_caught(fault, name, faulty, truth, sdpa, label):
    """The row rule on one planted fault of output ``name``: a record; fails
    unless at least one row is over its limit."""
    over, rows, worst = row_rule(faulty, truth, sdpa)
    whole = (faulty - truth).abs().max().item()
    whole_limit = FLASH_SDPA_FACTOR * (sdpa - truth).abs().max().item() + FLASH_SDPA_ATOL
    check(over > 0, f"flash {label}: the row rule passes the planted fault '{fault}' on {name}")
    phase(7, f"{label} planted fault '{fault}' on {name}: the row rule fails it ({over} of "
             f"{rows} rows over, worst {worst:.1f}x its limit); the whole-tensor rule "
             f"{'fails' if whole > whole_limit else 'passes'} it ({whole:.3e} vs {whole_limit:.3e})")
    return {"rows_over": over, "rows": rows, "worst_row_ratio": worst,
            "whole_tensor_rule_fails": whole > whole_limit}


def planted_faults(fa, inputs32, seg, lse32, o32, truth, got, sdpa, label):
    """Faults that the row rule must fail, made from the kernels' own outputs
    plus the exact change a fault makes to the f32 truth. dk/dv: (1) the
    diagonal pair of key tile FLASH_FAULT_TILE dropped (dk, dv of its keys
    lose the queries of the same tile: their dO zeroed in the truth), (2) dk
    without query head FLASH_FAULT_HEAD's share. dq: (3) the diagonal pair of
    query tile FLASH_FAULT_TILE dropped and (4) the share of key tile
    FLASH_FAULT_KEY_TILE dropped (that key tile's K zeroed in the truth,
    whose LSE and delta are given: its keys then add nothing to dq, and no
    other key's term changes; (3) keeps the change on the tile's own query
    rows only). Returns {kernel: [one record per fault]}; fails unless the
    row rule catches each."""
    q32, k32, v32, do32 = inputs32
    tile_of = lambda t: slice(t * fa.FLASH_TILE, (t + 1) * fa.FLASH_TILE)  # noqa: E731
    tile = tile_of(FLASH_FAULT_TILE)
    drop_tile = do32.clone()
    drop_tile[:, tile] = 0
    drop_head = do32.clone()
    drop_head[:, :, FLASH_FAULT_HEAD] = 0
    out = {"flash_bwd_dkv": [], "flash_bwd_dq": []}
    for fault, do_f, names in (
            (f"diagonal pair of key tile {FLASH_FAULT_TILE} dropped", drop_tile, ("dk", "dv")),
            (f"query head {FLASH_FAULT_HEAD}'s share of dk dropped", drop_head, ("dk",))):
        changed = dict(zip(("dk", "dv"), fa.flash_bwd_dkv_reference(
            q32, k32, v32, seg, lse32, fa.flash_delta(o32, do_f), do_f)))
        rec = {"fault": fault, "outputs": list(names)}
        for name in names:
            shift = changed[name] - truth[name]
            if "tile" in fault:  # only the tile's own keys lose the pair
                keep = torch.zeros_like(shift)
                keep[:, tile] = shift[:, tile]
                shift = keep
            rec[name] = fault_caught(fault, name, got[name].float() + shift, truth[name],
                                     sdpa[name], label)
        out["flash_bwd_dkv"].append(rec)
    delta32 = fa.flash_delta(o32, do32)
    for fault, t, own_rows in (
            (f"diagonal pair of query tile {FLASH_FAULT_TILE} dropped", FLASH_FAULT_TILE, True),
            (f"key tile {FLASH_FAULT_KEY_TILE}'s share of dq dropped", FLASH_FAULT_KEY_TILE, False)):
        k_drop = k32.clone()
        k_drop[:, tile_of(t)] = 0
        shift = fa.flash_bwd_dq_reference(q32, k_drop, v32, seg, lse32, delta32, do32) - truth["dq"]
        if own_rows:  # only the tile's own queries lose the pair
            keep = torch.zeros_like(shift)
            keep[:, tile_of(t)] = shift[:, tile_of(t)]
            shift = keep
        out["flash_bwd_dq"].append({"fault": fault, "outputs": ["dq"], "dq": fault_caught(
            fault, "dq", got["dq"].float() + shift, truth["dq"], sdpa["dq"], label)})
    return out


def flash_check(fa, dtype, kind, d=None, faults=None):
    """The flash kernels on one case; returns {output: max|d|}. f32: each
    kernel against its plain version on the same inputs (the backward kernels
    get the plain forward's LSE and delta), within FLASH_F32_TOL. bf16: the
    chain the training path runs (the kernels' own LSE and delta), O, LSE,
    dq, dk and dv against the f32 truth by the SDPA-relative rule over the
    whole tensor and row by row; at the ragged d-128 case the planted faults
    are added to ``faults`` ({kernel: [records]})."""
    q, k, v, do = flash_inputs(dtype, seed=1 if kind == "packed" else 0, d=d)
    seg = flash_segments_case(kind, q.shape[0], q.shape[1])
    label = f"{kind} {str(dtype).split('.')[-1]} d={q.shape[-1]}"
    errs = {}
    if dtype == torch.float32:
        o, lse = fa.flash_fwd(q, k, v, seg)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, seg)
        delta = fa.flash_delta(o_ref, do)
        dq = fa.flash_bwd_dq(q, k, v, seg, lse_ref, delta, do)
        dk, dv = fa.flash_bwd_dkv(q, k, v, seg, lse_ref, delta, do)
        torch.cuda.synchronize()
        dq_ref = fa.flash_bwd_dq_reference(q, k, v, seg, lse_ref, delta, do)
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, seg, lse_ref, delta, do)
        for name, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                               ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            check(bool(torch.isfinite(got).all()), f"flash {label} {name}: not finite")
            err = (got - ref).abs().max().item()
            check(err <= FLASH_F32_TOL[name], f"flash {label} {name}: max|kernel-plain| {err:.3e} > "
                                              f"{FLASH_F32_TOL[name]}")
            errs[name] = err
            phase(7, f"{label} {name}: max|kernel-plain| {err:.3e}, max|plain| "
                     f"{ref.abs().max().item():.3e}")
        return errs
    o, lse = fa.flash_fwd(q, k, v, seg)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, seg, lse, delta, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do)
    torch.cuda.synchronize()
    for name, got in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
        check(bool(torch.isfinite(got).all()), f"flash {label} {name}: not finite")
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = fa.flash_attention_fwd_reference(q32, k32, v32, seg)
    delta32 = fa.flash_delta(o32, do32)
    dq32 = fa.flash_bwd_dq_reference(q32, k32, v32, seg, lse32, delta32, do32)
    dk32, dv32 = fa.flash_bwd_dkv_reference(q32, k32, v32, seg, lse32, delta32, do32)
    del delta32
    errs["lse"] = (lse - lse32).abs().max().item()
    check(errs["lse"] <= FLASH_LSE_TOL, f"flash {label} lse: max|kernel - f32 truth| {errs['lse']:.3e} "
                                        f"> {FLASH_LSE_TOL}")
    phase(7, f"{label} lse: max|kernel - f32 truth| {errs['lse']:.3e} (limit {FLASH_LSE_TOL})")
    sdpa = dict(zip(("o", "dq", "dk", "dv"), sdpa_bf16(q, k, v, do, seg)))
    truth = {"o": o32, "dq": dq32, "dk": dk32, "dv": dv32}
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    for name in ("o", "dq", "dk", "dv"):
        err = (got[name].float() - truth[name]).abs().max().item()
        ref_err = (sdpa[name] - truth[name]).abs().max().item()
        limit = FLASH_SDPA_FACTOR * ref_err + FLASH_SDPA_ATOL
        check(err <= limit, f"flash {label} {name}: max|kernel - f32 truth| {err:.3e} > "
                            f"{FLASH_SDPA_FACTOR} x SDPA's {ref_err:.3e} + {FLASH_SDPA_ATOL}")
        over, rows, worst = row_rule(got[name], truth[name], sdpa[name])
        check(over == 0, f"flash {label} {name}: {over} of {rows} rows beyond 2 x SDPA's error in the "
                         f"row + 2**-8 x the row's max|truth| + 1e-5 (worst {worst:.2f}x the limit)")
        errs[name] = err
        errs[f"{name}_sdpa"] = ref_err
        errs[f"{name}_worst_row_ratio"] = worst
        phase(7, f"{label} {name}: max|kernel - f32 truth| {err:.3e}, SDPA bf16 {ref_err:.3e} "
                 f"({err / ref_err:.2f}x; limit {limit:.3e}), max|truth| "
                 f"{truth[name].abs().max().item():.3e}; per row at most {worst:.2f}x the row limit")
    if faults is not None and kind == "ragged" and q.shape[-1] == FLASH_SHAPE["d"]:
        faults.update(planted_faults(fa, (q32, k32, v32, do32), seg, lse32, o32, truth, got, sdpa,
                                     label))
    return errs


def sdpa_times(q, k, v, do, seg, spin=True):
    """The library yardstick, never called by the port:
    ``scaled_dot_product_attention`` with the same boolean mask, forward and
    (under autograd) its backward, on head-major copies of the inputs
    (``spin``: as in ``time_ms``)."""
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
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask), spin=spin)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                     spin=spin)
    return fwd_ms, bwd_ms


def count_tile_visits(fa, q, k, v, do, seg):
    """{kernel: int32 [b, n, n]}: the tile pairs the bf16 forward, dq and
    dk/dv kernels compute on these inputs, counted by the kernels themselves
    (one per query head and pair), and ``flash_tile_pairs``' prediction of
    the same count; fails unless they agree pair by pair."""
    b, s, hq = q.shape[:3]
    n = -(-s // fa.FLASH_TILE)
    visits = {name: torch.zeros(b, n, n, dtype=torch.int32, device=DEVICE)
              for name in FLASH_DESIGN}
    o, lse = fa.flash_fwd(q, k, v, seg, tile_visits=visits["flash_fwd"])
    delta = fa.flash_delta(o, do)
    fa.flash_bwd_dq(q, k, v, seg, lse, delta, do, tile_visits=visits["flash_bwd_dq"])
    fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do, tile_visits=visits["flash_bwd_dkv"])
    predicted = fa.flash_tile_pairs(seg).to(torch.int32) * hq
    for name, counted in visits.items():
        wrong = int((counted != predicted).sum())
        check(wrong == 0, f"{name}: the kernel's own tile-pair count differs from flash_tile_pairs at "
                          f"{wrong} of {counted.numel()} (row, query tile, key tile)")
    return {**visits, "predicted": predicted}


def flash_kernel_phase(fa, peaks):
    """Phase 7: correctness in f32 (d 128) and bf16 (d 128 and 64) on ragged
    and packed segments with planted faults, the tile pairs the kernels
    compute (their own count), then times at the training smoke's shapes in
    bf16 (ragged), and again with every row one segment (the causal pairs
    only: nothing for the segment rule to skip)."""
    errs = {torch.float32: {}, torch.bfloat16: {}}
    faults: dict = {}
    cases = [(torch.float32, kind, None) for kind in ("ragged", "packed")]
    cases += [(torch.bfloat16, kind, d) for d in (128, 64) for kind in ("ragged", "packed")]
    for dtype, kind, d in cases:
        for name, err in flash_check(fa, dtype, kind, d, faults).items():
            errs[dtype][name] = max(errs[dtype].get(name, 0.0), err)
    q, k, v, do = flash_inputs(torch.bfloat16)
    b, s, hq = q.shape[:3]
    seg = flash_segments_case("ragged", b, s)
    n = -(-s // fa.FLASH_TILE)
    counted = count_tile_visits(fa, q, k, v, do, seg)
    visited = {name: int(counted[name].sum()) for name in FLASH_DESIGN}
    causal = b * n * (n + 1) // 2 * hq
    phase(7, f"tile pairs computed (ragged, b={b}, {hq} query heads), counted by the kernels: "
             + ", ".join(f"{FLASH_DESIGN[name][0]} {visited[name]}" for name in FLASH_DESIGN)
             + f" of {causal} under the causal limit ({100 * visited['flash_fwd'] / causal:.1f}%); "
             f"flash_tile_pairs predicts {int(counted['predicted'].sum())}, equal pair by pair")
    o, lse = fa.flash_fwd(q, k, v, seg)
    delta = fa.flash_delta(o, do)
    one = torch.ones_like(seg)  # every row one segment: the causal pairs only
    o1, lse1 = fa.flash_fwd(q, k, v, one)
    delta1 = fa.flash_delta(o1, do)
    no_skip = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, one),
               "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, one, lse1, delta1, do),
               "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, one, lse1, delta1, do)}
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
    smem = fa.flash_tc_smem_bytes(q.shape[-1], q.shape[1])
    phase(7, f"shared memory per block at d={q.shape[-1]} s={q.shape[1]}: "
             + ", ".join(f"{FLASH_DESIGN[name][0]} {smem[name]} B" for name in FLASH_DESIGN))
    record = {}
    for name, (kernel, plain) in timed.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        bound_ms, bound_by, flops, nbytes = bounds[name]
        library_ms = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms
        outputs = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
                   "flash_bwd_dkv": ("dk", "dv")}[name]
        err = {dtype: max(e[o] for o in outputs) for dtype, e in errs.items()}
        tflops = flops / (ms * 1e-3) / 1e12
        record[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms,
                        "max_abs_err": err[torch.bfloat16], "max_abs_err_f32": err[torch.float32],
                        "flops": flops, "bytes": nbytes, "tflops_on_visible_pairs": tflops,
                        "fraction_of_bound": bound_ms / ms}
        one_ms = time_ms(no_skip[name])
        record[name].update({"smem_bytes_per_block": smem[name],
                             "tile_pairs_visited": visited[name],
                             "tile_pairs_predicted": int(counted["predicted"].sum()),
                             "tile_pairs_causal": causal,
                             "ms_one_segment_per_row": one_ms,
                             "max_abs_err_sdpa_bf16": max(errs[torch.bfloat16][f"{o}_sdpa"]
                                                          for o in outputs if o != "lse"),
                             "worst_row_ratio": max(errs[torch.bfloat16][f"{o}_worst_row_ratio"]
                                                    for o in outputs if o != "lse"),
                             **({"planted_faults": faults[name]} if name in faults else {})})
        phase(7, f"{name}: {ms:.3f} ms on the ragged rows ({visited[name]} tile pairs) vs "
                 f"{one_ms:.3f} ms with every row one segment ({causal}, nothing to skip)")
        phase(7, f"{name} bf16 b=8 s=1024 hq=16 hkv=4 d=128 ragged: kernel {ms:.3f} ms "
                 f"({tflops:.1f} TFLOP/s on the visible pairs, {100 * bound_ms / ms:.1f}% of the "
                 f"bound), plain {plain_ms:.3f} ms, SDPA "
                 f"{'forward' if name == 'flash_fwd' else 'backward'} {library_ms:.3f} ms, bound "
                 f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
                 f"{ms / library_ms:.2f}x SDPA")
    return record


# ---------------------------------------------------------------------------
# phases 8-9: SFT training of SmolLM3-3B through the port's trainer
# ---------------------------------------------------------------------------

TRAIN_ROWS = 120  # -> 108 train rows, 12 validation rows, 3 steps of 32
# losses at steps 1-3 and the eval loss of phases 8 and 11 as the CUDA-core
# flash kernels gave them (H100, the same seeds and data); the tensor-core
# kernels round P and dS to bf16, and must stay within 0.5% of these
RECORDED_LOSSES = {8: ([12.327, 11.561, 11.072], 10.772), 11: ([12.331, 11.684, 11.246], 10.986)}
LOSS_RECORDED_REL_TOL = 5e-3
# phase 11's peak memory at the last step (28.03 GB with N-major codes): K-major
# codes must come with no second copy of the trunk
INT8_TRUNK_PEAK_BYTES = 28.5e9
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
    if n_int8:  # the layout the w8a8 kernel reads: [in, out] with strides (1, in)
        codes = {k: v for k, v in trainer.state.frozen.items() if k.endswith(".kernel_int8")}
        not_kmajor = [k for k, v in codes.items() if v.stride() != (1, v.shape[0])]
        check(not not_kmajor, f"trunk codes not K-major: {not_kmajor[:3]}")
        phase(phase_no, f"all {len(codes)} trunk code leaves are K-major ([in, out], strides (1, in))")
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
    recorded, recorded_eval = RECORDED_LOSSES[phase_no]
    rel = [abs(a - b) / b for a, b in zip(losses[:3] + [summary["final_eval_loss"]],
                                          recorded + [recorded_eval])]
    record["loss_rel_to_recorded"] = rel
    phase(phase_no, f"losses at steps 1-3 and eval {[round(x, 4) for x in losses[:3]]}, "
                    f"{summary['final_eval_loss']:.4f} vs the CUDA-core kernels' recorded {recorded}, "
                    f"{recorded_eval}: relative {[f'{r:.2e}' for r in rel]}")
    check(len(losses) >= 3 and max(rel) <= LOSS_RECORDED_REL_TOL,
          f"losses {losses[:3]} / eval {summary['final_eval_loss']} beyond {LOSS_RECORDED_REL_TOL} "
          f"of the recorded {recorded} / {recorded_eval}")
    if trunk:
        check(train_peak <= INT8_TRUNK_PEAK_BYTES, f"int8-trunk peak memory {train_peak / 1e9:.2f} GB > "
                                                   f"{INT8_TRUNK_PEAK_BYTES / 1e9} GB")
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


def real_batch_tiles(fa, trainer):
    """The tile pairs the tensor-core kernels compute on the training rows'
    own padding: every microbatch of the train split in order, at the
    model's attention shapes (random bf16 q/k/v/dO: the walk depends on the
    segments only), counted by the kernels and checked pair by pair against
    ``flash_tile_pairs``."""
    mc = trainer.model_config
    mask = trainer.train_arrays["attention_mask"]
    rows = trainer.config.per_device_batch_size
    s, hq, hkv, d = mask.shape[1], mc.num_heads, mc.num_kv_heads, mc.resolved_head_dim
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    q, do = (torch.randn(rows, s, hq, d, generator=gen, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(rows, s, hkv, d, generator=gen, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    n = -(-s // fa.FLASH_TILE)
    visited = causal = 0
    batches = 0
    for r0 in range(0, len(mask), rows):
        seg = torch.from_numpy(mask[r0: r0 + rows]).to(DEVICE, torch.int32)
        m = seg.shape[0]
        counted = count_tile_visits(fa, q[:m], k[:m], v[:m], do[:m], seg)
        visited += int(counted["flash_fwd"].sum())
        causal += m * n * (n + 1) // 2 * hq
        batches += 1
    real = float(mask.sum()) / mask.size
    phase(8, f"tile pairs the kernels computed on the {len(mask)} train rows' own padding ({batches} "
             f"microbatches, {100 * real:.1f}% real tokens): {visited} of {causal} under the causal "
             f"limit ({100 * visited / causal:.1f}%), equal pair by pair to flash_tile_pairs")
    return {"rows": len(mask), "microbatches": batches, "real_token_share": real,
            "tile_pairs_visited": visited, "tile_pairs_causal": causal}


def skipping_ab(loss_fn, trainer, batch, params):
    """One microbatch as the trainer runs it, and the same microbatch with
    every token marked real (the same work except that the segment rule has
    nothing to skip; the loss differs): flash kernels' and all device time
    (one profile each) and wall time (median of 3 unprofiled runs, each
    ended by a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, mb in (("own_padding", batch),
                      ("all_real", {**batch, "attention_mask": torch.ones_like(batch["attention_mask"])})):
        def run(mb=mb):
            loss, _ = loss_fn(trainer.state.trainable, trainer.state.frozen, mb)
            torch.autograd.grad(loss, params)
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = _device_events(prof)
        out[label] = {"wall_ms_median": statistics.median(walls), "wall_ms": walls,
                      "flash_ms": sum(b - a for name, a, b in events if "flash_" in name) / 1e3,
                      "device_ms": sum(b - a for _, a, b in events) / 1e3}
    own, allr = out["own_padding"], out["all_real"]
    phase(8, f"segment-aware skipping on this microbatch: flash kernels {own['flash_ms']:.1f} ms vs "
             f"{allr['flash_ms']:.1f} ms with every token marked real, device time "
             f"{own['device_ms']:.1f} vs {allr['device_ms']:.1f} ms, wall (median of 3) "
             f"{own['wall_ms_median']:.1f} vs {allr['wall_ms_median']:.1f} ms")
    return out


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
    per_flash = {}
    for kernel in (design[0] for design in FLASH_DESIGN.values()):
        rows = [(t, c) for name, (t, c) in by_name.items() if f"{kernel}<" in name]
        per_flash[kernel] = {"ms": sum(t for t, _ in rows) / 1e3, "calls": sum(c for _, c in rows)}
        check(bool(rows), f"the profiled microbatch ran no {kernel}")
    result = {
        "flash_kernels": per_flash,
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
    phase(phase_no, "flash kernels on the main path: " + ", ".join(
        f"{k} {v['ms']:.1f} ms in {v['calls']} calls" for k, v in per_flash.items()))
    for row in result["top_kernels"]:
        phase(phase_no, f"  {row['ms']:8.3f} ms  {row['calls']:5d} calls  {row['name']}")
    if not events:
        phase(phase_no, "the profiler recorded no device events")
    if not trunk:  # what the segment rule skips on the training data, and what it saves
        from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa

        result["real_batch_tiles"] = real_batch_tiles(fa, trainer)
        result["skipping_ab"] = skipping_ab(loss_fn, trainer, batch, params)
    return result


# ---------------------------------------------------------------------------
# phase 10: the w8a8 int8 matmul against its plain version
# ---------------------------------------------------------------------------

# the frozen trunk's projections at the recipe's microbatch (8 x 1024 rows):
# (name, K, N, projections of this shape per layer)
W8A8_M = 8192
W8A8_SHAPES = (("q_proj/o_proj", 2048, 2048, 2), ("k_proj/v_proj", 2048, 512, 2),
               ("gate_proj/up_proj", 2048, 11008, 2), ("down_proj", 11008, 2048, 1))
# extra cases: an f32 output, ragged M and N, K off the kernel's 128-byte
# step (the last step zero-filled), and K off 16 (byte loads in place of
# cp.async)
W8A8_EXTRA = (("f32 q_proj", 8192, 2048, 2048, torch.float32),
              ("ragged gate_proj", 1000, 2048, 11008, torch.bfloat16),
              ("ragged N=100", 1000, 2048, 100, torch.bfloat16),
              ("ragged K=2000", 1000, 2000, 2048, torch.bfloat16),
              ("ragged K=2004", 1000, 2004, 257, torch.bfloat16))
INT8_OPS_PER_S = 1979e12  # H100 SXM5 data sheet, dense int8 tensor-core rate
W8A8_TOLERANCE = "bitwise (torch.equal): the int32 sum is exact and both round once"


def w8a8_inputs(m, k, n, seed=0):
    """Trunk-like operands made on the card: activations quantized per row,
    a 0.02-scale weight quantized per column, its codes K-major as the trunk
    keeps them."""
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import quantize_int8
    from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import kmajor, quantize_rows_int8

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=DEVICE).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=DEVICE).mul_(0.02)
    q = quantize_int8(w)
    xq, xs = quantize_rows_int8(x)
    return x, w.to(torch.bfloat16), xq, xs, kmajor(q["int8"]), q["int8_scale"]


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
    ``torch._int_mm`` on the same K-major codes (int8 x int8 -> int32 only:
    no row/column scales, no cast) and a bf16 ``torch.matmul`` of the same
    shape (the bf16 trunk's projection). Returns the kernels-line record:
    times summed over one trunk layer's 7 projections."""
    shapes = []
    for name, k, n, count in W8A8_SHAPES:
        shapes.append((name, W8A8_M, k, n, torch.bfloat16, count))
    shapes += [(name, m, k, n, dt, 0) for name, m, k, n, dt in W8A8_EXTRA]
    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "bf16_matmul_ms": 0.0, "quantize_rows_ms": 0.0}
    per_shape = []
    for i, (name, m, k, n, dt, count) in enumerate(shapes):
        x, w, xq, xs, wq, ws = w8a8_inputs(m, k, n, seed=i)
        check(wq.stride() == (1, k), f"w8a8 {name}: codes not K-major, strides {wq.stride()}")
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
            row["bf16_matmul_ms"] = time_ms(lambda: x @ w)
            row["quantize_rows_ms"] = time_ms(lambda: mm.quantize_rows_int8(x))
            for key in layer:
                layer[key] = None if None in (layer[key], row[key]) else layer[key] + count * row[key]
            phase(10, f"{name} M={m} K={k} N={n} bf16: kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, torch._int_mm {row['library_ms']} ms, bf16 "
                      f"matmul {row['bf16_matmul_ms']:.4f} ms, row quantization "
                      f"{row['quantize_rows_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                      f"{2 * m * n * k / 1e9:.0f} GOP, {nbytes / 1e6:.1f} MB); bitwise equal")
        else:
            phase(10, f"{name} M={m} K={k} N={n} {row['dtype']}: bitwise equal to plain")
        per_shape.append(row)
        del x, w, xq, xs, wq, ws
    phase(10, f"one trunk layer (7 projections at M={W8A8_M}): kernel {layer['ms']:.3f} ms, plain "
              f"{layer['plain_ms']:.3f} ms, torch._int_mm {layer['library_ms']} ms, bf16 "
              f"matmul {layer['bf16_matmul_ms']:.3f} ms, bound {layer['bound_ms']:.3f} ms; row "
              f"quantization of the 7 inputs {layer['quantize_rows_ms']:.3f} ms")
    return {**layer, "bound_by": "operations", "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "shapes": per_shape}


def kernel_entry(name, source, replaces, launches, rec):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **{k: rec[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def ptxas_report(log):
    """{kernel<D>: {"registers", "spill_stores"}} from one library's
    ``-Xptxas -v`` report (the entry functions' mangled names carry the
    kernel's name and its head-dim template argument)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+((?:flash|paged|w8a8)\w*?kernel)", mangled)
            dim = re.search(r"Li(\d+)E", mangled)
            name = (base.group(1) if base else mangled) + (f"<{dim.group(1)}>" if dim else "")
            if "IfLi" in mangled:
                name += " f32"
            elif "I13__nv_bfloat16Li" in mangled:
                name += " bf16"
            out[name] = {}
        elif name and "spill stores" in line:
            out[name]["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def w8a8_layer_ms(mm, freeze, spin=True):
    """One trunk layer's 7 projections at M = W8A8_M (W8A8_SHAPES, each
    distinct shape timed once) through ``w8a8_matmul``, on codes made by
    ``freeze.quantize_trunk_int8`` of the checkout at hand (its own layout):
    {"ms": the layer's sum, "kmajor": whether every code leaf is K-major}."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    frozen = {f"model.layers.0.p{i}.kernel": torch.randn(k, n, generator=gen, device=DEVICE).mul_(0.02)
              for i, (_, k, n, _) in enumerate(W8A8_SHAPES)}
    quantized, n_quant = freeze.quantize_trunk_int8(frozen, 1)
    check(n_quant == len(W8A8_SHAPES), f"quantize_trunk_int8 quantized {n_quant} kernels")
    total, kmajor = 0.0, True
    for i, (_, k, n, count) in enumerate(W8A8_SHAPES):
        wq = quantized[f"model.layers.0.p{i}.kernel_int8"]
        ws = quantized[f"model.layers.0.p{i}.kernel_int8_scale"]
        kmajor = kmajor and wq.stride() == (1, k)
        xq, xs = mm.quantize_rows_int8(torch.randn(W8A8_M, k, generator=gen, device=DEVICE)
                                       .to(torch.bfloat16))
        total += count * time_ms(lambda: mm.w8a8_matmul(xq, xs, wq, ws, torch.bfloat16), spin=spin)
    return {"ms": total, "kmajor": kmajor}


def flash_ab_times(tree: str) -> dict:
    """``--flash-ab``: the times of one checkout's flash and w8a8 kernels (in
    a process of its own: every checkout's package has one name)."""
    import os

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
    from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as mm
    from llm_fine_tune_distributed_tpu_torch.parallel import freeze

    for mod in (fa, mm, freeze):
        check(os.path.abspath(mod.__file__).startswith(tree + os.sep),
              f"imported {mod.__file__}, not the checkout at {tree}")
    out = {"tree": tree, "card": card_info(), "torch": torch.__version__}
    _build.build_all(("paged_decode", "flash_fwd", "flash_bwd", "w8a8_matmul"))
    out["spin_cycles"], out["spin_ms"] = calibrate_spin()
    _, live = live_lengths(ByteChatMLTokenizer, WILDERNESS_EXPERT_SYSTEM_PROMPT)
    for spin in (True, False):
        for name, ms in paged_ms(fa, live, spin=spin).items():
            out[f"paged_decode/{name}/{'spin' if spin else 'no_spin'}"] = ms
    q, k, v, do = flash_inputs(torch.bfloat16)
    ragged = flash_segments_case("ragged", q.shape[0], q.shape[1])
    for label, seg in (("ragged", ragged), ("one_segment", torch.ones_like(ragged))):
        o, lse = fa.flash_fwd(q, k, v, seg)
        delta = fa.flash_delta(o, do)
        kernels = {
            "flash_fwd": lambda: fa.flash_fwd(q, k, v, seg),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, seg, lse, delta, do),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do),
        }
        for spin in (True, False):
            method = "spin" if spin else "no_spin"
            for name, fn in kernels.items():
                out[f"{label}/{name}/{method}"] = time_ms(fn, spin=spin)
            if label == "ragged":
                fwd_ms, bwd_ms = sdpa_times(q, k, v, do, seg, spin=spin)
                out[f"ragged/sdpa_forward/{method}"] = fwd_ms
                out[f"ragged/sdpa_backward/{method}"] = bwd_ms
    del q, k, v, do
    for spin in (True, False):
        layer = w8a8_layer_ms(mm, freeze, spin=spin)
        out[f"w8a8_layer/{'spin' if spin else 'no_spin'}"] = layer["ms"]
        out["w8a8_codes_kmajor"] = layer["kmajor"]
    return out


def flash_ab(trees) -> int:
    """``--flash-ab DIR [DIR ...]``: each checkout timed in its own process,
    in the order given."""
    import os

    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--flash-ab-one", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            print(f"chip_smoke --flash-ab: timing {tree} failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 0


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible to torch; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--flash-ab"] and len(argv) > 1:
        return flash_ab(argv[1:])
    if argv[:1] == ["--flash-ab-one"] and len(argv) == 2:
        print(json.dumps(flash_ab_times(argv[1])), flush=True)
        return 0
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    import os
    import shutil
    import tempfile

    from llm_fine_tune_distributed_tpu_torch import cli as cli_mod
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer import engine as engine_mod
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
    cycles, spin_ms = calibrate_spin()
    phase(1, f"timing spin: torch.cuda._sleep({cycles}) = {spin_ms:.3f} ms by CUDA events "
             f"(target {SPIN_MS} ms)")

    t0 = time.monotonic()
    sources = ("paged_decode", "flash_fwd", "flash_bwd", "w8a8_matmul")
    _build.build_all(sources)  # one nvcc per source, all at once
    build_s = time.monotonic() - t0
    phase(2, f"{', '.join(sources)} ready in {build_s:.1f} s")
    ptxas = {}
    for name in sources:  # the report kept beside each library, built now or before
        report = ptxas_report(_build.ptxas_log(name))
        ptxas.update(report)
        built = _build.build_log.get(name)
        phase(2, f"  {name}: " + (f"built in {built['seconds']:.1f} s" if built else "already in build/"))
        for kernel, info in sorted(report.items()):
            phase(2, f"    {kernel}: {info.get('registers')} registers per thread, "
                     f"{info.get('spill_stores')} bytes of spill stores")
    tensor_core = [f"{design[0]}<{d}>" for design in FLASH_DESIGN.values() for d in (64, 128)]
    paged = [f"paged_decode_kernel<{g}> {dt}" for g in range(1, 17) for dt in ("bf16", "f32")]
    for kernel in tensor_core + [f"w8a8_kernel<16> {dt}" for dt in ("bf16", "f32")] + paged:
        check(ptxas.get(kernel, {}).get("spill_stores") == 0,  # none of these may spill
              f"ptxas: {kernel}: {ptxas.get(kernel, 'no report')}")

    config = get_preset("smollm3_3b")
    tokenizer = ByteChatMLTokenizer()
    prompts, live = live_lengths(ByteChatMLTokenizer, WILDERNESS_EXPERT_SYSTEM_PROMPT)
    kernels = kernel_phase(fa, peaks, live)

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
             f"TTFT warm-up {served['ttft_s_warmup']:.3f} s, concurrent mean "
             f"{served['ttft_s_concurrent_mean']:.3f} s, "
             f"int8 KV pool {served['kv_pool_bytes'] / 1e9:.3f} GB")

    engines = engines_phase(tf, gen_mod, server_mod, fa, generator)
    speculation = spec_phase(tf, gen_mod, engine_mod, server_mod, fa, generator, engines, served,
                             prompts)
    step = f32_step_phase(tf, fa, params, config, prompts[0])
    profiled = profile_phase(generator, prompts)
    dense = dense_phase(tf, gen_mod, engine_mod, params, config, tokenizer, prompts[0])
    del generator, params  # free the serving phases' tensors before training
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()

    flash = flash_kernel_phase(fa, peaks)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:  # phase 14 asks the model phase 8 trains
        trained, trainer = train_phase(fa, mm, workdir)
        train_profile = train_profile_phase(trainer, mm)
        microbatch = f32_microbatch_phase(trainer, fa, mm)
        del trainer  # free phase 8's state before asking and before the int8 trunk
        gc_cuda()
        best_model = os.path.join(workdir, "out", "best_model")
        recorded = []  # (prompt, token ids) of every generate_ids in the asks
        first = []  # the first ask's Generator, kept for 16d's solo run
        generate_ids = gen_mod.Generator.generate_ids

        def recording(self, prompt_ids, gen=None, seed=0):
            ids = generate_ids(self, prompt_ids, gen, seed)
            recorded.append((list(prompt_ids), list(ids)))
            first[:] = first or [self]
            return ids

        gen_mod.Generator.generate_ids = recording
        try:
            asked = ask_phase(cli_mod, best_model)
            speculation["ask"] = ask_spec_phase(cli_mod, tf, gen_mod, best_model, recorded,
                                                first[0])
        finally:
            gen_mod.Generator.generate_ids = generate_ids
            first.clear()
        gc_cuda()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    served_i8, profiled_i8, profiled_bf16 = int8_weights_serve_phase(
        tf, gen_mod, server_mod, fa, config, tokenizer, prompts)
    for name, rec in (("phase 14 bf16 weights", profiled_bf16), ("phase 6 bf16 weights", profiled)):
        phase(14, f"decode step at {rec['live_rows']} live rows, int8 weights vs {name}: device "
                  f"time {profiled_i8['device_ms_per_step']:.3f} vs {rec['device_ms_per_step']:.3f} "
                  f"ms, step {profiled_i8['step_ms']:.2f} vs {rec['step_ms']:.2f} ms, device busy "
                  f"{100 * (profiled_i8['device_busy_share'] or 0):.1f}% vs "
                  f"{100 * (rec['device_busy_share'] or 0):.1f}%")

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

    live_rec = kernels["live"]
    paged = kernel_entry("paged_decode_attention",
                         "llm_fine_tune_distributed_tpu_torch/csrc/paged_decode.cu",
                         "llm_fine_tune_distributed_tpu/ops/flash_attention.py:353",
                         served["launches"], {**live_rec, "library_ms": None})
    paged["launches_int8_weights"] = served_i8["launches"]  # phase 14's run
    paged["launches_stream"] = engines["stream"]["paged"]["launches"]  # phase 15's /v1/stream
    paged.update({
        "kernel": "paged_decode_kernel",
        "design": PAGED_DESIGN,
        "tolerance": TOLERANCE,
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("paged_decode_kernel")},
        "shapes": {name: {"lengths": rec["lengths"], "nb": rec["nb"], "split_len": rec["split_len"]}
                   for name, rec in kernels.items()},
        "share_of_bound": live_rec["share_of_bound"],
        **{name: {k: kernels[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "share_of_bound", "max_abs_err")}
           for name in ("full", "single")},
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
        kernel_name, design = FLASH_DESIGN[name]
        entry.update({"kernel": kernel_name, "design": design, "tolerance": FLASH_TOLERANCE,
                      "ptxas": {k: v for k, v in ptxas.items() if k.startswith(kernel_name)},
                      **{k: flash[name][k] for k in flash[name] if k not in entry},
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
        "library": "torch._int_mm on the same K-major codes (int8 x int8 -> int32, no scales and "
                   "no cast)",
        "bf16_matmul_ms": w8a8["bf16_matmul_ms"],
        "quantize_rows_ms": w8a8["quantize_rows_ms"],
        "shapes": w8a8["shapes"],
    })
    entries.append(w8a8_entry)
    for rec in (served, served_i8):
        rec.pop("results")
    summary = {"card": card, "timing_spin": dict(_SPIN), "ptxas": ptxas, "serve": served,
               "serve_engines": engines, "f32_decode_step": step,
               "decode_profile": profiled, "build_s": build_s, "train": trained,
               "train_profile": train_profile, "f32_microbatch": microbatch,
               "train_int8": trained_i8, "train_profile_int8": train_profile_i8,
               "f32_microbatch_int8": microbatch_i8, "dense_generation": dense, "ask": asked,
               "serve_int8_weights": served_i8, "decode_profile_int8_weights": profiled_i8,
               "decode_profile_bf16_phase14": profiled_bf16, "speculation": speculation,
               "total_s": time.monotonic() - t_start}
    phase(12, f"total_s {summary['total_s']:.1f}")
    print(json.dumps({"summary": summary}), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
