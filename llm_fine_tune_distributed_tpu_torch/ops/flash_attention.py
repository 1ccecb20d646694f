"""Attention kernels of the port (counterpart of the JAX
``ops/flash_attention.py``).

- ``flash_attention``: causal flash attention for training, a
  ``torch.autograd.Function`` over three hand-written CUDA kernels:
  ``flash_fwd`` (``csrc/flash_fwd.cu``) and ``flash_bwd_dq`` /
  ``flash_bwd_dkv`` (``csrc/flash_bwd.cu``). For bf16 all three run on the
  tensor cores and skip the tile pairs ``flash_tile_pairs`` rules out; f32
  inputs run the CUDA-core kernels.
- ``paged_decode_attention``: fused decode attention over an int8 block-paged
  KV pool (``csrc/paged_decode.cu``), each row's positions split over thread
  blocks and merged in the same launch.

Each kernel's wrapper launches the kernel on a CUDA tensor and runs the plain
PyTorch version beside it (``*_reference``) on a CPU tensor. There is no
other path: a shape the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from llm_fine_tune_distributed_tpu_torch.ops import _build

_NEG_INF = -1.0e30  # the TPU kernel's finite -inf

_MAX_GROUPS = 16
_MAX_HEAD_DIM = 256
# positions per split of the paged decode kernel: a multiple of its 64-position
# tile, at most 256 (csrc/paged_decode.cu kTile, kMaxSplit)
_SPLIT_TILE = 64
_MAX_SPLIT = 256


def paged_decode_attention_reference(
    q, k_pool, v_pool, k_scale, v_scale, block_tables, *, lengths, scale=None,
):
    """Plain PyTorch version: gather the table's blocks, dequantize, mask
    positions >= ``lengths``, f32 softmax, weighted sum; same shapes and
    result as the kernel (see ``paged_decode_attention``)."""
    b, s, hq, d = q.shape
    _, L, hkv, _ = k_pool.shape
    groups = hq // hkv
    nb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    flat = block_tables.reshape(-1).long()
    k = k_pool[flat].float() * (k_scale[flat] / 127.0)[:, None, :, None]
    v = v_pool[flat].float() * (v_scale[flat] / 127.0)[:, None, :, None]
    k = k.reshape(b, nb * L, hkv, d)
    v = v.reshape(b, nb * L, hkv, d)
    qg = q[:, 0].float().reshape(b, hkv, groups, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k) * scale
    visible = torch.arange(nb * L, device=q.device)[None, :] < lengths.long()[:, None]
    logits = torch.where(visible[:, None, None, :], logits,
                         torch.tensor(_NEG_INF, dtype=torch.float32, device=q.device))
    probs = torch.softmax(logits, dim=-1) * visible[:, None, None, :]
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v)
    return out.reshape(b, 1, hq, d).to(q.dtype)


def paged_decode_split_len(b: int, hkv: int, nb: int, L: int, sm_count: int) -> int:
    """Positions per split of the paged decode kernel: 256, halved (down to
    64) while the grid of b * hkv * ceil(nb * L / split) blocks would fill
    at most half the SMs. Host shapes only, never ``lengths``, so the grid
    is fixed by the call's shapes."""
    split = _MAX_SPLIT
    while split > _SPLIT_TILE and 2 * b * hkv * -(-nb * L // split) <= sm_count:
        split //= 2
    return split


def paged_decode_split_reference(
    q, k_pool, v_pool, k_scale, v_scale, block_tables, *, lengths, split_len, scale=None,
):
    """Plain version of the kernel's split and merge, for tests: each run of
    ``split_len`` positions gets its own (m, l, acc) in f32, with the
    absmax scales folded as the kernel folds them (logit = q.k_code *
    scale * k_absmax/127, acc = sum p * v_absmax/127 * v_code), and the
    splits a row reaches (``ceil(min(len, nb * L) / split_len)``) merge as
    m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
    out = acc / max(l, 1e-30). Same result as ``paged_decode_attention``
    to f32 rounding; the main path never calls it."""
    b, _, hq, d = q.shape
    _, L, hkv, _ = k_pool.shape
    groups = hq // hkv
    nb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    n = nb * L
    splits = -(-n // split_len)
    pad = splits * split_len - n
    flat = block_tables.reshape(-1).long()
    ks = (scale * (k_scale[flat] / 127.0)).reshape(b, nb, 1, hkv).expand(b, nb, L, hkv)
    vs = (v_scale[flat] / 127.0).reshape(b, nb, 1, hkv).expand(b, nb, L, hkv)
    ks = torch.nn.functional.pad(ks.reshape(b, n, hkv), (0, 0, 0, pad))
    vs = torch.nn.functional.pad(vs.reshape(b, n, hkv), (0, 0, 0, pad))
    k = torch.nn.functional.pad(k_pool[flat].float().reshape(b, n, hkv, d), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v_pool[flat].float().reshape(b, n, hkv, d), (0, 0, 0, 0, 0, pad))
    qg = q[:, 0].float().reshape(b, hkv, groups, d)
    # [b, hkv, G, splits, split_len]
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k) * ks.permute(0, 2, 1)[:, :, None]
    logits = logits.reshape(b, hkv, groups, splits, split_len)
    length = lengths.long().clamp(0, n)
    visible = (torch.arange(splits * split_len, device=q.device)[None, :] < length[:, None])
    visible = visible.reshape(b, 1, 1, splits, split_len)
    logits = torch.where(visible, logits, torch.tensor(_NEG_INF, dtype=torch.float32, device=q.device))
    m_i = logits.amax(dim=-1)
    p = torch.where(visible, torch.exp(logits - m_i[..., None]), 0.0)
    l_i = p.sum(dim=-1)
    pv = p * vs.permute(0, 2, 1).reshape(b, hkv, 1, splits, split_len)
    acc_i = torch.einsum("bhgsk,bskhd->bhgsd", pv, v.reshape(b, splits, split_len, hkv, d))
    live = (torch.arange(splits, device=q.device)[None, :] < -(-length // split_len)[:, None])
    live = live[:, None, None, :]
    m = torch.where(live, m_i, _NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m_i - m), 0.0)
    l = (l_i * w).sum(dim=-1)
    acc = (acc_i * w[..., None]).sum(dim=-2)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _check(q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths):
    b, s, hq, d = q.shape
    num_blocks, L, hkv, dk = k_pool.shape
    if s != 1:
        raise ValueError(f"paged decode takes one query token per row, got s={s}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    for name, t, dtype in (
        ("k_pool", k_pool, torch.int8), ("v_pool", v_pool, torch.int8),
        ("k_scale", k_scale, torch.float32), ("v_scale", v_scale, torch.float32),
        ("block_tables", block_tables, torch.int32), ("lengths", lengths, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    if k_scale.shape != (num_blocks, hkv) or v_scale.shape != (num_blocks, hkv):
        raise ValueError(f"scales must be [{num_blocks}, {hkv}]")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("block_tables must be [b, nb] and lengths [b]")
    if hq % hkv or hq // hkv > _MAX_GROUPS:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}, at most {_MAX_GROUPS}x")
    if d % 16 or d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 16 and at most {_MAX_HEAD_DIM}")
    tensors = (q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the int8 pools must be 16-byte aligned")


def paged_decode_attention(
    q, k_pool, v_pool, k_scale, v_scale, block_tables, *,
    lengths, scale: Optional[float] = None,
):
    """Decode attention over an int8 block-paged KV pool.

    ``q [b, 1, hq, d]`` bf16 or f32 (one decode token per row), ``k_pool``/
    ``v_pool`` int8 ``[num_blocks, L, hkv, d]`` with absmax scales
    ``[num_blocks, hkv]`` f32 (``models/transformer.init_paged_cache``),
    ``block_tables [b, nb]`` int32, ``lengths [b]`` int32 (visible positions
    per row, i.e. query position + 1). Returns ``[b, 1, hq, d]`` in q.dtype.

    A CUDA tensor launches the kernel (``csrc/paged_decode.cu``) once on the
    current stream without synchronising, and adds one to
    ``paged_decode_attention.launches``; a CPU tensor runs the plain version.
    The kernel splits each row's positions into runs of
    ``paged_decode_split_len`` positions (from b, hkv, nb, L and the card's
    SM count: the grid never depends on ``lengths``), one thread block per
    (split, kv head, row). Each split's f32 (m, l, acc) goes to a workspace
    this wrapper allocates with ``torch.empty`` (b * hkv * splits * G *
    (d + 2) floats), and the last split of a (row, kv head) to finish merges
    them in the same launch (``paged_decode_split_reference`` is the plain
    version of that merge). It finds out that it is last from an int32
    ticket per (row, kv head) that the wrapper keeps zeroed per device and
    stream, and the kernel resets.
    """
    _check(q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, k_scale, v_scale, block_tables,
            lengths=lengths, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, got {q.device}")
    b, _, hq, _ = q.shape
    _, L, hkv, _ = k_pool.shape
    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    split_len = paged_decode_split_len(b, hkv, block_tables.shape[1], L, sm_count)
    return _paged_decode_launch(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                                lengths, scale, split_len)


paged_decode_attention.launches = 0

# (device index, stream) -> int32 tickets of the paged decode kernel's merge,
# all zero between launches
_TICKETS: dict = {}


def _tickets(device, stream, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


def reset_paged_decode_tickets(device) -> None:
    """Zero the merge tickets of ``device``'s current stream. The kernel
    leaves them zero when every launch runs to its end; a serving engine
    calls this when it builds a new generation after a failure, so that a
    launch cut short cannot pass a stale ticket on. Nothing to do on the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    t = _TICKETS.get((device.index, stream))
    if t is not None:
        t.zero_()


def _paged_decode_launch(q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
                         scale, split_len):
    """One launch of the kernel at ``split_len`` positions per split, on
    inputs ``_check`` has passed (the wrapper's rule picks ``split_len``)."""
    b, _, hq, d = q.shape
    _, L, hkv, _ = k_pool.shape
    nb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    splits = -(-nb * L // split_len)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    ws = torch.empty(b * hkv * splits * (hq // hkv) * (d + 2), dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, stream, b * hkv)
    err = _library().paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
        b, hq, hkv, d, L, nb, split_len, int(q.dtype == torch.bfloat16), float(scale),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:  # first use: pointers and the stream as c_void_p
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# causal flash attention (training)
# ---------------------------------------------------------------------------

_FLASH_MAX_HEAD_DIM = 128
FLASH_TILE = 64  # rows of the kernels' query and key tiles


def flash_segments(q, padding_mask=None, segment_ids=None) -> torch.Tensor:
    """int32 [b, s] segments, the rule of the JAX ``pallas_flash_attention``:
    ``segment_ids`` if given, else ``padding_mask`` (1 = real, 0 = pad),
    else all ones."""
    seg = segment_ids if segment_ids is not None else padding_mask
    if seg is None:
        return torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    return seg.to(device=q.device, dtype=torch.int32).contiguous()


def _flash_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _heads_first(x, groups):
    """[b, s, h, d] -> f32 [b, h * groups, s, d] (each kv head repeated for
    its query group; the plain versions only)."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(groups, dim=1) if groups > 1 else x


def _flash_mask(segments):
    """[b, 1, s, s] bool: key j is visible to query i iff j <= i and both
    carry the same segment id. Pad queries (segment 0) see the pad keys at
    or before them, themselves included, as the TPU kernel does; this
    differs from ``xla_attention``'s padding rule on pad rows only."""
    s = segments.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool, device=segments.device).tril()
    return (causal & (segments[:, :, None] == segments[:, None, :]))[:, None]


def flash_tile_pairs(segments, tile=FLASH_TILE):
    """bool [b, n, n], n = ceil(s / tile): True where the bf16 kernels visit
    (query tile i, key tile j) of a batch row. A pair is visited iff j <= i
    (the causal limit) and the two tiles' segment ranges, [min, max] of the
    ids of their rows below s, intersect. Disjoint ranges share no id, so no
    visible pair is ever skipped; a tile of pad queries (segment 0) skips
    every key tile of real tokens only (the rule of ``csrc/flash_mma.cuh``;
    the kernels count their own walk into ``tile_visits``)."""
    b, s = segments.shape
    n = -(-s // tile)
    seg = segments.to(torch.int64)
    edge = n * tile - s
    top = torch.full((b, edge), torch.iinfo(torch.int64).max, dtype=torch.int64, device=seg.device)
    lo = torch.cat([seg, top], dim=1).reshape(b, n, tile).amin(dim=-1)
    hi = torch.cat([seg, -top - 1], dim=1).reshape(b, n, tile).amax(dim=-1)
    meet = (lo[:, :, None] <= hi[:, None, :]) & (lo[:, None, :] <= hi[:, :, None])
    causal = torch.ones(n, n, dtype=torch.bool, device=seg.device).tril()
    return meet & causal


def _flash_probs(q, k, segments, lse, scale):
    """p = exp(q k^T * scale - lse) under the mask, f32 [b, hq, s, s]."""
    groups = q.shape[2] // k.shape[2]
    scores = (q.float().transpose(1, 2) @ _heads_first(k, groups).transpose(-1, -2)) * scale
    return torch.where(_flash_mask(segments), torch.exp(scores - lse[..., None]), 0.0)


def flash_attention_fwd_reference(q, k, v, segments, *, scale=None):
    """Plain version of ``flash_fwd``: (O [b, s, hq, d] in q's dtype,
    LSE [b, hq, s] f32), f32 softmax with the finite -1e30 of the TPU
    kernel and ``O = acc / max(l, 1e-30)``."""
    scale = _flash_scale(q, scale)
    groups = q.shape[2] // k.shape[2]
    mask = _flash_mask(segments)
    scores = (q.float().transpose(1, 2) @ _heads_first(k, groups).transpose(-1, -2)) * scale
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p @ _heads_first(v, groups)) / l
    return o.transpose(1, 2).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_delta(o, do):
    """delta = rowsum(dO * O), f32 [b, hq, s]: the plain-PyTorch step before
    the backward kernels (the JAX ``_bwd`` computes it in XLA)."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_bwd_dq_reference(q, k, v, segments, lse, delta, do, *, scale=None):
    """Plain version of ``flash_bwd_dq``: dq = scale * (p * (dO V^T -
    delta)) K, in q's dtype."""
    scale = _flash_scale(q, scale)
    groups = q.shape[2] // k.shape[2]
    p = _flash_probs(q, k, segments, lse, scale)
    dp = do.float().transpose(1, 2) @ _heads_first(v, groups).transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    dq = (ds @ _heads_first(k, groups)) * scale
    return dq.transpose(1, 2).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, segments, lse, delta, do, *, scale=None):
    """Plain version of ``flash_bwd_dkv``: dk = scale * ds^T q and
    dv = p^T dO, summed over each kv head's query group; (dk, dv) in k's and
    v's dtype, [b, s, hkv, d]."""
    scale = _flash_scale(q, scale)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    p = _flash_probs(q, k, segments, lse, scale)
    dof = do.float().transpose(1, 2)
    ds = p * (dof @ _heads_first(v, groups).transpose(-1, -2) - delta[..., None])
    dk = (ds.transpose(-1, -2) @ q.float().transpose(1, 2)) * scale
    dv = p.transpose(-1, -2) @ dof
    dk = dk.reshape(b, hkv, groups, s, d).sum(dim=2)
    dv = dv.reshape(b, hkv, groups, s, d).sum(dim=2)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def flash_attention_bwd_reference(q, k, v, segments, o, lse, do, *, scale=None):
    """Plain backward: (dq, dk, dv) from the forward's O and LSE."""
    delta = flash_delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, segments, lse, delta, do, scale=scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, segments, lse, delta, do, scale=scale)
    return dq, dk, dv


def _check_flash(q, k, v, segments, *extra):
    """Raise, naming the constraint, on inputs the flash kernels do not
    take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes q [b, s, hq, d] and k/v [b, s, hkv, d]")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash attention needs k and v of shape [b, s, hkv, d] matching q "
            f"{tuple(q.shape)} (self-attention over one sequence), got "
            f"{tuple(k.shape)}/{tuple(v.shape)}"
        )
    if hq % hkv:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}")
    if d % 16 or d > _FLASH_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 16 and at most {_FLASH_MAX_HEAD_DIM}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash attention takes bf16 or f32, got {q.dtype}")
    tensors = (q, k, v, *extra)
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError("q, k, v (and dO) must share one dtype")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("q, k, v (and dO) need a unit stride on head_dim")
    if segments.dtype != torch.int32 or segments.shape != (b, s) or not segments.is_contiguous():
        raise ValueError(f"segments must be contiguous int32 [{b}, {s}]")
    if any(t.device != q.device for t in (*tensors, segments)):
        raise ValueError("all inputs must be on one device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")


def _tensor_core_layout_ok(t) -> bool:
    return t.data_ptr() % 16 == 0 and all(t.stride(i) % 8 == 0 for i in range(3))


def _check_tensor_core_layout(*tensors):
    """Raise, naming the constraint, where the bf16 tensor-core kernels
    cannot take a tensor: they copy rows in 16-byte chunks,
    so each base must be 16-byte aligned and each (batch, position, head)
    stride a multiple of 8 elements."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the bf16 flash kernels need 16-byte-aligned q, k, v (and dO)")
        if not _tensor_core_layout_ok(t):
            raise ValueError(
                "the bf16 flash kernels need (batch, position, head) strides that are "
                f"multiples of 8 elements, got {tuple(t.stride())}")


def _check_tile_visits(q, tile_visits):
    """Raise unless ``tile_visits`` is None or what the tensor-core kernels
    count into: a contiguous int32 [b, n, n], n = ceil(s / FLASH_TILE), on
    the card beside bf16 inputs."""
    if tile_visits is None:
        return
    b, s = q.shape[:2]
    n = -(-s // FLASH_TILE)
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError("tile_visits is counted by the bf16 tensor-core kernels, on the card only")
    if (tile_visits.dtype != torch.int32 or tile_visits.shape != (b, n, n)
            or not tile_visits.is_contiguous() or tile_visits.device != q.device):
        raise ValueError(f"tile_visits must be a contiguous int32 [{b}, {n}, {n}] tensor on q's device")


def _strides(*tensors):
    vals = [x for t in tensors for x in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_fwd(q, k, v, segments, *, scale=None, tile_visits=None):
    """Causal flash-attention forward: (O [b, s, hq, d] in q's dtype, LSE
    f32 [b, hq, s]). A CUDA tensor launches ``csrc/flash_fwd.cu`` on the
    current stream (bf16: the tensor-core kernel, which refuses layouts it
    cannot copy; f32: the CUDA-core kernel) and adds one to
    ``flash_fwd.launches``; a CPU tensor runs
    ``flash_attention_fwd_reference``.

    ``tile_visits`` (bf16 on the card only; None on the main path): a zeroed
    int32 [b, n, n], n = ceil(s / FLASH_TILE), to which the kernel adds one
    at (row, query tile, key tile) for each query head whose tile pair it
    computes: its own walk, to hold against ``flash_tile_pairs`` * hq."""
    _check_flash(q, k, v, segments)
    _check_tile_visits(q, tile_visits)
    scale = _flash_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, segments, scale=scale)
    if q.dtype == torch.bfloat16:
        _check_tensor_core_layout(q, k, v)
    b, s, hq, d = q.shape
    o = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    err = _flash_library("flash_fwd").flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), segments.data_ptr(),
        o.data_ptr(), lse.data_ptr(), None if tile_visits is None else tile_visits.data_ptr(),
        _strides(q, k, v),
        b, s, hq, k.shape[2], d, int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_fwd.launches += 1
    return o, lse


def _check_stats(q, lse, delta):
    b, s, hq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, hq, s) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 [{b}, {hq}, {s}]")
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")


def flash_bwd_dq(q, k, v, segments, lse, delta, do, *, scale=None, tile_visits=None):
    """dq [b, s, hq, d] in q's dtype. A CUDA tensor launches the dq kernel of
    ``csrc/flash_bwd.cu`` (bf16: the tensor-core kernel, which refuses
    layouts it cannot copy and forms delta itself as sum_k p dP, the
    rowsum(dO O) of unrounded O, so ``delta`` feeds only the f32 kernel and
    the plain version; f32: the CUDA-core kernel) and adds one to
    ``flash_bwd_dq.launches``; a CPU tensor runs ``flash_bwd_dq_reference``.
    ``tile_visits``: as in ``flash_fwd``."""
    _check_flash(q, k, v, segments, do)
    _check_stats(q, lse, delta)
    _check_tile_visits(q, tile_visits)
    scale = _flash_scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, segments, lse, delta, do, scale=scale)
    if q.dtype == torch.bfloat16:
        _check_tensor_core_layout(q, k, v, do)
    b, s, hq, d = q.shape
    dq = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    err = _flash_library("flash_bwd").flash_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), segments.data_ptr(), dq.data_ptr(),
        None if tile_visits is None else tile_visits.data_ptr(), _strides(q, k, v, do),
        b, s, hq, k.shape[2], d, int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError {err}")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, segments, lse, delta, do, *, scale=None, tile_visits=None):
    """(dk, dv) [b, s, hkv, d] in k's dtype. A CUDA tensor launches the dk/dv
    kernel of ``csrc/flash_bwd.cu`` (bf16: the tensor-core kernel, which
    refuses layouts it cannot copy; f32: the CUDA-core kernel) and adds one
    to ``flash_bwd_dkv.launches``; a CPU tensor runs
    ``flash_bwd_dkv_reference``. ``tile_visits``: as in ``flash_fwd``."""
    _check_flash(q, k, v, segments, do)
    _check_stats(q, lse, delta)
    _check_tile_visits(q, tile_visits)
    scale = _flash_scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, segments, lse, delta, do, scale=scale)
    if q.dtype == torch.bfloat16:
        _check_tensor_core_layout(q, k, v, do)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    dk = torch.empty((b, s, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, s, hkv, d), dtype=v.dtype, device=v.device)
    err = _flash_library("flash_bwd").flash_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), segments.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if tile_visits is None else tile_visits.data_ptr(), _strides(q, k, v, do), b, s, hq, hkv, d, int(q.dtype == torch.bfloat16),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _flash_library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    signatures = {
        "flash_fwd_launch": [p] * 7 + [strides] + [i] * 6 + [f, p],
        "flash_bwd_dq_launch": [p] * 9 + [strides] + [i] * 6 + [f, p],
        "flash_bwd_dkv_launch": [p] * 10 + [strides] + [i] * 6 + [f, p],
        "flash_fwd_tc_smem": [i, i],
        "flash_bwd_dq_tc_smem": [i, i],
        "flash_bwd_dkv_tc_smem": [i, i],
    }
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None and fn.argtypes is None:  # first use
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong if fn_name.endswith("_smem") else ctypes.c_int
    return lib


def flash_tc_smem_bytes(d: int, s: int) -> dict:
    """Dynamic shared memory per block (bytes) that the bf16 tensor-core
    kernels ask for at head dim ``d`` and sequence length ``s``, from the
    built libraries (for reports)."""
    bwd = _flash_library("flash_bwd")
    return {"flash_fwd": _flash_library("flash_fwd").flash_fwd_tc_smem(d, s),
            "flash_bwd_dq": bwd.flash_bwd_dq_tc_smem(d, s),
            "flash_bwd_dkv": bwd.flash_bwd_dkv_tc_smem(d, s)}


class _FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v) with the flash kernels (``plain=False``) or
    their plain versions (``plain=True``, for comparisons). The segments
    get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segments, scale, plain):
        fwd = flash_attention_fwd_reference if plain else flash_fwd
        o, lse = fwd(q, k, v, segments, scale=scale)
        ctx.save_for_backward(q, k, v, segments, o, lse)
        ctx.scale, ctx.plain = scale, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, segments, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not _tensor_core_layout_ok(do)):
            do = do.contiguous()  # the incoming gradient's layout is autograd's
        delta = flash_delta(o, do)
        if ctx.plain:
            dq = flash_bwd_dq_reference(q, k, v, segments, lse, delta, do, scale=ctx.scale)
            dk, dv = flash_bwd_dkv_reference(q, k, v, segments, lse, delta, do, scale=ctx.scale)
        else:
            dq = flash_bwd_dq(q, k, v, segments, lse, delta, do, scale=ctx.scale)
            dk, dv = flash_bwd_dkv(q, k, v, segments, lse, delta, do, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, padding_mask=None, segment_ids=None):
    """Causal flash attention, q [b, s, hq, d], k/v [b, s, hkv, d] -> [b, s,
    hq, d] in q's dtype (the JAX ``pallas_flash_attention``): attention flows
    within equal segments (``segment_ids``, else ``padding_mask``), f32
    softmax, GQA by index. Differentiable: the backward runs ``flash_bwd_dq``
    and ``flash_bwd_dkv``. On a CUDA tensor every call launches the kernels;
    on a CPU tensor their plain versions run."""
    segments = flash_segments(q, padding_mask, segment_ids)
    _check_flash(q, k, v, segments)
    return _FlashAttention.apply(q, k, v, segments, _flash_scale(q, None), False)


def flash_attention_reference(q, k, v, *, padding_mask=None, segment_ids=None):
    """``flash_attention`` through the plain forward and backward, on any
    device (the yardstick the kernels are held to)."""
    segments = flash_segments(q, padding_mask, segment_ids)
    _check_flash(q, k, v, segments)
    return _FlashAttention.apply(q, k, v, segments, _flash_scale(q, None), True)
