"""Fused paged decode attention over an int8 KV pool (counterpart of the JAX
``ops/flash_attention.paged_decode_attention``).

On a CUDA tensor ``paged_decode_attention`` launches the hand-written kernel
in ``csrc/paged_decode.cu``; on a CPU tensor it runs
``paged_decode_attention_reference``, the plain PyTorch version of the same
function. There is no other path.
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

    A CUDA tensor launches the kernel (``csrc/paged_decode.cu``) on the
    current stream without synchronising, and adds one to
    ``paged_decode_attention.launches``; a CPU tensor runs the plain version.
    """
    _check(q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, k_scale, v_scale, block_tables,
            lengths=lengths, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, got {q.device}")
    b, _, hq, d = q.shape
    _, L, hkv, _ = k_pool.shape
    nb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lib = _library()
    out = torch.empty_like(q)
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        b, hq, hkv, d, L, nb, int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:  # first use: pointers and the stream as c_void_p
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
