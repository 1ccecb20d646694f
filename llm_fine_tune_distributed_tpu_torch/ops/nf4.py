"""NF4 (NormalFloat4) blockwise quantization, the QLoRA storage format
(counterpart of the JAX ``ops/nf4.py``; plain XLA there, plain torch here).

Layout, as in the JAX package:

- a weight ``W [in, out]`` is quantized along its in axis in blocks of
  ``block_size`` rows per column: ``absmax [in / block, out]`` f32;
- the 4-bit codes are packed 8 per int32 word, ``nf4 [in / 8, out]``; nibble
  ``s`` of word ``r`` holds row ``8 r + s``;
- double quantization (default) stores the absmax as int8 ``absmax_q``, one
  f32 ``absmax_scale`` per group of 256 and a global ``absmax_offset``.

The codes are made on the tensor's device (``torch.bucketize`` over the 15
midpoints, ties to the lower code, as ``np.searchsorted`` with side
``left``); the double quantization runs in numpy on the host, as the JAX
package runs it, so every leaf equals the JAX package's bit for bit.

The matmul dequantizes in plain torch and multiplies with ``torch.matmul``:
the JAX package retired its fused Pallas NF4 kernel and multiplies with
``jnp.dot`` too. ``nf4_matmul`` is an autograd function that keeps only the
codes for its backward and dequantizes again there, so a dequantized
weight never outlives its layer, with or without rematerialization.

Not here: the stacked ``[E, in, out]``, layered ``[L, in, out]`` and pipe
``[L, E, in, out]`` variants, which serve MoE and pipeline parallelism
(neither is ported; ``quantize_nf4`` raises on them naming the JAX
functions).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.ops.int8 import is_block_linear

_JAX_NF4 = "llm_fine_tune_distributed_tpu.ops.nf4"

# The 16 NF4 code points: quantiles of N(0, 1) normalized to [-1, 1] (the
# QLoRA reference implementation's constants, as in the JAX package)
NF4_CODEBOOK = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)
# midpoints between consecutive code points, in f32 as numpy computes them
_MIDS = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / 2.0

DEFAULT_BLOCK_SIZE = 64
ABSMAX_GROUP = 256  # double-quant group size (QLoRA paper)
# a tensor-parallel slice's (first absmax row, first column, whole out)
Origin = Tuple[int, int, int]

# The sibling leaf names of a quantized ``kernel``; every consumer derives its
# key lists from these two tuples
QUANT_SUFFIXES = ("nf4", "absmax", "absmax_q", "absmax_scale", "absmax_offset")
# longest first, so that suffix matching is unambiguous
DEQUANT_MARKERS = ("_absmax_offset", "_absmax_scale", "_absmax_q", "_absmax", "_nf4")


def _check_in_dim(k: int, block_size: int) -> None:
    if k % 8:
        raise ValueError(f"in-dim {k} not divisible by the int32 pack factor 8")
    if k % block_size:
        raise ValueError(f"in-dim {k} not divisible by block_size {block_size}")


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """int codes [k, n] in 0..15 -> int32 [k / 8, n]: nibble s of word r is
    row 8 r + s. The top nibble enters as its signed value times 2**28, so
    the word is the uint32 bit pattern read as int32 with no overflow."""
    k, n = codes.shape
    c = codes.to(torch.int32).reshape(k // 8, 8, n)
    packed = torch.zeros((k // 8, n), dtype=torch.int32, device=codes.device)
    for s in range(7):
        packed |= c[:, s, :] << (4 * s)
    top = c[:, 7, :]
    return packed + torch.where(top >= 8, top - 16, top) * (1 << 28)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """int32 [k / 8, n] -> int32 codes [k, n]. ``>>`` on int32 shifts in the
    sign, so every nibble is masked with 0xF after its shift."""
    k8, n = packed.shape
    nibbles = [(packed >> (4 * s)) & 0xF for s in range(8)]
    return torch.stack(nibbles, dim=1).reshape(k8 * 8, n)


def _double_quant(absmax: np.ndarray) -> Dict[str, np.ndarray]:
    """The JAX package's second-level scheme, in numpy as there: the absmax
    less its mean, in groups of 256, as int8 with one f32 scale per group."""
    flat = absmax.reshape(-1)
    offset = np.float32(flat.mean())
    centered = flat - offset
    pad = (-centered.size) % ABSMAX_GROUP
    grouped = np.pad(centered, (0, pad)).reshape(-1, ABSMAX_GROUP)
    gmax = np.abs(grouped).max(axis=1)
    gscale = np.where(gmax == 0.0, 1.0, gmax) / 127.0
    q = np.clip(np.round(grouped / gscale[:, None]), -127, 127).astype(np.int8)
    return {"absmax_q": q.reshape(-1)[: centered.size].reshape(absmax.shape),
            "absmax_scale": gscale.astype(np.float32),
            "absmax_offset": np.asarray(offset, np.float32)}


def quantize_nf4(w: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE,
                 double_quant: bool = True) -> Dict[str, torch.Tensor]:
    """``w [in, out]`` -> NF4 leaves on ``w``'s device: ``nf4`` int32
    [in/8, out] and ``absmax`` f32 [in/block, out], or with ``double_quant``
    ``absmax_q`` int8 [in/block, out], ``absmax_scale`` f32 [groups] and
    ``absmax_offset`` f32 []. The codes are computed on the device in f32
    (absmax, division, bucketing); only the absmax visits the host, for the
    double quantization."""
    if w.dim() != 2:
        raise NotImplementedError(
            f"quantize_nf4 takes a 2-D weight, got {tuple(w.shape)}: the stacked, layered and "
            f"pipe layouts (MoE, pipeline parallelism) are not ported ({_JAX_NF4}."
            "quantize_nf4_stacked / quantize_nf4_layered / quantize_nf4_layered_stacked have them)"
        )
    k, n = w.shape
    _check_in_dim(k, block_size)
    blocks = w.float().reshape(k // block_size, block_size, n)
    absmax = blocks.abs().amax(dim=1)  # [k / block, n]
    safe = torch.where(absmax == 0.0, 1.0, absmax)
    normalized = (blocks / safe[:, None, :]).reshape(k, n)
    del blocks
    mids = torch.from_numpy(_MIDS).to(w.device)
    codes = torch.bucketize(normalized, mids, out_int32=True)  # mids[i-1] < x <= mids[i]
    del normalized
    out = {"nf4": pack_codes(codes)}
    if not double_quant:
        out["absmax"] = absmax
        return out
    for key, arr in _double_quant(absmax.cpu().numpy()).items():
        out[key] = torch.from_numpy(arr).to(w.device)
    return out


def _dequant_absmax(q: Dict[str, torch.Tensor], origin: Optional[Origin] = None) -> torch.Tensor:
    """The f32 absmax [in/block, out] from either storage form. ``origin``
    (``parallel/sharding.nf4_slice_origin``: first row, first column, whole
    out) places a tensor-parallel rank's slice in the whole absmax, whose
    flat entries the scales group by 256: entry (r, c) reads group
    ``((row0 + r) * out + col0 + c) // 256``, bit for bit the whole
    dequantization's value there."""
    if "absmax" in q:
        return q["absmax"].float()
    shape = q["absmax_q"].shape
    flat = q["absmax_q"].float().reshape(-1)
    if origin is not None:
        row0, col0, out = origin
        dev = flat.device
        rows = torch.arange(row0, row0 + shape[0], device=dev)[:, None]
        cols = torch.arange(col0, col0 + shape[1], device=dev)[None, :]
        group = ((rows * out + cols) // ABSMAX_GROUP).reshape(-1)
        deq = flat * q["absmax_scale"].float()[group]
        return (deq + q["absmax_offset"].float()).reshape(shape)
    pad = (-flat.numel()) % ABSMAX_GROUP
    grouped = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, ABSMAX_GROUP)
    deq = grouped * q["absmax_scale"][:, None].float()
    return (deq.reshape(-1)[: flat.numel()] + q["absmax_offset"].float()).reshape(shape)


def dequantize_nf4(q: Dict[str, torch.Tensor], dtype=torch.bfloat16,
                   origin: Optional[Origin] = None) -> torch.Tensor:
    """The weight [in, out] in ``dtype``: code points in f32 times the
    block's absmax, cast once (the JAX arithmetic). ``origin``: a
    tensor-parallel slice's place in the whole absmax (``_dequant_absmax``)."""
    packed = q["nf4"]
    k = packed.shape[0] * 8
    codebook = torch.from_numpy(NF4_CODEBOOK).to(packed.device)
    w = codebook[unpack_codes(packed)]
    absmax = _dequant_absmax(q, origin)
    block = k // absmax.shape[0]
    w = w.reshape(absmax.shape[0], block, -1) * absmax[:, None, :]
    return w.reshape(k, -1).to(dtype)


class _NF4Matmul(torch.autograd.Function):
    """``x @ dequantize_nf4(q)`` with a gradient for ``x`` only: the
    backward dequantizes again from the codes it kept, so no dequantized
    weight is saved between the forward and the backward."""

    @staticmethod
    def forward(ctx, x, compute_dtype, keys, origin, *leaves):
        q = dict(zip(keys, leaves))
        ctx.save_for_backward(*leaves)
        ctx.keys, ctx.compute_dtype, ctx.x_dtype, ctx.origin = keys, compute_dtype, x.dtype, origin
        return x.to(compute_dtype) @ dequantize_nf4(q, compute_dtype, origin)

    @staticmethod
    def backward(ctx, dy):
        q = dict(zip(ctx.keys, ctx.saved_tensors))
        w = dequantize_nf4(q, ctx.compute_dtype, ctx.origin)
        return ((dy @ w.T).to(ctx.x_dtype), None, None, None) + (None,) * len(ctx.keys)


def nf4_matmul(x: torch.Tensor, q: Dict[str, torch.Tensor],
               compute_dtype=torch.bfloat16, origin: Optional[Origin] = None) -> torch.Tensor:
    """``x [..., in] @ dequant(q) [in, out]`` in ``compute_dtype``,
    differentiable in ``x``; ``origin`` as in ``dequantize_nf4``."""
    keys = tuple(sorted(q))
    return _NF4Matmul.apply(x, compute_dtype, keys, origin, *(q[key] for key in keys))


def quantized_keys(prefix: str) -> tuple:
    """The sibling leaf names a quantized ``prefix`` may occupy."""
    return tuple(f"{prefix}_{s}" for s in QUANT_SUFFIXES)


def quantized_layout(shape, block_size: int = DEFAULT_BLOCK_SIZE, double_quant: bool = True):
    """suffix -> (shape, dtype) of ``quantize_nf4``'s leaves for a weight of
    ``shape``; rejects exactly the shapes ``quantize_nf4`` rejects."""
    k, n = shape
    _check_in_dim(k, block_size)
    out = {"nf4": ((k // 8, n), torch.int32)}
    if double_quant:
        n_scales = (k // block_size) * n
        out["absmax_q"] = ((k // block_size, n), torch.int8)
        out["absmax_scale"] = ((math.ceil(n_scales / ABSMAX_GROUP),), torch.float32)
        out["absmax_offset"] = ((), torch.float32)
    else:
        out["absmax"] = ((k // block_size, n), torch.float32)
    return out


def quantize_params_nf4(params: Dict[str, torch.Tensor],
                        predicate: Optional[Callable[[str], bool]] = None,
                        block_size: int = DEFAULT_BLOCK_SIZE) -> Dict[str, torch.Tensor]:
    """Replace every selected 2-D ``kernel`` leaf with its NF4 siblings
    (``--quantize nf4`` on the inference entry points), the JAX package's
    rule: the blocks' linears, never the embedding, the lm_head or a router.
    A leaf whose in-dim does not divide ``block_size`` takes block 8 (the
    pack factor); one not divisible by 8 raises. Works IN PLACE on the flat
    dict and returns it, each kernel dropped as its codes are made, after
    every selected leaf has been checked."""
    predicate = predicate or is_block_linear
    selected = [name for name in params if predicate(name)]
    for name in selected:
        leaf = params[name]
        if leaf.dim() != 2 or not name.endswith(".kernel"):
            raise ValueError(
                f"predicate matched {name!r} (ndim={leaf.dim()}) but only 2-D .kernel leaves "
                "have an NF4 form here (stacked expert weights are not ported)")
        if leaf.shape[0] % 8:
            raise ValueError(f"{name}: in-dim {leaf.shape[0]} not divisible by the int32 "
                             "pack factor 8")
    for name in selected:
        leaf = params.pop(name)
        bs = block_size if leaf.shape[0] % block_size == 0 else 8
        q = quantize_nf4(leaf, block_size=bs)
        del leaf
        for suffix in QUANT_SUFFIXES:
            if suffix in q:
                params[f"{name}_{suffix}"] = q[suffix]
    return params
