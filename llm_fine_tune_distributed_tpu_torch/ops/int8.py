"""Int8 weights and the int8 paged KV pool (counterpart of the JAX
``ops/int8.py``; plain XLA there, plain torch here).

Weights: ``quantize_int8`` turns an ``[in, out]`` kernel into the sibling
leaves ``kernel_int8`` (int8 codes) and ``kernel_int8_scale`` (f32
per-output-channel absmax/127), the layout the frozen trunk's w8a8 matmul
reads (``ops/int8_matmul.py``).

KV pool: the pool keeps the bf16 layout's [num_blocks, block_len, kv_heads,
head_dim] shape in int8, plus an absmax pool [num_blocks, kv_heads] f32
indexed by the same block ids. Codes are symmetric absmax/127. Scale 0 means
"never written" and dequantizes to exactly 0.0, which keeps the null block
(id 0) all-zero.
"""

from __future__ import annotations

from typing import Dict

import torch

KV_QUANT_MODES = ("none", "int8")
INT8_SUFFIXES = ("int8", "int8_scale")


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``w [in, out]`` -> {"int8": int8 [in, out], "int8_scale": f32 [out]}:
    symmetric per-output-channel codes, scale absmax/127 (1/127 for an
    all-zero column). The codes divide by the scale, as the JAX version does,
    so both give the same codes bit for bit."""
    if w.dim() != 2:
        raise ValueError(f"quantize_int8 expects a 2-D weight, got {tuple(w.shape)}")
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    scale = torch.where(absmax == 0.0, 1.0, absmax) / 127.0
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return {"int8": q.to(torch.int8), "int8_scale": scale}


def dequantize_int8(q: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse: int8 codes x per-channel scale in f32 -> [in, out] in ``dtype``."""
    return (q["int8"].float() * q["int8_scale"][None, :].float()).to(dtype)


def quantize_kv_write(codes: torch.Tensor, scales: torch.Tensor, blk: torch.Tensor,
                      off: torch.Tensor, x: torch.Tensor, touched: torch.Tensor) -> None:
    """Scatter new K or V tokens into an int8 paged pool, growing per-block
    scales as needed. Updates ``codes`` and ``scales`` IN PLACE (the JAX
    version returns new arrays; the pool is the only copy here).

    ``codes`` int8 [num_blocks, L, h, d], ``scales`` f32 [num_blocks, h],
    ``blk``/``off`` int [b, s] (pool block / slot within the block of each
    token), ``x`` [b, s, h, d].

    A write may raise a block's absmax; the block's resident codes are then
    re-expressed under the grown scale (times old/new, round half to even,
    clip to +-127). A block whose scale did not grow rescales by exactly 1.0,
    an identity. Writes routed to the null block are forced to zero codes and
    a zero scale.

    ``touched`` int (any shape) lists the blocks to rescale, which the JAX
    version takes to be ``blk`` (one block per token). It must hold every
    id of ``blk`` and may repeat ids or add blocks this call does not write
    (they rescale by 1.0, or stay zero for the null block), so a caller
    writing a long chunk names just the few blocks the chunk spans. Nothing
    here waits for the device.
    """
    blk = blk.long()
    off = off.long()
    xf = x.float()
    null = blk == 0  # [b, s]
    tok_amax = torch.where(null[..., None], 0.0, xf.abs().amax(dim=-1))  # [b, s, h]
    touched = touched.long().reshape(-1)
    old = scales[touched]  # a copy, read before the scale update below
    # in place: scatter-max of each token's absmax into its block's scale
    h = tok_amax.shape[-1]
    scales.scatter_reduce_(
        0, blk.reshape(-1, 1).expand(-1, h), tok_amax.reshape(-1, h), reduce="amax"
    )
    new = scales[touched]
    safe_new = torch.where(new == 0.0, 1.0, new)
    ratio = torch.where(new == 0.0, 0.0, old / safe_new)  # [t, h]
    rescaled = torch.clamp(
        torch.round(codes[touched].float() * ratio[:, None, :, None]), -127, 127
    ).to(torch.int8)
    # in place: resident codes under the new scale. A block id that repeats
    # in ``touched`` computes identical rescaled content from the same
    # gathered codes and grown scales (as in the JAX version), so the order
    # of index_put_ among the repeats does not matter.
    codes[touched] = rescaled
    tok_new = scales[blk]  # [b, s, h]
    tok_safe = torch.where(tok_new == 0.0, 1.0, tok_new)
    q = torch.clamp(torch.round(xf * (127.0 / tok_safe)[..., None]), -127, 127)
    q = torch.where(null[..., None, None], 0.0, q).to(torch.int8)
    # in place: the new tokens' codes. Pairs (blk, off) repeat only for the
    # null block, whose values are all zero, so scatter order does not matter.
    codes[blk, off] = q


def dequantize_kv_gather(codes: torch.Tensor, scales: torch.Tensor,
                         block_tables: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Gather each row's table blocks into the dense [b, nb * L, h, d] view
    the prefill attention reads (gathered index = logical position); null
    entries gather block 0, which dequantizes to zeros."""
    b, nb = block_tables.shape
    _, L, h, d = codes.shape
    flat = block_tables.reshape(-1)
    blocks = codes[flat].float().reshape(b, nb, L, h, d)
    sc = (scales[flat] / 127.0).reshape(b, nb, 1, h, 1)
    return (blocks * sc).to(dtype).reshape(b, nb * L, h, d)
