"""Int8 weights and the int8 paged KV pool (counterpart of the JAX
``ops/int8.py``; plain XLA there, plain torch here).

Weights: ``quantize_int8`` turns an ``[in, out]`` kernel into the sibling
leaves ``kernel_int8`` (int8 codes) and ``kernel_int8_scale`` (f32
per-output-channel absmax/127). The frozen trunk's w8a8 matmul reads them
(``ops/int8_matmul.py``), and so does weight-only int8 inference
(``int8_matmul``; ``quantize_params_int8`` / ``maybe_quantize`` convert a
loaded model, CLI flag ``--quantize int8``): the codes are dequantized in
f32, cast once to the compute dtype and multiplied there. Embedding, lm_head
and norms stay full precision.
Under ``--tp`` (``parallel/sharding.shard_params``) a rank's codes are its
kernel's slice, and the per-output-channel scale goes with the columns: it
is sliced beside a column-parallel kernel (q/k/v, gate/up) and stays whole
beside a row-parallel one (o, down), whose rows are the input channels. So
quantizing then slicing gives the codes and scales of slicing then
quantizing a column-parallel kernel, and the row-parallel partial products
sum to the whole kernel's.

KV pool: the pool keeps the bf16 layout's [num_blocks, block_len, kv_heads,
head_dim] shape in int8, plus an absmax pool [num_blocks, kv_heads] f32
indexed by the same block ids. Codes are symmetric absmax/127. Scale 0 means
"never written" and dequantizes to exactly 0.0, which keeps the null block
(id 0) all-zero.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

# weight-only inference quantization modes (CLI and server choices); "nf4"
# is ops/nf4.quantize_params_nf4
QUANTIZE_MODES = ("none", "int8", "nf4")
KV_QUANT_MODES = ("none", "int8")
INT8_SUFFIXES = ("int8", "int8_scale")
_STACKED_EXPERTS = (".experts.w1", ".experts.w2", ".experts.w3")


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


def int8_matmul(x: torch.Tensor, q: Dict[str, torch.Tensor],
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [..., in] @ dequant(q)`` in ``compute_dtype``: the codes times the
    per-channel scale in f32, cast once, as the JAX version computes it. One
    elementwise pass writes the dequantized weight straight in
    ``compute_dtype`` (``torch.mul`` into an ``out`` of that dtype computes
    in f32 and rounds on the store), in the codes' own memory layout, so
    row-major codes and the K-major ones ``models/carry.params_from_jax``
    makes both work."""
    codes = q["int8"]
    w = torch.empty_like(codes, dtype=compute_dtype)
    torch.mul(codes, q["int8_scale"][None, :].float(), out=w)
    return x.to(compute_dtype) @ w


def is_block_linear(name: str) -> bool:
    """A transformer block's linear kernel, the leaves that every weight
    quantization takes (int8 here, NF4 in ``ops/nf4`` and QLoRA's frozen
    base in ``parallel/qlora``); the MoE router gate stays exact."""
    return (".layers." in name and name.endswith(".kernel")
            and not name.endswith("block_sparse_moe.gate.kernel"))


def _default_predicate(name: str) -> bool:
    """The block linears, and stacked expert weights, which have no port
    (``quantize_params_int8`` raises on them)."""
    return is_block_linear(name) or (".layers." in name and name.endswith(_STACKED_EXPERTS))


def quantize_params_int8(params: Dict[str, torch.Tensor],
                         predicate: Optional[Callable[[str], bool]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Replace every 2-D ``kernel`` leaf that ``predicate(name)`` selects
    (the transformer blocks' linears by default) with its int8 siblings
    ``kernel_int8`` + ``kernel_int8_scale``, row-major, as the JAX version
    does by path. Other leaves pass through; embedding, lm_head and norms
    stay full precision.

    Works IN PLACE on the flat dict and returns it: each kernel is dropped as
    its codes are made, so a model on the card never holds both forms of all
    its block linears. Every selected leaf is checked before the first one
    changes: one with no int8 form raises ``ValueError`` (a stacked expert
    weight raises ``NotImplementedError``; MoE is not ported)."""
    predicate = predicate or _default_predicate
    selected = [name for name in params if predicate(name)]
    for name in selected:
        leaf = params[name]
        if name.endswith(_STACKED_EXPERTS):
            raise NotImplementedError(
                f"{name}: stacked expert weights are not ported "
                "(llm_fine_tune_distributed_tpu.ops.int8.quantize_int8_stacked has them)"
            )
        if leaf.dim() != 2 or not name.endswith(".kernel"):
            raise ValueError(
                f"predicate matched {name!r} (ndim={leaf.dim()}) but only 2-D .kernel "
                "leaves have an int8 form"
            )
    for name in selected:
        q = quantize_int8(params.pop(name))
        for suffix in INT8_SUFFIXES:
            params[f"{name}_{suffix}"] = q[suffix]
    return params


def check_quantize_mode(mode: str) -> None:
    """Raise unless ``maybe_quantize`` can apply ``mode`` (entry points call
    it before loading weights)."""
    if mode not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {mode!r} (expected one of {QUANTIZE_MODES})")


def maybe_quantize(params: Dict[str, torch.Tensor], mode: str) -> Dict[str, torch.Tensor]:
    """Apply the inference entry points' weight-only mode to loaded params
    (in place for ``"int8"`` and ``"nf4"``; see ``quantize_params_int8`` and
    ``ops/nf4.quantize_params_nf4``)."""
    check_quantize_mode(mode)
    if mode == "none":
        return params
    if mode == "nf4":
        from llm_fine_tune_distributed_tpu_torch.ops.nf4 import quantize_params_nf4

        print("Quantizing block linears to NF4 (weight-only) ...")
        return quantize_params_nf4(params)
    print("Quantizing block linears to int8 (weight-only) ...")
    return quantize_params_int8(params)


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
