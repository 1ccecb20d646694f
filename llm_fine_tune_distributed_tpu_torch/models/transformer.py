"""Llama-family decoder-only transformer as plain functions over a flat
parameter dict (counterpart of the JAX ``models/transformer.py``).

Parameters keep the JAX package's names and layouts, flattened with dots:
``model.layers.0.self_attn.q_proj.kernel`` is the ``[in, out]`` kernel
(``x @ W``), norms and the embedding are ``...weight`` in torch layout. So a
parity test or a safetensors file maps one to the other by name.

Ported branches: the dense SwiGLU model (SmolLM3, Llama) with optional
linear biases, RoPE with SmolLM3's NoPE layers and rope scaling, the
no-cache forward with a padding mask or packed rows (``segment_ids`` and
per-segment ``positions``), the flash or plain attention and per-block
rematerialization (training), the frozen trunk in w8a8 int8, weight-only
int8 kernels (inference), NF4 kernels (QLoRA's frozen base and ``--quantize
nf4``), LoRA adapters (a single adapter's
``lora_*`` leaves, or the adapter registry's pools with a per-row
``adapter_idx``), the dense KV cache (``init_cache``) and the block-paged
KV cache in bf16 or int8 (``init_paged_cache``), tensor-parallel serving
(``mesh``: each rank's slice of the weights from
``parallel/sharding.shard_params``, NF4 ones included, the cache on its
local kv heads) and ZeRO-3 training (``gather``: each block's fsdp slices
made whole as the block runs). Other branches raise
``NotImplementedError``.

Tensor parallelism (Megatron, as the JAX rules place it): q/k/v and
gate/up are column-parallel, so a rank computes its own heads and MLP
columns, and its head counts come from the sliced shapes; o_proj and
down_proj are row-parallel, so their outputs are partial sums, all-reduced
over the tensor group before the bias is added once. The embedding lookup
is a gather from the rank's vocab rows, zero elsewhere, all-reduced (each
element has one nonzero addend: exact); the unembed gives the rank's vocab
slice of the logits, all-gathered into the full row. A step issues two
all-reduces per layer, the embedding's all-reduce and the logits'
all-gather (74 for SmolLM3-3B's 36 layers). Without a tensor group the
forward issues none and is the one-device forward.

Tensor-parallel training (``tensor``, a ``parallel/sharding.TensorShards``)
places the same collectives under autograd (``runtime/distributed``):
"copy to tensor" (identity forward, gradient all-reduce backward) on the
normed input of q/k/v, of gate/up and of the unembed; "reduce from tensor"
(all-reduce forward, identity backward, out of place) on the o_proj and
down_proj partial sums and on the embedding lookup. The unembed gives the
rank's vocab slice of the logits, which the vocab-parallel cross-entropy
(``train/step.vocab_parallel_ce``) reads as it is: the full row is never
formed. Under remat the checkpointed block replays its forward
collectives. LoRA factors are whole on every rank: a column-parallel
projection adds its columns of the delta, a row-parallel one its partial
delta before the sum. The int8 trunk's row-parallel projections quantize
their input with the row scale of the whole row (a max all-reduce of each
rank's row absmax) and sum their f32 partial products before one cast.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig
from llm_fine_tune_distributed_tpu_torch.ops.attention import attention, xla_attention
from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import paged_decode_attention
from llm_fine_tune_distributed_tpu_torch.ops.int8 import (
    KV_QUANT_MODES,
    dequantize_kv_gather,
    int8_matmul,
    quantize_kv_write,
)
from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import int8_w8a8_matmul
from llm_fine_tune_distributed_tpu_torch.ops.nf4 import QUANT_SUFFIXES, nf4_matmul
from llm_fine_tune_distributed_tpu_torch.ops.norms import rms_norm
from llm_fine_tune_distributed_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from llm_fine_tune_distributed_tpu_torch.parallel.sharding import nf4_slice_origin
from llm_fine_tune_distributed_tpu_torch.runtime.distributed import (
    copy_to_tensor,
    reduce_from_tensor,
    tp_all_gather_last,
    tp_all_reduce_,
)

Params = Dict[str, torch.Tensor]

_JAX_FORWARD = "llm_fine_tune_distributed_tpu.models.transformer.forward"


def check_supported(config: ModelConfig) -> None:
    """Raise for architecture knobs whose branches are not ported."""
    unported = {
        "num_experts": config.num_experts > 0,
        "sliding_window": config.sliding_window is not None,
        "attn_logit_softcap": config.attn_logit_softcap is not None,
        "final_logit_softcap": config.final_logit_softcap is not None,
        "sandwich_norms": config.sandwich_norms,
        "zero_centered_norm": config.zero_centered_norm,
        "embed_scale": config.embed_scale,
        "qk_norm": config.qk_norm,
        "query_pre_attn_scalar": config.query_pre_attn_scalar is not None,
        f"hidden_act={config.hidden_act}": config.hidden_act != "silu",
    }
    missing = [k for k, on in unported.items() if on]
    if missing:
        raise NotImplementedError(
            f"{config.name}: {', '.join(missing)} not ported ({_JAX_FORWARD} has them)"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def param_shapes(config: ModelConfig) -> Dict[str, tuple]:
    """{name: shape} of every parameter, in ``init_params``'s order."""
    check_supported(config)
    h = config.hidden_size
    d = config.resolved_head_dim
    qd, kvd = config.num_heads * d, config.num_kv_heads * d
    f, v = config.intermediate_size, config.vocab_size
    shapes: Dict[str, tuple] = {}
    for i in range(config.num_layers):
        p = f"model.layers.{i}."
        shapes[p + "input_layernorm.weight"] = (h,)
        for name, shape in (("q_proj", (h, qd)), ("k_proj", (h, kvd)),
                            ("v_proj", (h, kvd)), ("o_proj", (qd, h))):
            shapes[p + f"self_attn.{name}.kernel"] = shape
        if config.attention_bias:
            shapes[p + "self_attn.q_proj.bias"] = (qd,)
            shapes[p + "self_attn.k_proj.bias"] = (kvd,)
            shapes[p + "self_attn.v_proj.bias"] = (kvd,)
            if config.attention_out_bias:
                shapes[p + "self_attn.o_proj.bias"] = (h,)
        shapes[p + "post_attention_layernorm.weight"] = (h,)
        for name, shape in (("gate_proj", (h, f)), ("up_proj", (h, f)), ("down_proj", (f, h))):
            shapes[p + f"mlp.{name}.kernel"] = shape
        if config.mlp_bias:
            shapes[p + "mlp.gate_proj.bias"] = (f,)
            shapes[p + "mlp.up_proj.bias"] = (f,)
            shapes[p + "mlp.down_proj.bias"] = (h,)
    shapes["model.embed_tokens.weight"] = (v, h)
    shapes["model.norm.weight"] = (h,)
    if not config.tie_word_embeddings:
        shapes["lm_head.kernel"] = (h, v)
    return shapes


def iter_init_params(config: ModelConfig, *, seed: int = 0, device="cpu",
                     dtype=torch.float32):
    """``init_params`` one leaf at a time: (name, leaf) in its order, with
    its values, so a caller can keep a slice of each leaf and drop the rest
    before the next one is made."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, shape in param_shapes(config).items():
        if name.endswith("norm.weight"):
            leaf = torch.ones(shape, device=device, dtype=dtype)
        elif name.endswith(".bias"):
            leaf = torch.zeros(shape, device=device, dtype=dtype)
        else:
            leaf = torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32).mul_(0.02).to(dtype)
        yield name, leaf
        del leaf  # before the next leaf is made


def init_params(config: ModelConfig, *, seed: int = 0, device="cpu",
                dtype=torch.float32) -> Params:
    """Random init (normal 0.02, HF convention) from an explicit generator
    seeded with ``seed``. Norm weights start at 1, biases at 0."""
    return dict(iter_init_params(config, seed=seed, device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _linear(x: torch.Tensor, params: Params, name: str, compute_dtype,
            trunk_matmul=None, adapter_idx: Optional[torch.Tensor] = None,
            reduce=None, nf4_origin=None, lora_part=None, row_group=None) -> torch.Tensor:
    """x @ kernel (+ LoRA) (+ bias) in ``compute_dtype``. The int8 siblings
    ``kernel_int8`` / ``kernel_int8_scale`` run through ``trunk_matmul``
    (w8a8) in the frozen trunk (``trunk_matmul`` given) and through
    ``ops.int8.int8_matmul`` (weight-only) elsewhere. The NF4 siblings
    ``kernel_nf4`` / ``kernel_absmax*`` run through ``ops.nf4.nf4_matmul``,
    which dequantizes per call and keeps only the codes for its backward;
    under tensor parallelism ``nf4_origin(name, absmax_shape)`` places the
    rank's slice in the whole double-quantized absmax.

    LoRA, as in the JAX ``_linear``, on either kernel: ``lora_a [in, r]`` /
    ``lora_b [r, out]`` / ``lora_scale`` leaves beside the kernel add
    ``(x @ A) @ B * scale``, as ``addmm(y, (x @ A) * scale, B)``: remat's
    ``dots_no_batch`` keeps ``mm`` outputs only, so the saved set holds the
    rank-r ``x @ A`` and the full-width sum is recomputed in the backward.
    The adapter registry's pooled leaves
    (``infer/adapters.py``) ``lora_a_pool [N, in, r]`` / ``lora_b_pool
    [N, r, out]`` / ``lora_scale_pool [N]`` add each row's own delta,
    picked by ``adapter_idx [batch]`` with the same arithmetic (a gather,
    two batched products, the scale), so tenants co-batch in one forward.
    Pool row 0 is all zeros: its rows' delta is exactly zero. Both come
    before the bias. ``reduce`` (a row-parallel projection under tensor
    parallelism) sums the partial products over the tensor group before the
    bias; ``lora_part(name, A, B)`` gives the parts of whole LoRA factors
    a rank uses (tensor-parallel training). ``row_group`` (a row-parallel
    trunk projection under tensor-parallel training): the w8a8 product
    takes the whole row's scale and comes back in f32, summed before the
    one cast."""
    codes = params.get(name + ".kernel_int8")
    if codes is not None:
        q = {"int8": codes, "int8_scale": params[name + ".kernel_int8_scale"]}
        if trunk_matmul is not None and row_group is not None:
            y = reduce(trunk_matmul(x, q, compute_dtype, row_group=row_group)).to(compute_dtype)
            reduce = None
        else:
            y = (trunk_matmul or int8_matmul)(x, q, compute_dtype)
    elif name + ".kernel_nf4" in params:
        q = {s: params[f"{name}.kernel_{s}"] for s in QUANT_SUFFIXES
             if f"{name}.kernel_{s}" in params}
        origin = (nf4_origin(name, q["absmax_q"].shape)
                  if nf4_origin is not None and "absmax_q" in q else None)
        y = nf4_matmul(x, q, compute_dtype=compute_dtype, origin=origin)
    else:
        y = x @ params[name + ".kernel"].to(compute_dtype)
    lora_a = params.get(name + ".lora_a")
    if lora_a is not None:
        a, b = lora_a, params[name + ".lora_b"]
        if lora_part is not None:
            a, b = lora_part(name, a, b)
        a, b = a.to(compute_dtype), b.to(compute_dtype)
        xa = (x @ a) * params[name + ".lora_scale"].to(compute_dtype)
        y = torch.addmm(y.flatten(0, -2), xa.flatten(0, -2), b).reshape(y.shape)
    pool_a = params.get(name + ".lora_a_pool") if adapter_idx is not None else None
    if pool_a is not None:
        # row i computes with adapter adapter_idx[i]'s A, B and scale
        a = pool_a.index_select(0, adapter_idx).to(compute_dtype)
        b = params[name + ".lora_b_pool"].index_select(0, adapter_idx).to(compute_dtype)
        sc = params[name + ".lora_scale_pool"].index_select(0, adapter_idx).to(compute_dtype)
        y = y + torch.bmm(torch.bmm(x, a), b) * sc[:, None, None]
    if reduce is not None:
        y = reduce(y)
    bias = params.get(name + ".bias")
    if bias is not None:
        y = y + bias.to(compute_dtype)
    return y


def _dense_write(buf: torch.Tensor, slots: torch.Tensor, x: torch.Tensor) -> None:
    """Write ``x [b, s, h, d]`` into a dense cache buffer ``buf [b, M, h, d]``
    IN PLACE at ``slots [b, s]`` (consecutive in each row, >= 0). Slots past
    the buffer are dropped, as the JAX scatter drops them. Without a host
    sync: every write goes to its slot clamped to M - 1, carrying the value
    that slot ends up with (the kept write's value, else the old one), so
    the writes that share a slot agree and their order does not matter."""
    b, s = slots.shape
    tgt = slots.clamp(max=buf.shape[1] - 1)
    src = tgt - slots[:, :1]  # index into x of the write that keeps tgt, if any
    kept = (src >= 0) & (src < s)
    rows = torch.arange(b, device=buf.device)[:, None]
    new = torch.gather(x.to(buf.dtype), 1, src.clamp(0, s - 1)[:, :, None, None].expand_as(x))
    buf[rows, tgt] = torch.where(kept[:, :, None, None], new, buf[rows, tgt])


def _block(params: Params, i: int, x, cos, sin, explicit_mask, entry, positions,
           block_tables, padding_mask, write_slots, segment_ids, *, config: ModelConfig,
           compute_dtype,
           decode_attention, attention_impl: str, attention_fn, trunk_matmul=None,
           adapter_idx=None, tensor_group=None, nf4_origin=None, gather=None, tensor=None):
    """One transformer block; updates a cache ``entry`` (paged, or dense at
    ``write_slots``) in place. ``adapter_idx`` picks each row's pooled
    adapter in the seven projections. The head counts are the weights' (a
    rank's own under tensor parallelism); ``tensor_group`` all-reduces the
    row-parallel o_proj and down_proj in place (serving); ``tensor``
    (training) places the collectives under autograd (module docstring).
    ``gather(params, i)`` (ZeRO-3) makes the block's sharded leaves whole
    first, inside a rematerialized block, so the backward's replay gathers
    them again."""
    if gather is not None:
        params = gather(params, i)
    b, s, _ = x.shape
    d = config.resolved_head_dim
    eps = config.rms_norm_eps
    p = f"model.layers.{i}."
    copy = row_group = lora_part = reduce = None
    if tensor is not None:
        copy = functools.partial(copy_to_tensor, group=tensor.group)
        reduce = functools.partial(reduce_from_tensor, group=tensor.group)
        lora_part = tensor.lora
        row_group = tensor.group if trunk_matmul is not None else None
    elif tensor_group is not None:
        reduce = functools.partial(tp_all_reduce_, group=tensor_group)
    linear = functools.partial(_linear, params=params, compute_dtype=compute_dtype,
                               trunk_matmul=trunk_matmul, adapter_idx=adapter_idx,
                               nf4_origin=nf4_origin, lora_part=lora_part)

    row_linear = functools.partial(linear, reduce=reduce, row_group=row_group)

    hid = rms_norm(x, params[p + "input_layernorm.weight"], eps)
    if copy is not None:
        hid = copy(hid)
    q = linear(hid, name=p + "self_attn.q_proj").reshape(b, s, -1, d)
    k = linear(hid, name=p + "self_attn.k_proj").reshape(b, s, -1, d)
    v = linear(hid, name=p + "self_attn.v_proj").reshape(b, s, -1, d)
    if config.uses_rope(i):
        q, k = apply_rope(q, k, cos, sin)

    out = None
    if entry is not None and block_tables is None:
        # dense cache: the whole buffer is the key range, slot == position
        _dense_write(entry["k"], write_slots, k)
        _dense_write(entry["v"], write_slots, v)
        k, v = entry["k"], entry["v"]
    elif entry is not None:
        # Paged cache: the entry is the global pool [num_blocks, L, hkv, d];
        # row r's logical position p lives in cell (table[r, p // L], p % L).
        # A position past the table view clips into its last entry, as in
        # the JAX version; the engine sizes tables so that never happens.
        L = entry["k"].shape[1]
        nb = block_tables.shape[1]
        blk = torch.gather(block_tables.long(), 1, torch.clamp(positions // L, 0, nb - 1))
        off = positions % L
        if "k_scale" in entry:
            # the blocks a row's s consecutive positions span (at most
            # (s + L - 2) // L + 1 of them, the last repeated to fill), so a
            # chunk rescales each block once instead of once per token
            span = torch.arange((s + L - 2) // L + 1, device=x.device)
            idx = torch.minimum(positions[:, :1] // L + span, positions[:, -1:] // L)
            touched = torch.gather(block_tables.long(), 1, torch.clamp(idx, 0, nb - 1))
            quantize_kv_write(entry["k"], entry["k_scale"], blk, off, k, touched)
            quantize_kv_write(entry["v"], entry["v_scale"], blk, off, v, touched)
            if s == 1:
                # decode: the fused kernel reads the int8 blocks in place
                out = decode_attention(
                    q, entry["k"], entry["v"], entry["k_scale"], entry["v_scale"],
                    block_tables, lengths=(positions[:, 0] + 1).to(torch.int32),
                    scale=float(d) ** -0.5,
                )
            else:
                k = dequantize_kv_gather(entry["k"], entry["k_scale"], block_tables, compute_dtype)
                v = dequantize_kv_gather(entry["v"], entry["v_scale"], block_tables, compute_dtype)
        else:
            entry["k"][blk, off] = k.to(entry["k"].dtype)  # in place
            entry["v"][blk, off] = v.to(entry["v"].dtype)
            flat = block_tables.reshape(-1).long()
            k = entry["k"][flat].reshape(b, nb * L, -1, d)
            v = entry["v"][flat].reshape(b, nb * L, -1, d)
    if out is None:
        if explicit_mask is not None:
            out = xla_attention(q, k, v, mask=explicit_mask, causal=False)
        else:
            out = attention_fn(q, k, v, impl=attention_impl, padding_mask=padding_mask,
                               segment_ids=segment_ids, causal=True)

    out = out.reshape(b, s, -1)
    x = x + row_linear(out, name=p + "self_attn.o_proj")
    hid = rms_norm(x, params[p + "post_attention_layernorm.weight"], eps)
    if copy is not None:
        hid = copy(hid)
    gate = linear(hid, name=p + "mlp.gate_proj")
    up = linear(hid, name=p + "mlp.up_proj")
    return x + row_linear(F.silu(gate) * up, name=p + "mlp.down_proj")


def _dots_no_batch_policy(ctx, op, *args, **kwargs):
    """Selective remat that keeps the outputs of the block's 2-D matmuls
    (the projections; attention's batched products are recomputed), as
    JAX's ``dots_with_no_batch_dims_saveable`` does."""
    policy = torch_checkpoint.CheckpointPolicy
    if op == torch.ops.aten.mm.default:
        return policy.MUST_SAVE
    return policy.PREFER_RECOMPUTE


def _remat(block_fn, remat_policy: Optional[str]):
    """``block_fn`` under ``torch.utils.checkpoint`` (non-reentrant): "full"
    keeps only the block's inputs, "dots_no_batch" also its projection
    outputs."""
    if remat_policy in (None, "full"):
        context_fn = torch_checkpoint.noop_context_fn
    elif remat_policy == "dots_no_batch":
        context_fn = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_no_batch_policy)
    else:
        raise NotImplementedError(
            f"remat_policy={remat_policy!r} is not ported ({_JAX_FORWARD} has "
            "'dots' and 'mlp'); use 'full' or 'dots_no_batch'"
        )

    def run(*args):
        # a block draws no random numbers, so the RNG state is not replayed
        return torch_checkpoint.checkpoint(block_fn, *args, use_reentrant=False,
                                           preserve_rng_state=False, context_fn=context_fn)
    return run


def forward(
    params: Params,
    input_ids: torch.Tensor,
    config: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    attention_impl: str = "xla",
    remat: bool = False,
    remat_policy: Optional[str] = None,
    cache: Optional[dict] = None,
    cache_pos=0,
    block_tables: Optional[torch.Tensor] = None,
    compute_dtype=torch.bfloat16,
    logits_dtype=torch.float32,
    output_hidden: bool = False,
    decode_attention=paged_decode_attention,
    attention_fn=attention,
    frozen_layers: int = 0,
    frozen_compute: str = "bf16",
    trunk_matmul=int8_w8a8_matmul,
    adapter_idx: Optional[torch.Tensor] = None,
    mesh=None,
    gather=None,
    tensor=None,
):
    """Run the model.

    ``input_ids`` int [batch, seq]. Without ``cache``: causal attention over
    the sequence through ``attention_fn(q, k, v, impl=attention_impl,
    padding_mask=..., causal=True)`` (``ops.attention.attention``: "flash"
    is the flash kernels, "xla" the plain masked attention), with
    ``padding_mask`` [batch, seq] (1 = real token). ``remat`` recomputes
    each block in the backward (``remat_policy`` "full" or
    "dots_no_batch"); it applies only while autograd records.

    Packed rows (``data/packing.py``): ``segment_ids`` [batch, seq] (1..n,
    0 = the pad tail) go to the attention, which attends within equal ids
    (the flash kernels mask by segment themselves), and ``positions``
    [batch, seq] restart at each segment for RoPE. Both are refused with a
    cache, as in the JAX forward; packed rows of a sliding-window model
    (an explicit windowed mask there) are not ported.

    With a dense ``cache`` (``init_cache``, buffers [batch, max_len, ...]):
    the chunk sits at positions ``cache_pos + arange(seq)`` and attends to
    every buffer slot <= its position (plain masked attention). A scalar
    ``cache_pos`` writes the same slots in every row, its start clamped so
    that the chunk fits, as ``dynamic_update_slice`` clamps it; a [batch]
    tensor writes row i at ``cache_pos[i] + t`` and drops slots past the
    buffer, as the JAX scatter does.

    With ``cache`` (``init_paged_cache``) and ``block_tables``
    [batch, nb] int32: the chunk is written into the pool at positions
    ``cache_pos + arange(seq)`` (``cache_pos`` a scalar or a [batch] tensor)
    and attends through each row's table to every position <= its own. An
    int8 pool's one-token decode goes through ``decode_attention``, the
    paged decode kernel's wrapper.

    Frozen trunk (``frozen_compute="int8"``, no cache): layers ``[0,
    frozen_layers)`` run under ``torch.no_grad()``, never rematerialized and
    with no backward (the JAX package's ``stop_gradient`` at the trunk's
    entry and exit), and their ``kernel_int8`` projections go through
    ``trunk_matmul(x, q, compute_dtype)`` (the w8a8 kernel's entry). The tied
    embedding's gradient through the trunk is dropped, as in the JAX package.
    ``"bf16"`` or ``frozen_layers=0`` leaves the forward as it is.

    ``adapter_idx`` [batch] (int): each row's slot in the adapter
    registry's pooled LoRA leaves (``infer/adapters.py``); None runs no
    pooled delta (every row on the base model, slot 0).

    ``decode_attention``, ``attention_fn`` and ``trunk_matmul`` default to
    the kernels' wrappers; a caller may pass another function of the same
    signature (a plain version, for a comparison).

    ``mesh`` (a serving mesh, ``runtime/mesh.make_serving_mesh``) with a
    tensor group: ``params`` are this rank's slices (``shard_params``), the
    cache holds its local kv heads, and the forward issues the tensor-
    parallel collectives (module docstring). The logits are the full row on
    every rank.

    ``gather`` (``parallel/optimizer.FsdpShards.gather``, ZeRO-3 training):
    ``params`` hold this rank's fsdp slices; ``gather(params, None)`` makes
    the leaves outside the blocks whole once (the tied embedding serves the
    lookup and the unembed), and each block gathers its own leaves as it
    starts (``_block``), under its rematerialization.

    ``tensor`` (``parallel/sharding.TensorShards``, tensor-parallel
    training; no cache): ``params`` are this rank's tensor slices (of which
    ``gather`` makes the fsdp slices whole), the forward issues the
    collectives under autograd, and the logits are this rank's vocab slice
    ``[batch, seq, vocab / tp]``.

    Returns ``(logits [batch, seq, vocab] in logits_dtype, cache)``, or the
    final-norm hidden states in ``compute_dtype`` with ``output_hidden``.
    The cache is updated in place and returned.
    """
    if tensor is not None and (cache is not None or mesh is not None):
        raise ValueError("tensor (training) takes no cache and no serving mesh")
    if segment_ids is not None and config.sliding_window is not None:
        raise NotImplementedError(
            f"packed rows of a sliding-window model are not ported ({_JAX_FORWARD} builds their "
            "windowed block-diagonal mask)"
        )
    check_supported(config)
    if segment_ids is not None and cache is not None:
        raise ValueError("segment_ids (packing) and KV cache are exclusive")
    if cache is not None and padding_mask is not None:
        raise NotImplementedError(
            f"padding_mask with a KV cache is not ported ({_JAX_FORWARD} has it)"
        )
    b, s = input_ids.shape
    device = input_ids.device
    per_row = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
    if positions is None:
        offset = cache_pos[:, None] if per_row else cache_pos
        positions = (torch.arange(s, device=device)[None, :] + offset).expand(b, s)
    positions = positions.to(device=device, dtype=torch.long)

    group = mesh.tensor_group if mesh is not None else None
    nf4_origin = None
    if group is not None and mesh.tensor_size > 1:
        nf4_origin = functools.partial(nf4_slice_origin, config=config, tp=mesh.tensor_size,
                                       index=mesh.tensor_index)
    if tensor is not None:
        nf4_origin = functools.partial(nf4_slice_origin, config=config, tp=tensor.size,
                                       index=tensor.index)
    if gather is not None:
        params = gather(params, None)
    if tensor is not None:
        x = _embed(params, input_ids, compute_dtype, tensor.group,
                   reduce=functools.partial(reduce_from_tensor, group=tensor.group),
                   index=tensor.index)
    else:
        x = _embed(params, input_ids, compute_dtype, group)
    cos, sin = rope_cos_sin(positions, config.resolved_head_dim, config.rope_theta, config=config)

    explicit_mask = write_slots = None
    if cache is not None:
        # buffer slot (dense) or gathered view index (paged) == logical
        # position, so key j is visible to query i iff j <= position(i)
        if block_tables is None:
            rows, kv_len = cache["layers"]["0"]["k"].shape[:2]
            if rows != b:
                raise ValueError(f"a dense cache of {rows} rows for a batch of {b} (a paged "
                                 "pool needs block_tables)")
            if s > kv_len:
                raise ValueError(f"a {s}-token chunk does not fit a {kv_len}-slot cache")
            write_slots = positions
            if not per_row:
                start = min(max(int(cache_pos), 0), kv_len - s)
                write_slots = torch.arange(start, start + s, device=device)[None, :].expand(b, s)
        else:
            kv_len = block_tables.shape[1] * cache["layers"]["0"]["k"].shape[1]
        k_pos = torch.arange(kv_len, device=device)[None, None, :]
        explicit_mask = k_pos <= positions[:, :, None]

    if adapter_idx is not None:
        adapter_idx = adapter_idx.to(device=device, dtype=torch.long)
    rematerialize = remat and cache is None and torch.is_grad_enabled()
    trunk = frozen_layers if frozen_compute == "int8" and cache is None else 0
    for i in range(config.num_layers):
        entry = cache["layers"][str(i)] if cache is not None else None
        block_fn = functools.partial(
            _block, params, i, config=config, compute_dtype=compute_dtype,
            decode_attention=decode_attention, attention_impl=attention_impl,
            attention_fn=attention_fn, trunk_matmul=trunk_matmul if i < trunk else None,
            adapter_idx=adapter_idx, tensor_group=group, nf4_origin=nf4_origin,
            gather=gather, tensor=tensor,
        )
        args = (cos, sin, explicit_mask, entry, positions, block_tables, padding_mask,
                write_slots, segment_ids)
        if i < trunk:
            with torch.no_grad():
                x = block_fn(x, *args)
            continue
        if rematerialize:
            block_fn = _remat(block_fn, remat_policy)
        x = block_fn(x, *args)
    x = rms_norm(x, params["model.norm.weight"], config.rms_norm_eps)
    if output_hidden:
        return x.to(compute_dtype), cache
    return unembed(params, x, config, compute_dtype=compute_dtype, logits_dtype=logits_dtype,
                   mesh=mesh, tensor=tensor), cache


def _embed(params: Params, input_ids: torch.Tensor, compute_dtype, group, reduce=None,
           index=None) -> torch.Tensor:
    """The embedding rows of ``input_ids`` in ``compute_dtype``. Under a
    tensor group the table is this rank's vocab rows (rank ``index`` of the
    group, by default its rank in it): ids outside them give zero rows, and
    the all-reduce (``reduce``, by default serving's in place) sums the one
    rank's row that holds each."""
    table = params["model.embed_tokens.weight"]
    if group is None:
        return F.embedding(input_ids, table).to(compute_dtype)
    rows = table.shape[0]
    local = input_ids - (dist.get_rank(group) if index is None else index) * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), table).to(compute_dtype)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=compute_dtype, device=x.device))
    return (reduce or functools.partial(tp_all_reduce_, group=group))(x)


def unembed(params: Params, hidden: torch.Tensor, config: ModelConfig, *,
            compute_dtype=torch.bfloat16, logits_dtype=torch.float32, mesh=None,
            tensor=None) -> torch.Tensor:
    """hidden [..., hidden] -> logits [..., vocab], tied or not. Under a
    ``mesh``'s tensor group the weights give this rank's vocab slice, and
    one all-gather makes the full row on every rank; under ``tensor``
    (training) the hidden states pass "copy to tensor" and the logits stay
    this rank's vocab slice."""
    if tensor is not None:
        hidden = copy_to_tensor(hidden, tensor.group)
    h = hidden.to(compute_dtype)
    if config.tie_word_embeddings:
        logits = h @ params["model.embed_tokens.weight"].to(compute_dtype).T
    else:
        logits = h @ params["lm_head.kernel"].to(compute_dtype)
    logits = logits.to(logits_dtype)
    group = mesh.tensor_group if mesh is not None else None
    if group is None:
        return logits
    return tp_all_gather_last(logits, group, mesh.tensor_size, mesh.tensor_index)


def init_cache(config: ModelConfig, batch_size: int, max_len: int, *,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """Dense KV cache for autoregressive decoding: per layer k and v buffers
    [batch_size, max_len, kv_heads, head_dim] of zeros."""
    shape = (batch_size, max_len, config.num_kv_heads, config.resolved_head_dim)
    return {"layers": {str(i): {"k": torch.zeros(shape, dtype=dtype, device=device),
                                "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for i in range(config.num_layers)}}


def insert_cache_row(cache: dict, row_cache: dict, slot: int) -> dict:
    """Write a batch-1 cache's K/V into the leading positions of row
    ``slot`` of a dense multi-row cache, in place, leaving the other rows
    untouched: a freed decode slot adopts a freshly prefilled prompt while
    its neighbours keep decoding.

    ``row_cache`` may be shorter than ``cache`` (the prompt bucket against
    the decode buffer); only its leading positions are overwritten. The
    stale K/V past them is harmless while slot == position: every position
    ``j`` is rewritten (by the prefill or by decode token ``j - prompt_len``)
    before a query at ``j`` or later can attend to it, and positions above a
    query are masked."""
    for i, entry in cache["layers"].items():
        row = row_cache["layers"][i]
        for n in ("k", "v"):
            entry[n][slot, : row[n].shape[1]] = row[n][0].to(entry[n].dtype)
    return cache


def init_paged_cache(config: ModelConfig, num_blocks: int, block_len: int, *,
                     dtype=torch.bfloat16, kv_quant: str = "none", device="cpu") -> dict:
    """Global paged KV pool: per layer one [num_blocks, block_len, kv_heads,
    head_dim] buffer shared by every decode slot. Block 0 is the null block.
    ``kv_quant="int8"`` stores int8 codes plus f32 absmax scales
    [num_blocks, kv_heads] that start at 0 ("never written")."""
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(f"unknown kv_quant mode {kv_quant!r} (expected one of {KV_QUANT_MODES})")
    shape = (num_blocks, block_len, config.num_kv_heads, config.resolved_head_dim)

    def entry():
        if kv_quant == "int8":
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros((num_blocks, config.num_kv_heads), dtype=torch.float32, device=device),
                "v_scale": torch.zeros((num_blocks, config.num_kv_heads), dtype=torch.float32, device=device),
            }
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }

    return {"layers": {str(i): entry() for i in range(config.num_layers)}}
