"""Sharding rules: leaf name -> the mesh axis of each dim (counterpart of the
JAX ``parallel/sharding.py``, whose rules match ``/`` paths; the port's
leaves are dotted, ``model.layers.0.self_attn.q_proj.kernel``).

A spec is a tuple with one entry per leading dim: an axis name, or None
(replicated on that dim). The rules are the JAX package's, first match wins:

- attention q/k/v and MLP gate/up kernels ``[in, out]``: (fsdp, tensor);
  o_proj and down ``[in, out]``: (tensor, fsdp); the embedding ``[vocab,
  hidden]``: (tensor, fsdp); ``lm_head``: (fsdp, tensor); LoRA A ``[in,
  r]``: (fsdp,), B ``[r, out]``: (None, fsdp); NF4 and int8 codes keep their
  kernel's orientation; norms, biases and scalars are replicated.
- ``_validate_spec`` drops an axis that does not divide its dim (that dim is
  then replicated), and trailing Nones.

The trainer reads one thing from them: the dim of each trainable leaf that
the ``fsdp`` axis splits, over which the AdamW state is sharded
(``fsdp_dim``). The tensor-axis entries, the KV-cache rules and the batch
specs are kept as data for tensor-parallel serving, which is not ported.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

Spec = Tuple[Optional[str], ...]

_QK = r"kernel(_nf4|_absmax|_absmax_q|_int8)?$"
_MATRIX_RULES = [
    # attention projections
    (re.compile(r".*self_attn\.(q_proj|k_proj|v_proj)\." + _QK), ("fsdp", "tensor")),
    (re.compile(r".*self_attn\.o_proj\." + _QK), ("tensor", "fsdp")),
    # MLP
    (re.compile(r".*mlp\.(gate_proj|up_proj)\." + _QK), ("fsdp", "tensor")),
    (re.compile(r".*mlp\.down_proj\." + _QK), ("tensor", "fsdp")),
    # embeddings: [vocab, hidden], vocab over tensor, hidden over fsdp
    (re.compile(r".*embed_tokens\.weight$"), ("tensor", "fsdp")),
    (re.compile(r".*lm_head\.kernel$"), ("fsdp", "tensor")),
    # LoRA adapters: A [in, r] like the base kernel's in-dim, B [r, out]
    (re.compile(r".*\.lora_a$"), ("fsdp", None)),
    (re.compile(r".*\.lora_b$"), (None, "fsdp")),
    # stacked adapter pools (infer/adapters.py): a leading [max_adapters] dim
    (re.compile(r".*\.lora_a_pool$"), (None, "fsdp", None)),
    (re.compile(r".*\.lora_b_pool$"), (None, None, "fsdp")),
    # MoE expert stacks and router (the JAX package's ops/moe.py)
    (re.compile(r".*block_sparse_moe\.experts\.(w1|w3)(_nf4|_absmax|_absmax_q)?$"),
     ("expert", "fsdp", "tensor")),
    (re.compile(r".*block_sparse_moe\.experts\.w2(_nf4|_absmax|_absmax_q)?$"),
     ("expert", "tensor", "fsdp")),
    (re.compile(r".*block_sparse_moe\.gate\.kernel$"), ("fsdp", None)),
]

# KV cache / paged block pool leaves [rows|blocks, len, kv_heads, head_dim]
# (and their int8 scales [blocks, kv_heads]): kv heads over tensor
KV_LEAF_DIMS: Dict[str, Spec] = {
    "k": (None, None, "tensor", None),
    "v": (None, None, "tensor", None),
    "k_scale": (None, "tensor"),
    "v_scale": (None, "tensor"),
}
# batch arrays [batch, seq, ...]: batch over (data, fsdp); with ring
# attention, the sequence over seq too
BATCH_SPEC = (("data", "fsdp"),)
BATCH_SPEC_SEQ = (("data", "fsdp"), "seq")


def param_spec(name: str, ndim: int) -> Spec:
    """The spec of one leaf, before validation against a mesh."""
    if ndim <= 1:
        return ()  # norms / biases / scalars: replicated
    for pat, dims in _MATRIX_RULES:
        if pat.match(name):
            return dims
    return ()


def _validate_spec(spec: Spec, shape: Sequence[int], mesh_shape: Dict[str, int]) -> Spec:
    """``spec`` with every axis that does not divide its dim replaced by
    None (and the optional ``expert`` axis where the mesh has none), trailing
    Nones dropped."""
    fixed = []
    for i, axis in enumerate(spec):
        if axis is None or (axis == "expert" and axis not in mesh_shape):
            fixed.append(None)
            continue
        size = mesh_shape[axis]
        fixed.append(axis if i < len(shape) and shape[i] % size == 0 else None)
    while fixed and fixed[-1] is None:
        fixed.pop()
    return tuple(fixed)


def leaf_spec(name: str, shape: Sequence[int], mesh_shape: Dict[str, int]) -> Spec:
    return _validate_spec(param_spec(name, len(shape)), shape, mesh_shape)


def fsdp_dim(name: str, shape: Sequence[int], mesh_shape: Dict[str, int]) -> Optional[int]:
    """The dim of a leaf that the ``fsdp`` axis splits on this mesh, or None
    (the leaf, and its optimizer state, stay whole)."""
    if mesh_shape.get("fsdp", 1) <= 1:
        return None
    spec = leaf_spec(name, shape, mesh_shape)
    return spec.index("fsdp") if "fsdp" in spec else None
