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

The trainer reads one thing from them: the dim of each leaf, trainable or
frozen, that the ``fsdp`` axis splits (``fsdp_dim``), over which ZeRO-3
slices the leaf and its AdamW state (``parallel/optimizer.FsdpShards``).
Tensor-parallel serving reads the ``tensor`` entries: ``shard_params``
gives a rank its slice of every leaf (the JAX
``shard_params``' addressable shard) and ``local_model_config`` the head
counts and widths of that slice; ``kv_cache_spec`` is the KV rules'. The
batch specs stay data (the port's trainer splits batches itself).

Where the JAX package replicates a leaf whose tensor dim the axis does not
divide (``_validate_spec``), the port refuses, with one exception: when
``tp`` does not divide the kv heads, each rank keeps the kv head(s) its
query heads read (the JAX cache's head replication, without the copies a
rank does not read), so the paged kernel's ``q head -> kv head`` index
stays ``i // G`` with the local G.

NF4 leaves (``--quantize nf4``, quantized whole before the split, as the
JAX server does) shard like their kernel: the packed codes ``[in/8, out]``
and the absmax ``[in/block, out]`` by columns beside a column-parallel
kernel and by rows beside a row-parallel one; the double quantization's
``absmax_scale`` (one f32 per group of 256 *flat* absmax entries) and
``absmax_offset`` stay whole, so a rank dequantizes its slice from its
origin in the whole absmax (``nf4_slice_origin``). A row-parallel slice
that would not start on a whole packed word and a whole absmax block is
refused. A single adapter's ``lora_a [in, r]`` / ``lora_b [r, out]`` split
by their kernel's rule, as the adapter registry's factors do
(``shard_lora_factors``; the JAX rules give them no tensor axis: there each
device computes the whole delta).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch

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


# ------------------------------------------------------- tensor-parallel serving

_JAX_SHARDING = "llm_fine_tune_distributed_tpu.parallel.sharding.shard_params"
_JAX_VALIDATE = "llm_fine_tune_distributed_tpu.parallel.sharding._validate_spec"
_KV_PROJ = (".self_attn.k_proj", ".self_attn.v_proj")


def kv_cache_spec(name: str, shape: Sequence[int], mesh_shape: Dict[str, int]) -> Spec:
    """The spec of a dense cache or paged pool leaf named ``name`` (its
    last dotted part: ``k``, ``v``, ``k_scale``, ``v_scale``): kv heads over
    ``tensor``, dropped when the axis does not divide them."""
    dims = KV_LEAF_DIMS.get(name.rsplit(".", 1)[-1])
    if dims is None or len(dims) != len(shape):
        return ()
    return _validate_spec(dims, shape, mesh_shape)


def kv_heads_of_rank(config, tp: int, index: int) -> Tuple[int, int]:
    """(first kv head, count) that rank ``index`` of ``tp`` keeps: its query
    heads' kv heads. ``ValueError`` when ``tp`` does not divide the query
    heads, or the ranks would need different kv head counts."""
    hq, hkv = config.num_heads, config.num_kv_heads
    if hq % tp:
        raise ValueError(f"--tp {tp} does not divide the {hq} query heads of {config.name}")
    group, per_rank = hq // hkv, hq // tp
    if per_rank % group and group % per_rank:
        raise ValueError(f"--tp {tp}: the {per_rank} query heads of a rank straddle kv heads "
                         f"({hq} query heads over {hkv} kv heads)")
    first = index * per_rank // group
    return first, max(per_rank // group, 1)


def local_model_config(config, tp: int):
    """The model config of one rank's slice at ``tp``: its query and kv
    heads, its MLP width and its vocab rows (the head width kept)."""
    if tp == 1:
        return config
    for what, n in (("intermediate size", config.intermediate_size),
                    ("vocab", config.vocab_size)):
        if n % tp:
            raise ValueError(f"--tp {tp} does not divide the {what} {n} of {config.name} (the "
                             f"JAX {_JAX_SHARDING} replicates such a leaf; the port refuses)")
    _, hkv = kv_heads_of_rank(config, tp, 0)
    return config.replace(num_heads=config.num_heads // tp, num_kv_heads=hkv,
                          intermediate_size=config.intermediate_size // tp,
                          vocab_size=config.vocab_size // tp, head_dim=config.resolved_head_dim)


def _tensor_range(module: str, dim: int, size: int, config, tp: int, index: int):
    """[start, stop) of rank ``index``'s slice of a ``size``-long tensor dim
    of ``module``'s kernel: kv heads for k/v, an even split otherwise."""
    if module.endswith(_KV_PROJ) and dim == 1:
        first, n = kv_heads_of_rank(config, tp, index)
        d = config.resolved_head_dim
        return first * d, (first + n) * d
    if size % tp:
        raise ValueError(f"--tp {tp} does not divide dim {dim} ({size}) of {module} (the JAX "
                         f"{_JAX_SHARDING} replicates it; the port refuses)")
    n = size // tp
    return index * n, (index + 1) * n


def _split_dims(name: str, ndim: int) -> Optional[Tuple[int, int]]:
    """(dim of the leaf ``name``, dim of its module's kernel) that the
    ``tensor`` axis splits, or None where the leaf stays whole: a matrix by
    its own rule (NF4 codes and absmax like their kernel), a 1-D bias or
    int8 scale beside a column-parallel kernel, ``lora_b``'s columns beside
    a column-parallel kernel and ``lora_a``'s rows beside a row-parallel
    one."""
    module, _, leaf = name.rpartition(".")
    if leaf in ("lora_a", "lora_b") or ndim <= 1:
        kspec = param_spec(module + ".kernel", 2)
        if "tensor" not in kspec:
            return None
        kdim = kspec.index("tensor")
        if leaf in ("lora_a", "lora_b"):
            return (kdim, kdim) if (kdim == 0) == (leaf == "lora_a") else None
        if kdim == 1 and leaf in ("bias", "kernel_int8_scale"):
            return 0, 1
        return None  # beside a row-parallel kernel, or a scale of the whole: whole
    spec = param_spec(name, ndim)
    if "tensor" not in spec:
        return None
    dim = spec.index("tensor")
    return dim, dim


def shard_leaf(name: str, t: torch.Tensor, config, tp: int, index: int) -> torch.Tensor:
    """Rank ``index`` of ``tp``'s slice of the leaf ``name`` (the rules of
    ``shard_params``): a copy of its own where it is sliced, ``t`` itself
    where the leaf stays whole."""
    if tp == 1:
        return t
    module, _, leaf = name.rpartition(".")
    if "lora_" in leaf and leaf not in ("lora_a", "lora_b", "lora_scale"):
        raise NotImplementedError(
            f"{name}: adapter pool leaves in the weights under --tp {tp} are not ported (the "
            "adapter registry slices its pools itself, infer/adapters.py)")
    dims = _split_dims(name, t.dim())
    if dims is None:
        return t
    dim, kernel_dim = dims
    if kernel_dim == 0 and leaf.startswith(("kernel_nf4", "kernel_absmax")) and t.shape[0] % tp:
        what = "packed word" if leaf == "kernel_nf4" else "absmax block"
        raise ValueError(
            f"--tp {tp}: {name} {tuple(t.shape)} of a row-parallel kernel cannot start every "
            f"rank's rows on a whole {what} (the JAX {_JAX_VALIDATE} replicates this leaf; "
            "the port refuses)")
    start, stop = _tensor_range(module, kernel_dim, t.shape[dim], config, tp, index)
    return t.narrow(dim, start, stop - start).clone()


def nf4_slice_origin(module: str, absmax_shape: Sequence[int], config, tp: int,
                     index: int) -> Tuple[int, int, int]:
    """(first absmax row, first column, whole out) of rank ``index``'s NF4
    slice of ``module`` in the whole ``[in/block, out]`` absmax, whose
    flat row-major entries the double quantization groups by 256: the
    rank's entry (r, c) is whole entry ``(row0 + r, col0 + c)``.
    ``absmax_shape`` is the rank's own."""
    rows, cols = absmax_shape
    dims = _split_dims(module + ".kernel_absmax_q", 2) if tp > 1 else None
    if dims is None:
        return 0, 0, cols
    if dims[0] == 0:
        return index * rows, 0, cols
    whole = (config.num_kv_heads * config.resolved_head_dim if module.endswith(_KV_PROJ)
             else cols * tp)
    start, _ = _tensor_range(module, 1, whole, config, tp, index)
    return 0, start, whole


def shard_params(params: Dict[str, torch.Tensor], mesh, config) -> Dict[str, torch.Tensor]:
    """This rank's slice of every leaf on the serving ``mesh``, each a copy
    of its own (so the whole leaves can be freed): q/k/v/gate/up and
    ``lm_head`` columns, o/down rows, the embedding's vocab rows, int8 codes
    like their kernel with the per-channel scales sliced beside a
    column-parallel kernel and whole beside a row-parallel one, column-
    parallel biases sliced, NF4 and single-adapter LoRA leaves as the module
    docstring says; norms and the rest whole. ``config`` is the whole
    model's (the kv heads' mapping)."""
    tp, index = mesh.tensor_size, mesh.tensor_index
    return {name: shard_leaf(name, t, config, tp, index) for name, t in params.items()}


def shard_lora_factors(module: str, a: torch.Tensor, b: torch.Tensor, config, tp: int,
                       index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``index``'s slice of one adapter's factors ``A [in, r]``,
    ``B [r, out]`` of ``module``, by its kernel's rule (``shard_leaf``'s for
    ``lora_a`` / ``lora_b``): a column-parallel kernel's B by output
    columns (A whole), a row-parallel kernel's A by input rows (B whole), so
    that the rank's delta is its share of the whole delta (summed by the
    row-parallel all-reduce)."""
    return (shard_leaf(module + ".lora_a", a, config, tp, index),
            shard_leaf(module + ".lora_b", b, config, tp, index))


def unshard_leaf(name: str, parts, config, tp: int) -> torch.Tensor:
    """The whole leaf from every rank's slice (``parts``, in rank order):
    the inverse of ``shard_leaf``. A kv head several ranks hold (the
    fallback) is taken once."""
    if tp == 1:
        return parts[0]
    module = name.rpartition(".")[0]
    t = parts[0]
    dims = _split_dims(name, t.dim())
    if dims is None:
        return t
    dim, kernel_dim = dims
    if module.endswith(_KV_PROJ) and kernel_dim == 1:
        size = config.num_kv_heads * config.resolved_head_dim
    else:
        size = t.shape[dim] * tp
    shape = list(t.shape)
    shape[dim] = size
    whole = torch.empty(shape, dtype=t.dtype, device=t.device)
    for index, part in enumerate(parts):
        start, stop = _tensor_range(module, kernel_dim, size, config, tp, index)
        whole.narrow(dim, start, stop - start).copy_(part)
    return whole


# ------------------------------------------------------- tensor-parallel training

_LORA = ("lora_a", "lora_b")


def _training_split_dims(name: str, ndim: int) -> Optional[Tuple[int, int]]:
    """``_split_dims`` under the training rules: the JAX rules give LoRA
    factors no tensor axis, so ``lora_a`` / ``lora_b`` stay whole (each
    rank uses its part of them, ``TensorShards.lora``)."""
    if name.rpartition(".")[2] in _LORA:
        return None
    return _split_dims(name, ndim)


class TensorShards:
    """Training's ``tensor`` axis (Megatron, as the JAX rules place it under
    the trainer's GSPMD): rank ``index`` of ``size`` holds its slice of
    every leaf the rules split over ``tensor`` (q/k/v and gate/up columns,
    o/down rows, the embedding's vocab rows, an untied ``lm_head``'s
    columns, the column-parallel biases, NF4 codes and absmax and int8 codes
    like their kernel), the JAX trainer's addressable shard; norms,
    row-parallel biases, scalars and the LoRA factors stay whole. A 1-D
    leaf beside a column-parallel kernel (a bias, an int8 column scale) is
    sliced with its kernel's columns, the only ones the rank uses (the JAX
    rules replicate 1-D leaves; none of SmolLM3's is such a bias). ``group``
    is the rank's tensor group; ``shapes`` holds the whole shape of each
    sliced leaf, filled by ``local``.

    A ``size`` that does not divide a split dim (the kv heads, the query
    heads, the MLP width or the vocab) raises: the JAX ``_validate_spec``
    replicates such a leaf over ``tensor``, which the port's trainer does
    not (yet)."""

    def __init__(self, config, size: int, index: int, group=None):
        for what, n in (("kv heads", config.num_kv_heads), ("query heads", config.num_heads),
                        ("intermediate size", config.intermediate_size),
                        ("vocab", config.vocab_size)):
            if n % size:
                raise NotImplementedError(
                    f"mesh axis tensor={size} does not divide the {what} ({n}) of {config.name}: "
                    f"the JAX {_JAX_VALIDATE} replicates such leaves over tensor; the PyTorch "
                    "trainer does not")
        self.config, self.size, self.index, self.group = config, size, index, group
        self.shapes: Dict[str, torch.Size] = {}

    @classmethod
    def for_mesh(cls, mesh, config) -> Optional["TensorShards"]:
        """None when the mesh's tensor axis is 1."""
        if mesh.shape["tensor"] <= 1:
            return None
        return cls(config, mesh.shape["tensor"], mesh.tensor_index, mesh.tensor_group)

    def range(self, module: str, kernel_dim: int, size: int) -> Tuple[int, int]:
        """[start, stop) of this rank's slice of ``module``'s kernel dim of
        ``size`` (whole)."""
        return _tensor_range(module, kernel_dim, size, self.config, self.size, self.index)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf ``name`` (a copy of its own,
        trainable ones still requiring grad; int8 codes K-major, as the w8a8
        kernel reads them); a leaf that stays whole is ``t`` itself."""
        if _training_split_dims(name, t.dim()) is None:
            return t
        self.shapes[name] = t.shape
        with torch.no_grad():
            part = shard_leaf(name, t.detach(), self.config, self.size, self.index)
            if name.endswith(".kernel_int8"):
                from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import kmajor

                part = kmajor(part)
        return part.requires_grad_(True) if t.requires_grad else part

    def local_all(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.local(k, v) for k, v in leaves.items()}

    def sliced(self, name: str) -> bool:
        """Whether this rank holds a slice of ``name`` (not the whole)."""
        return name in self.shapes

    def partial(self, name: str) -> bool:
        """A whole leaf whose gradient on a rank is its share of the whole
        gradient, summed over the tensor group: the LoRA factors (each rank
        uses its part of them). A norm's is whole on every rank already."""
        return name.rpartition(".")[2] in _LORA

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's slice ``t`` (a collective over
        the tensor group: every rank of it calls it for the same leaf);
        ``t`` itself for a whole leaf."""
        if name not in self.shapes:
            return t
        from llm_fine_tune_distributed_tpu_torch.runtime.distributed import all_gather_rows

        flat = t.detach().contiguous().reshape(-1)
        rows = all_gather_rows(flat, self.group, self.size, self.index)
        parts = [rows[i].view(t.shape) for i in range(self.size)]
        return unshard_leaf(name, parts, self.config, self.size)

    def lora(self, module: str, a: torch.Tensor, b: torch.Tensor):
        """The parts of a whole ``A [in, r]``, ``B [r, out]`` this rank
        uses: B's local columns beside a column-parallel kernel, A's local
        rows beside a row-parallel one (whose partial delta the row
        all-reduce sums)."""
        kspec = param_spec(module + ".kernel", 2)
        if "tensor" not in kspec:
            return a, b
        if kspec.index("tensor") == 1:
            start, stop = self.range(module, 1, b.shape[1])
            return a, b.narrow(1, start, stop - start)
        start, stop = self.range(module, 0, a.shape[0])
        return a.narrow(0, start, stop - start), b
