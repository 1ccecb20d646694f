"""QLoRA: an NF4 frozen base under trainable LoRA adapters (counterpart of
the JAX ``parallel/qlora.py``).

After the adapters are attached (``parallel/lora.add_lora_params``) and the
parameters split into trainable and frozen (``parallel/freeze.py``), every
frozen 2-D block linear ``kernel`` becomes its NF4 siblings
(``ops/nf4.quantize_nf4``), from full precision. ``models/transformer.
_linear`` dispatches on ``kernel_nf4``, so the forward, the eval and
generation run off the quantized base. The embedding, the lm_head, the
norms, biases and any MoE router stay in full precision.

Not here: ``quantize_frozen_abstract`` (the shape-level planner of sharded
init) and the stacked MoE and pipeline layouts, which wait for meshes, MoE
and pipeline parallelism (``models/transformer.check_supported`` refuses MoE
models; ``ops/nf4.quantize_nf4`` raises on a 3-D leaf).
"""

from __future__ import annotations

from typing import Dict

import torch

from llm_fine_tune_distributed_tpu_torch.ops.int8 import is_block_linear
from llm_fine_tune_distributed_tpu_torch.ops.nf4 import (
    DEFAULT_BLOCK_SIZE,
    DEQUANT_MARKERS,
    dequantize_nf4,
    quantize_nf4,
)

Params = Dict[str, torch.Tensor]


def quantize_frozen(frozen: Params, block_size: int = DEFAULT_BLOCK_SIZE,
                    double_quant: bool = True) -> Params:
    """Replace each frozen block-linear ``kernel`` with its NF4 siblings, on
    the leaf's device, in the dict's order; other leaves (and kernels whose
    in-dim does not divide ``block_size``) pass through."""
    out: Params = {}
    for name, leaf in frozen.items():
        if not is_block_linear(name) or leaf.shape[0] % block_size:
            out[name] = leaf
            continue
        q = quantize_nf4(leaf, block_size, double_quant)
        for suffix, arr in q.items():
            out[f"{name}_{suffix}"] = arr
    return out


def dequantize_frozen(frozen: Params, dtype=torch.bfloat16) -> Params:
    """Inverse for the export: each group of NF4 siblings -> its
    ``kernel`` in ``dtype`` (at the first sibling's place); other leaves pass
    through."""
    out: Params = {}
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, leaf in frozen.items():
        for marker in DEQUANT_MARKERS:
            if name.endswith("kernel" + marker):
                base = name[: -len(marker)]
                if base not in groups:
                    groups[base] = {}
                    out[base] = None  # keep the kernel's place in the order
                groups[base][marker[1:]] = leaf
                break
        else:
            out[name] = leaf
    for base, q in groups.items():
        out[base] = dequantize_nf4(q, dtype=dtype)
    return out


def quantized_fraction(frozen: Params) -> float:
    """Share of the frozen bytes held in NF4 form (codes and scales)."""
    q_bytes = total = 0
    for name, leaf in frozen.items():
        nbytes = leaf.numel() * leaf.element_size()
        total += nbytes
        tail = name.rpartition(".")[2]
        if tail.startswith(("kernel_nf4", "kernel_absmax")):
            q_bytes += nbytes
    return q_bytes / total if total else 0.0
