"""Sequence packing: several tokenized examples per ``[max_seq_length]``
row (counterpart of the JAX ``data/packing.py``, the same arrays bit for
bit).

A packed row keeps each example exact:

- ``segment_ids`` (1..n per row, 0 = the pad tail) restrict attention to
  equal ids, causally (the flash kernels mask by segment themselves);
- ``positions`` restart at 0 in each segment, so RoPE sees in-segment
  distances;
- each example's loss mask already zeroes its first position, so no loss
  crosses a segment boundary.

Packing is deterministic first-fit over the split's row order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from llm_fine_tune_distributed_tpu_torch.data.dataset import TokenizedExample, tokenize_rows
from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT


def pack_examples(examples: List[TokenizedExample], max_seq_length: int) -> Dict[str, np.ndarray]:
    """First-fit pack variable-length examples into fixed-length rows:
    ``input_ids`` int32, ``loss_mask`` and ``attention_mask`` f32 (1 where
    ``segment_ids`` > 0), ``segment_ids`` and ``positions`` int32, all
    [n_rows, max_seq_length]."""
    bins: List[List[TokenizedExample]] = []
    space: List[int] = []
    for ex in examples:
        ln = int(ex.length)
        if ln <= 0:
            continue
        for i, free in enumerate(space):
            if free >= ln:
                bins[i].append(ex)
                space[i] -= ln
                break
        else:
            bins.append([ex])
            space.append(max_seq_length - ln)

    n = len(bins)
    out = {
        "input_ids": np.zeros((n, max_seq_length), np.int32),
        "loss_mask": np.zeros((n, max_seq_length), np.float32),
        "attention_mask": np.zeros((n, max_seq_length), np.float32),
        "segment_ids": np.zeros((n, max_seq_length), np.int32),
        "positions": np.zeros((n, max_seq_length), np.int32),
    }
    for r, row in enumerate(bins):
        cursor = 0
        for seg, ex in enumerate(row, start=1):
            ln = int(ex.length)
            sl = slice(cursor, cursor + ln)
            out["input_ids"][r, sl] = ex.input_ids[:ln]
            out["loss_mask"][r, sl] = ex.loss_mask[:ln]
            out["attention_mask"][r, sl] = 1.0
            out["segment_ids"][r, sl] = seg
            out["positions"][r, sl] = np.arange(ln, dtype=np.int32)
            cursor += ln
    return out


def build_packed_sft_arrays(rows: List[dict], tokenizer, max_seq_length: int,
                            completion_only: bool = False,
                            system_prompt: str = WILDERNESS_EXPERT_SYSTEM_PROMPT
                            ) -> Dict[str, np.ndarray]:
    """Tokenize and pack a whole split (``build_sft_arrays`` for
    ``packing=True``), with ``lengths`` int32 = the real tokens per row."""
    examples = tokenize_rows(rows, tokenizer, max_seq_length, completion_only, system_prompt)
    packed = pack_examples(examples, max_seq_length)
    packed["lengths"] = packed["attention_mask"].sum(axis=1).astype(np.int32)
    return packed


def packing_efficiency(packed: Dict[str, np.ndarray]) -> float:
    """Share of the packed positions that hold real tokens (1.0 = no pad)."""
    am = packed["attention_mask"]
    return float(am.sum() / am.size) if am.size else 0.0
