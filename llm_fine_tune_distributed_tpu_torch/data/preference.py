"""Preference pairs for DPO (counterpart of the JAX ``data/preference.py``,
the same rows and arrays bit for bit).

Accepted schemas: ``prompt`` / ``chosen`` / ``rejected`` rows (the TRL DPO
convention), or QA rows (``full-question`` / ``answer``), from which pairs
are synthesized: chosen = the row's answer, rejected = the answer of
another row (a seeded rotation, which is a derangement).

One difference from the JAX package: ``load_rows`` reads JSONL only (the
card's machine has no ``pyarrow``), and a JSONL in the repo's source schema
(``topic`` / ``question`` / ``answer``) is read as QA rows by
``data/dataset.load_qa_dataset``'s rule, which gives exactly the rows of
``qa_dataset.parquet``.
"""

from __future__ import annotations

import json
import warnings
from typing import Dict, List

import numpy as np

from llm_fine_tune_distributed_tpu_torch.data.dataset import load_qa_dataset, tokenize_example
from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT


def synthesize_preference_rows(qa_rows: List[dict], seed: int = 42) -> List[dict]:
    """QA rows -> preference rows by a seeded answer rotation (1..n-1
    places). Fewer than 2 rows form no pair: an empty list."""
    n = len(qa_rows)
    if n < 2:
        return []
    rng = np.random.RandomState(seed)
    shift = int(rng.randint(1, n))
    return [
        {"prompt": row["full-question"], "chosen": row["answer"],
         "rejected": qa_rows[(i + shift) % n]["answer"]}
        for i, row in enumerate(qa_rows)
    ]


def load_rows(path: str) -> List[dict]:
    """Raw rows of a JSONL file (any schema; the source schema as QA rows)."""
    if not path.endswith(".jsonl"):
        raise ValueError(
            f"{path}: the port reads JSONL only (the card's machine has no pyarrow); "
            "use data/final_qa_data_unique.jsonl or a prompt/chosen/rejected JSONL")
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        raise ValueError(f"empty preference dataset: {path}")
    if {"topic", "question", "answer"} <= set(rows[0]):
        return load_qa_dataset(path)
    return rows


def preference_schema(rows: List[dict]) -> str:
    """'preference' (prompt/chosen/rejected) or 'qa' (full-question/answer)."""
    cols = set(rows[0])
    if {"prompt", "chosen", "rejected"} <= cols:
        return "preference"
    if {"full-question", "answer"} <= cols:
        return "qa"
    raise ValueError(
        f"unrecognized preference schema {sorted(cols)}; expected "
        "prompt/chosen/rejected or full-question/answer"
    )


def load_preference_dataset(path: str, seed: int = 42) -> List[dict]:
    """Preference rows of a file, synthesized from QA rows over the WHOLE
    file (a trainer splits first and synthesizes within each split)."""
    rows = load_rows(path)
    if preference_schema(rows) == "qa":
        return synthesize_preference_rows(rows, seed=seed)
    return rows


def build_dpo_arrays(rows: List[dict], tokenizer, max_seq_length: int,
                     system_prompt: str = WILDERNESS_EXPERT_SYSTEM_PROMPT
                     ) -> Dict[str, np.ndarray]:
    """Preference rows -> ``chosen_*`` / ``rejected_*`` ``input_ids`` int32,
    ``loss_mask`` and ``attention_mask`` f32 [n, max_seq_length]. Both sides
    share the prompt, and the loss masks cover the completion only. Raises
    when every pair lost its completion to truncation, warns when some did."""
    keys = ("chosen_input_ids", "chosen_loss_mask", "chosen_attention_mask",
            "rejected_input_ids", "rejected_loss_mask", "rejected_attention_mask")
    if not rows:
        return {k: np.zeros((0, max_seq_length), np.int32 if "input_ids" in k else np.float32)
                for k in keys}
    out = {k: [] for k in keys}
    for row in rows:
        for side in ("chosen", "rejected"):
            messages = [
                {"role": "system", "content": system_prompt},
                {"role": "user", "content": row["prompt"]},
                {"role": "assistant", "content": row[side]},
            ]
            ex = tokenize_example(messages, tokenizer, max_seq_length, completion_only=True)
            attn = (np.arange(max_seq_length) < ex.length).astype(np.float32)
            out[f"{side}_input_ids"].append(ex.input_ids)
            out[f"{side}_loss_mask"].append(ex.loss_mask)
            out[f"{side}_attention_mask"].append(attn)
    arrays = {k: np.stack(v) for k, v in out.items()}
    dead = (arrays["chosen_loss_mask"].sum(-1) == 0) | (arrays["rejected_loss_mask"].sum(-1) == 0)
    if dead.all():
        raise ValueError(
            f"every preference pair lost its completion to truncation at "
            f"max_seq_length={max_seq_length}; raise the limit or shorten the "
            f"system prompt ({len(system_prompt)} chars)"
        )
    if dead.any():
        warnings.warn(
            f"{int(dead.sum())}/{len(dead)} preference pairs have truncated "
            f"completions (zero loss mask) at max_seq_length={max_seq_length}"
        )
    return arrays
