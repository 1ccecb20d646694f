"""Dataset loading, the train/validation split and ChatML tokenization
(counterpart of the JAX ``data/dataset.py``).

- ``load_qa_dataset`` reads the JSONL source by ``data/convert.py``'s rule
  (each line ``{"topic", "question", "answer"}`` becomes ``{"full-question":
  "For {topic}, {question}", "answer": answer}``), which gives exactly the
  rows of ``qa_dataset.parquet``. The card's machine has no ``pyarrow``.
- ``train_validation_split`` reproduces HF ``Dataset.train_test_split(
  test_size, seed)`` with numpy alone: ``n_test = ceil(test_size * n)``,
  ``n_train = n - n_test``, one ``np.random.default_rng(seed).permutation(n)``,
  test rows first, both in permutation order.
- ``build_sft_arrays`` tokenizes to fixed-length rows with a loss mask, the
  JAX package's arrays bit for bit.
"""

from __future__ import annotations

import json
import math
import warnings
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT


def load_qa_dataset(path: str) -> List[Dict[str, str]]:
    """Read the QA JSONL into a list of {'full-question', 'answer'} rows;
    malformed lines are skipped with a warning, as the converter skips them."""
    if path.endswith(".parquet"):
        raise ValueError(
            f"{path}: the port reads the JSONL source, not parquet (the card's machine "
            "has no pyarrow); use data/final_qa_data_unique.jsonl, which holds the same rows"
        )
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                rows.append({"full-question": f"For {obj['topic']}, {obj['question']}",
                             "answer": obj["answer"]})
            except (json.JSONDecodeError, KeyError) as e:
                warnings.warn(f"{path}:{lineno}: skipping malformed line ({e})", stacklevel=2)
    return rows


def train_validation_split(rows: List[dict], test_size: float = 0.1,
                           seed: int = 42) -> Tuple[List[dict], List[dict]]:
    """(train, test) as HF ``train_test_split(test_size=test_size,
    seed=seed)`` gives them."""
    n = len(rows)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    perm = np.random.default_rng(seed).permutation(n)
    test = [rows[i] for i in perm[:n_test]]
    train = [rows[i] for i in perm[n_test:n_test + n_train]]
    return train, test


def format_chat_example(row: dict, system_prompt: str = WILDERNESS_EXPERT_SYSTEM_PROMPT):
    """Row -> 3-role ChatML messages."""
    return {
        "messages": [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": row["full-question"]},
            {"role": "assistant", "content": row["answer"]},
        ]
    }


@dataclass
class TokenizedExample:
    input_ids: np.ndarray  # [seq] int32, padded with pad_token_id
    loss_mask: np.ndarray  # [seq] float32, 1.0 where loss is computed
    length: int            # true (unpadded) length


def tokenize_example(messages: List[dict], tokenizer, max_seq_length: int,
                     completion_only: bool = False) -> TokenizedExample:
    """Tokenize a conversation to fixed length. ``loss_mask[t]`` gates the
    loss of predicting token ``t`` from position ``t - 1``; position 0 is
    never counted."""
    full_ids = tokenizer.apply_chat_template(messages, tokenize=True)
    if completion_only:
        prompt_len = len(tokenizer.apply_chat_template(
            messages[:-1], tokenize=True, add_generation_prompt=True))
    else:
        prompt_len = 1
    full_ids = full_ids[:max_seq_length]
    length = len(full_ids)
    input_ids = np.full((max_seq_length,), tokenizer.pad_token_id, dtype=np.int32)
    input_ids[:length] = np.asarray(full_ids, dtype=np.int32)
    loss_mask = np.zeros((max_seq_length,), dtype=np.float32)
    start = min(prompt_len, length)
    loss_mask[start:length] = 1.0
    return TokenizedExample(input_ids=input_ids, loss_mask=loss_mask, length=length)


def tokenize_rows(rows: List[dict], tokenizer, max_seq_length: int, completion_only: bool = False,
                  system_prompt: str = WILDERNESS_EXPERT_SYSTEM_PROMPT) -> List[TokenizedExample]:
    return [
        tokenize_example(format_chat_example(r, system_prompt)["messages"], tokenizer,
                         max_seq_length, completion_only)
        for r in rows
    ]


def build_sft_arrays(rows: List[dict], tokenizer, max_seq_length: int, completion_only: bool = False,
                     system_prompt: str = WILDERNESS_EXPERT_SYSTEM_PROMPT) -> Dict[str, np.ndarray]:
    """Stacked ``input_ids`` int32, ``loss_mask`` and ``attention_mask`` f32
    (1 on real tokens, right padding), ``lengths`` int32."""
    examples = tokenize_rows(rows, tokenizer, max_seq_length, completion_only, system_prompt)
    input_ids = np.stack([e.input_ids for e in examples])
    lengths = np.asarray([e.length for e in examples], dtype=np.int32)
    attention_mask = (np.arange(input_ids.shape[1])[None, :] < lengths[:, None]).astype(np.float32)
    return {
        "input_ids": input_ids,
        "loss_mask": np.stack([e.loss_mask for e in examples]),
        "attention_mask": attention_mask,
        "lengths": lengths,
    }
