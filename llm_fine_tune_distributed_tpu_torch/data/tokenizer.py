"""Dependency-free byte-level ChatML tokenizer.

A copy of the JAX package's ``data/tokenizer.ByteChatMLTokenizer`` (the port
imports nothing of that package), so ids and chat templates are identical in
both. HF tokenizers need ``transformers`` and are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence


class ByteChatMLTokenizer:
    """Byte-level tokenizer with ChatML special tokens: 256 raw bytes, then
    specials. Implements the subset of the HF tokenizer interface the port
    uses (``apply_chat_template``, ``encode``, ``decode``, eos/pad ids)."""

    IM_START = 256
    IM_END = 257
    BOS = 258
    EOS = 257  # ChatML convention: <|im_end|> terminates a turn
    _ROLE_OFFSET = 259  # system / user / assistant role tokens

    ROLES = ("system", "user", "assistant")

    MARKER_FILE = "byte_chatml_tokenizer.json"

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 262:
            raise ValueError(f"vocab_size must be >= 262, got {vocab_size}")
        self.vocab_size = vocab_size
        self.eos_token_id = self.EOS
        self.pad_token_id = self.EOS
        self.eos_token = "<|im_end|>"
        self.pad_token = "<|im_end|>"
        self.name_or_path = "byte-chatml"

    def save_pretrained(self, path: str) -> None:
        """Marker file so ``load_tokenizer_dir`` can rebuild this tokenizer."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, self.MARKER_FILE), "w") as f:
            json.dump({"tokenizer_class": "ByteChatMLTokenizer", "vocab_size": self.vocab_size}, f)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            ids = [self.BOS] + ids
        return ids

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text)}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i < 256:
                out.append(i)
            elif not skip_special_tokens:
                token = {
                    self.IM_START: b"<|im_start|>",
                    self.IM_END: b"<|im_end|>",
                    self.BOS: b"<|bos|>",
                }.get(i, f"<|{i}|>".encode())
                out.extend(token)
        return bytes(out).decode("utf-8", errors="replace")

    def _role_id(self, role: str) -> int:
        return self._ROLE_OFFSET + self.ROLES.index(role)

    def apply_chat_template(self, messages, tokenize: bool = True,
                            add_generation_prompt: bool = False, **kw):
        ids: List[int] = []
        for m in messages:
            ids.append(self.IM_START)
            ids.append(self._role_id(m["role"]))
            ids.extend(self.encode(m["content"]))
            ids.append(self.IM_END)
        if add_generation_prompt:
            ids.append(self.IM_START)
            ids.append(self._role_id("assistant"))
        if tokenize:
            return ids
        return self.decode(ids, skip_special_tokens=False)


def load_tokenizer(name_or_path: Optional[str]):
    """``"byte-chatml"``/None -> the byte tokenizer."""
    if name_or_path in (None, "byte-chatml"):
        return ByteChatMLTokenizer()
    raise NotImplementedError(
        f"HF tokenizer {name_or_path!r}: not ported (needs transformers; "
        "llm_fine_tune_distributed_tpu.data.tokenizer.load_tokenizer has it)"
    )
