"""Generation over the block-paged KV pool (counterpart of the JAX
``infer/generate.py`` paged programs).

PyTorch runs eagerly, so where the JAX ``Generator`` builds and caches one
jitted program per shape (``paged_step``, ``paged_prefill_chunk``,
``paged_prefill_final``), the methods of the same names here run the step
directly. The pool is updated in place.

Per-slot state: ``last`` (the slot's last token), ``pos`` (its position),
``seen`` ([slots, vocab] bool, for the repetition penalty), and per slot the
request's ``GenerationConfig`` and a ``torch.Generator`` seeded by the
request, so a sampled stream is deterministic in (request, seed) and
independent of its neighbours.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.device import resolve_device
from llm_fine_tune_distributed_tpu_torch.infer.sampling import (
    GenerationConfig,
    apply_repetition_penalty,
    sample_token,
)
from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig, load_model_config
from llm_fine_tune_distributed_tpu_torch.models.hf_io import load_hf_checkpoint
from llm_fine_tune_distributed_tpu_torch.models.transformer import (
    check_supported,
    forward,
    init_paged_cache,
    unembed,
)


class Generator:
    """Paged generation over a flat parameter dict on one device."""

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        model_config: ModelConfig,
        tokenizer,
        *,
        compute_dtype=torch.bfloat16,
        eos_token_ids: Optional[Sequence[int]] = None,
        device=None,
    ):
        check_supported(model_config)
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.config = model_config
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype
        eos = eos_token_ids
        if eos is None:
            eos = [tokenizer.eos_token_id] if tokenizer.eos_token_id is not None else []
        self.eos_token_ids = tuple(int(e) for e in eos)

    # ------------------------------------------------- paged continuous decode

    def init_paged_state(self, slots: int, num_blocks: int, block_len: int,
                         kv_quant: str = "none"):
        """Fresh (pool, state) for a ``slots``-wide persistent decode."""
        pool = init_paged_cache(
            self.config, num_blocks, block_len, dtype=self.compute_dtype,
            kv_quant=kv_quant, device=self.device,
        )
        state = {
            "last": torch.zeros(slots, dtype=torch.long, device=self.device),
            "pos": torch.zeros(slots, dtype=torch.long, device=self.device),
            "seen": torch.zeros(slots, self.config.vocab_size, dtype=torch.bool, device=self.device),
            "gen": [GenerationConfig(do_sample=False) for _ in range(slots)],
            "rng": [None] * slots,
        }
        return pool, state

    def _tensor(self, array) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def paged_prefill_chunk(self, pool, table: np.ndarray, chunk_ids: np.ndarray,
                            chunk_start: int) -> None:
        """Ingest one prefill chunk [1, C] of one prompt through its block
        table [1, nb], starting at logical position ``chunk_start``."""
        forward(
            self.params, self._tensor(chunk_ids).long(), self.config, cache=pool,
            cache_pos=int(chunk_start), block_tables=self._tensor(table),
            compute_dtype=self.compute_dtype, output_hidden=True,
        )

    def paged_prefill_final(self, pool, state, table: np.ndarray, chunk_ids: np.ndarray,
                            chunk_start: int, prompt_len: int, seen_row: np.ndarray,
                            slot: int, gen: GenerationConfig, seed: int) -> int:
        """Ingest a prompt's last chunk (padded to its bucket), sample the
        first token from the last prompt position, and set the slot's state.
        ``seen_row`` [1, vocab] covers the whole prompt."""
        hidden, _ = forward(
            self.params, self._tensor(chunk_ids).long(), self.config, cache=pool,
            cache_pos=int(chunk_start), block_tables=self._tensor(table),
            compute_dtype=self.compute_dtype, output_hidden=True,
        )
        last_h = hidden[:, prompt_len - 1 - chunk_start]
        logits = unembed(self.params, last_h, self.config, compute_dtype=self.compute_dtype)
        seen = self._tensor(seen_row)
        rng = torch.Generator(device=self.device).manual_seed(int(seed))
        first = int(sample_token(logits, seen, gen, generator=rng)[0])
        seen[0, first] = True
        state["last"][slot] = first
        state["pos"][slot] = prompt_len
        state["seen"][slot] = seen[0]
        state["gen"][slot] = gen
        state["rng"][slot] = rng
        return first

    def paged_step(self, pool, state, live: np.ndarray, tables: np.ndarray) -> np.ndarray:
        """One decode step for every slot: feed each slot's last token at
        its position, sample each live slot's next token with its own config
        and generator. Dead rows run too (their all-null tables send their
        writes to the null block) and keep their state. Returns the tokens
        [slots] on the host."""
        last, pos, seen = state["last"], state["pos"], state["seen"]
        hidden, _ = forward(
            self.params, last[:, None], self.config, cache=pool, cache_pos=pos,
            block_tables=self._tensor(tables), compute_dtype=self.compute_dtype,
            output_hidden=True,
        )
        logits = unembed(self.params, hidden[:, -1], self.config, compute_dtype=self.compute_dtype)
        pen = torch.tensor([g.repetition_penalty for g in state["gen"]],
                           dtype=torch.float32, device=self.device)[:, None]
        tok = torch.argmax(apply_repetition_penalty(logits, seen, pen), dim=-1)
        for slot in np.flatnonzero(live):
            g = state["gen"][slot]
            if g.do_sample:
                tok[slot] = sample_token(
                    logits[slot: slot + 1], seen[slot: slot + 1], g, generator=state["rng"][slot]
                )[0]
        live_t = self._tensor(live)
        tok = torch.where(live_t, tok, last)
        rows = torch.arange(tok.shape[0], device=self.device)
        seen[rows[live_t], tok[live_t]] = True
        state["last"] = tok
        state["pos"] = torch.where(live_t, pos + 1, pos)
        return tok.cpu().numpy()

    # --------------------------------------------------------------- chat

    def encode_chat(self, messages: List[dict], **template_kwargs) -> List[int]:
        """ChatML conversation -> prompt token ids (generation prompt added)."""
        return self.tokenizer.apply_chat_template(
            messages, tokenize=True, add_generation_prompt=True, **template_kwargs
        )

    def decode_reply(self, ids: Sequence[int]) -> str:
        """Generated ids -> assistant reply text."""
        return self.tokenizer.decode(list(ids), skip_special_tokens=True).strip()


# ---------------------------------------------------------------------------
# model-directory loading
# ---------------------------------------------------------------------------


def load_model_dir(path: str, *, device=None, dtype=None) -> Tuple[dict, ModelConfig]:
    """A model directory (``best_model/`` or a local HF Llama-family
    checkpoint: ``config.json`` plus ``*.safetensors``) -> (params,
    ModelConfig) on ``device``; ``dtype=None`` keeps the stored dtype."""
    device = resolve_device(device)
    model_config = load_model_config(path)
    check_supported(model_config)
    return load_hf_checkpoint(path, model_config, dtype=dtype, device=device), model_config


def load_tokenizer_dir(path: str):
    """The tokenizer saved beside the weights: the byte tokenizer's marker
    file. HF tokenizer files need ``transformers`` and are not ported."""
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer

    if os.path.exists(os.path.join(path, ByteChatMLTokenizer.MARKER_FILE)):
        return ByteChatMLTokenizer()
    raise NotImplementedError(
        f"no byte-chatml tokenizer marker under {path}; HF tokenizers are not "
        "ported (llm_fine_tune_distributed_tpu.infer.generate.load_tokenizer_dir "
        "has them)"
    )
