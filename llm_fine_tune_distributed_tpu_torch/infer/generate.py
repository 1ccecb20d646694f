"""Autoregressive generation over a dense KV cache or the block-paged KV
pool (counterpart of the JAX ``infer/generate.py``).

PyTorch runs eagerly, so where the JAX ``Generator`` builds and caches one
jitted program per shape (``_build_batch``, ``_build_stream``,
``paged_step``, ``paged_prefill_chunk``, ``paged_prefill_final``), the
methods here run the steps directly, and a Python loop replaces
``jax.lax.while_loop``. Caches are updated in place.

Dense decode (``generate_batch``, ``generate_ids``, ``generate_stream``,
``chat``): right-padded prompts prefill a whole bucket of
``_PROMPT_BUCKET``; row i's generated token t is written at cache slot
``len_i + t``, so slot == position per row and the pad slots not yet
overwritten sit past every query's position, hence masked. The batch loop
reads one bool ("every row done") on the host per step, the one sync
``while_loop``'s condition costs; the stream reads its tokens once per
chunk. Sampling draws from one ``torch.Generator`` seeded by ``seed`` per
call, so sampled tokens differ from the JAX package's (greedy ones agree).

Slot decode (the continuous engines): ``init_slot_state`` / ``slot_prefill``
/ ``slot_step`` over a dense ``[slots, buf_len]`` cache, and
``init_paged_state`` / ``paged_prefill_chunk`` / ``paged_prefill_final`` /
``paged_step`` over the block pool; both steps sample through
``_advance_slots``. Per-slot state: ``last`` (the slot's last token),
``pos`` (its position), ``seen`` ([slots, vocab] bool, for the repetition
penalty), and per slot the request's ``GenerationConfig`` and a
``torch.Generator`` seeded by the request, so a sampled stream is
deterministic in (request, seed) and independent of its neighbours.
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
    init_cache,
    init_paged_cache,
    insert_cache_row,
    unembed,
)

_PROMPT_BUCKET = 256
_JAX_SPEC = "llm_fine_tune_distributed_tpu.infer.generate.Generator._build_spec"


class Generator:
    """Generation over a flat parameter dict on one device: dense-cache
    decode and the paged engine's steps."""

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        model_config: ModelConfig,
        tokenizer,
        *,
        compute_dtype=torch.bfloat16,
        eos_token_ids: Optional[Sequence[int]] = None,
        device=None,
        draft_params=None,
        draft_config: Optional[ModelConfig] = None,
    ):
        if draft_params is not None or draft_config is not None:
            raise NotImplementedError(f"draft-model speculation is not ported ({_JAX_SPEC} has it)")
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

    # ------------------------------------------------------- dense decode

    def _step_logits(self, token_ids: torch.Tensor, cache: dict, cache_pos) -> torch.Tensor:
        """Feed ``token_ids`` [b, s] at ``cache_pos``; the last position's logits."""
        hidden, _ = forward(self.params, token_ids, self.config, cache=cache,
                            cache_pos=cache_pos, compute_dtype=self.compute_dtype,
                            output_hidden=True)
        return unembed(self.params, hidden[:, -1], self.config, compute_dtype=self.compute_dtype)

    def _prompt_prefill(self, prompts: List[List[int]], slack: int, gen: GenerationConfig,
                        rng: torch.Generator):
        """Cache init (the prompt bucket + ``slack`` slots) + prefill of the
        right-padded bucket + each row's last-position logits + the seen set
        + the first token. Returns
        ``(first [b], cache, seen [b, vocab], prompt_lens [b])``."""
        b = len(prompts)
        bucket = -(-max(len(p) for p in prompts) // _PROMPT_BUCKET) * _PROMPT_BUCKET
        padded = np.zeros((b, bucket), np.int64)
        for i, p in enumerate(prompts):
            padded[i, : len(p)] = p
        ids = self._tensor(padded)
        lens = self._tensor(np.array([len(p) for p in prompts], np.int64))
        rows = torch.arange(b, device=self.device)
        cache = init_cache(self.config, b, bucket + slack, dtype=self.compute_dtype,
                           device=self.device)
        hidden, _ = forward(self.params, ids, self.config, cache=cache, cache_pos=0,
                            compute_dtype=self.compute_dtype, output_hidden=True)
        logits = unembed(self.params, hidden[rows, lens - 1], self.config,
                         compute_dtype=self.compute_dtype)
        valid = torch.arange(bucket, device=self.device)[None, :] < lens[:, None]
        safe_ids = torch.where(valid, ids, ids[:, :1])
        seen = torch.zeros(b, self.config.vocab_size, dtype=torch.bool, device=self.device)
        seen[rows[:, None], safe_ids] = True
        first = sample_token(logits, seen, gen, generator=rng)
        seen[rows, first] = True
        return first, cache, seen, lens

    def _check_plain(self, gen: GenerationConfig) -> None:
        if gen.speculative_lookup > 0:
            raise NotImplementedError(
                f"speculative decoding (speculative_lookup={gen.speculative_lookup}) is not "
                f"ported ({_JAX_SPEC} has it)"
            )

    def _trim_at_eos(self, toks: List[int]) -> List[int]:
        for i, tok in enumerate(toks):
            if tok in self.eos_token_ids:
                return toks[:i]
        return toks

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       gen: Optional[GenerationConfig] = None, seed: int = 0,
                       live_rows: Optional[int] = None) -> List[List[int]]:
        """Generate continuations of a ragged batch of prompts together, each
        row trimmed at its first EOS. A row that is done emits ``eos[0]``
        while the others go on; the loop ends when every row is done or at
        ``max_new_tokens``. Greedy rows equal their prompt's solo run.
        ``live_rows`` (the window batcher's count of real rows before its
        pads) only feeds the JAX package's speculation telemetry, which is
        not ported; the output does not depend on it."""
        gen = gen or GenerationConfig()
        self._check_plain(gen)
        prompts = [[int(t) for t in p] for p in prompts]
        if not prompts or any(not p for p in prompts):
            raise ValueError("generate_batch needs >= 1 non-empty prompt")
        rng = torch.Generator(device=self.device).manual_seed(int(seed))
        first, cache, seen, lens = self._prompt_prefill(prompts, gen.max_new_tokens, gen, rng)
        b = len(prompts)
        rows = torch.arange(b, device=self.device)
        eos = self._tensor(np.array(self.eos_token_ids, np.int64))
        out = torch.zeros(b, gen.max_new_tokens, dtype=torch.long, device=self.device)
        out[:, 0] = first
        done = torch.isin(first, eos)
        t = 1
        # the host reads "every row done" once per step (while_loop's condition)
        while t < gen.max_new_tokens and not bool(done.all()):
            logits = self._step_logits(out[:, t - 1: t], cache, lens + (t - 1))
            nxt = sample_token(logits, seen, gen, generator=rng)
            hit_eos = torch.isin(nxt, eos)
            if self.eos_token_ids:
                nxt = torch.where(done, self.eos_token_ids[0], nxt)
            out[:, t] = nxt
            seen[rows, nxt] = True
            done |= hit_eos
            t += 1
        return [self._trim_at_eos(row) for row in out.cpu().tolist()]

    def generate_ids(self, prompt_ids: Sequence[int], gen: Optional[GenerationConfig] = None,
                     seed: int = 0) -> List[int]:
        """Continuation token ids of one prompt (a batch of 1)."""
        return self.generate_batch([prompt_ids], gen, seed)[0]

    def generate_stream(self, prompt_ids: Sequence[int], gen: Optional[GenerationConfig] = None,
                        seed: int = 0, chunk: int = 8):
        """Yield generated token ids in lists of up to ``chunk`` as they
        decode; the stream ends at EOS or ``max_new_tokens``. Each chunk runs
        ``chunk`` steps on the card and is read back once; the cache has
        ``chunk`` slots of slack, so the last chunk may overrun
        ``max_new_tokens`` and the host trims it. The tokens are
        ``generate_ids``'s, greedy and sampled."""
        gen = gen or GenerationConfig()
        self._check_plain(gen)
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("generate_stream needs a non-empty prompt")
        if chunk < 1:
            raise ValueError(f"stream chunk must be >= 1, got {chunk}")
        rng = torch.Generator(device=self.device).manual_seed(int(seed))
        last, cache, seen, lens = self._prompt_prefill([prompt], gen.max_new_tokens + chunk,
                                                       gen, rng)
        first = int(last[0])
        if first in self.eos_token_ids:
            return
        yield [first]
        emitted = 1
        while emitted < gen.max_new_tokens:
            toks = torch.zeros(1, chunk, dtype=torch.long, device=self.device)
            for i in range(chunk):
                # token emitted+i reads token emitted+i-1 at slot len+emitted+i-1
                logits = self._step_logits(last[:, None], cache, lens + (emitted + i - 1))
                last = sample_token(logits, seen, gen, generator=rng)
                seen[0, last] = True
                toks[:, i] = last
            row = toks[0].cpu().tolist()[: gen.max_new_tokens - emitted]
            emitted += len(row)
            out = self._trim_at_eos(row)
            if out:
                yield out
            if len(out) < len(row):
                return

    def chat(self, messages: List[dict], gen: Optional[GenerationConfig] = None, seed: int = 0,
             **template_kwargs) -> str:
        """ChatML conversation -> the assistant's reply text (only the
        generated ids are decoded)."""
        ids = self.generate_ids(self.encode_chat(messages, **template_kwargs), gen, seed)
        return self.decode_reply(ids)

    # ------------------------------------------------- dense slot decode

    def _fresh_slot_state(self, slots: int) -> dict:
        return {
            "last": torch.zeros(slots, dtype=torch.long, device=self.device),
            "pos": torch.zeros(slots, dtype=torch.long, device=self.device),
            "seen": torch.zeros(slots, self.config.vocab_size, dtype=torch.bool, device=self.device),
            "gen": [GenerationConfig(do_sample=False) for _ in range(slots)],
            "rng": [None] * slots,
        }

    def init_slot_state(self, slots: int, buf_len: int):
        """Fresh (cache, state) for a ``slots``-wide persistent decode over a
        dense ``[slots, buf_len]`` cache."""
        cache = init_cache(self.config, slots, buf_len, dtype=self.compute_dtype,
                           device=self.device)
        return cache, self._fresh_slot_state(slots)

    def _first_token(self, logits: torch.Tensor, seen_row: torch.Tensor, state: dict,
                     slot: int, prompt_len: int, gen: GenerationConfig, seed: int) -> int:
        """Sample a prompt's first token from its last position's logits
        [1, vocab] and hand the slot to the request: its last token,
        position, seen set, config and generator seeded by ``seed``."""
        rng = torch.Generator(device=self.device).manual_seed(int(seed))
        first = int(sample_token(logits, seen_row, gen, generator=rng)[0])
        seen_row[0, first] = True
        state["last"][slot] = first
        state["pos"][slot] = prompt_len
        state["seen"][slot] = seen_row[0]
        state["gen"][slot] = gen
        state["rng"][slot] = rng
        return first

    def slot_prefill(self, cache, state, prompt_ids: np.ndarray, prompt_len: int, slot: int,
                     gen: GenerationConfig, seed: int) -> int:
        """Prefill one prompt, right-padded to its bucket (``prompt_ids``
        [1, bucket]), in a private batch-1 cache; sample its first token from
        position ``prompt_len - 1`` as ``_prompt_prefill`` does (the pad keys
        sit above every real query, so the token does not depend on the
        bucket); copy the K/V into row ``slot`` of ``cache`` and set the
        slot's state. Returns the first token."""
        ids = self._tensor(prompt_ids).long()
        small = init_cache(self.config, 1, ids.shape[1], dtype=self.compute_dtype,
                           device=self.device)
        hidden, _ = forward(self.params, ids, self.config, cache=small, cache_pos=0,
                            compute_dtype=self.compute_dtype, output_hidden=True)
        logits = unembed(self.params, hidden[:, prompt_len - 1], self.config,
                         compute_dtype=self.compute_dtype)
        seen_row = torch.zeros(1, self.config.vocab_size, dtype=torch.bool, device=self.device)
        seen_row[0, ids[0, :prompt_len]] = True
        first = self._first_token(logits, seen_row, state, slot, prompt_len, gen, seed)
        insert_cache_row(cache, small, slot)
        return first

    def _advance_slots(self, logits: torch.Tensor, state: dict, live: np.ndarray,
                       next_pos: torch.Tensor) -> torch.Tensor:
        """Every slot's next token from its logits [slots, vocab], each with
        its own config and generator: greedy slots by one argmax over the
        penalized logits, sampled live slots one by one. Live slots take the
        token into ``last`` and ``seen`` and move to ``next_pos``; dead
        slots keep their state. Returns the tokens [slots] on the device."""
        seen, last = state["seen"], state["last"]
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
        state["pos"] = torch.where(live_t, next_pos, state["pos"])
        return tok

    def slot_step(self, cache, state, live: np.ndarray) -> np.ndarray:
        """One decode step over every slot of the dense cache: feed each
        slot's last token at its own position (a [slots] ``cache_pos``) and
        sample each live slot's next token. Dead slots run too, writing
        their own row at their frozen position, and keep their state; live
        slots advance to ``min(pos + 1, buf_len - 1)``. Returns the tokens
        [slots] on the host."""
        pos = state["pos"]
        hidden, _ = forward(self.params, state["last"][:, None], self.config, cache=cache,
                            cache_pos=pos, compute_dtype=self.compute_dtype, output_hidden=True)
        logits = unembed(self.params, hidden[:, -1], self.config, compute_dtype=self.compute_dtype)
        next_pos = (pos + 1).clamp(max=cache["layers"]["0"]["k"].shape[1] - 1)
        return self._advance_slots(logits, state, live, next_pos).cpu().numpy()

    # ------------------------------------------------- paged continuous decode

    def init_paged_state(self, slots: int, num_blocks: int, block_len: int,
                         kv_quant: str = "none"):
        """Fresh (pool, state) for a ``slots``-wide persistent decode."""
        pool = init_paged_cache(
            self.config, num_blocks, block_len, dtype=self.compute_dtype,
            kv_quant=kv_quant, device=self.device,
        )
        return pool, self._fresh_slot_state(slots)

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
        return self._first_token(logits, self._tensor(seen_row), state, slot, prompt_len, gen,
                                 seed)

    def paged_step(self, pool, state, live: np.ndarray, tables: np.ndarray) -> np.ndarray:
        """One decode step for every slot: feed each slot's last token at
        its position, sample each live slot's next token with its own config
        and generator. Dead rows run too (their all-null tables send their
        writes to the null block) and keep their state. Returns the tokens
        [slots] on the host."""
        pos = state["pos"]
        hidden, _ = forward(
            self.params, state["last"][:, None], self.config, cache=pool, cache_pos=pos,
            block_tables=self._tensor(tables), compute_dtype=self.compute_dtype,
            output_hidden=True,
        )
        logits = unembed(self.params, hidden[:, -1], self.config, compute_dtype=self.compute_dtype)
        return self._advance_slots(logits, state, live, pos + 1).cpu().numpy()

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
