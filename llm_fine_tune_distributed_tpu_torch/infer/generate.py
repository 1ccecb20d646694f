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

Speculation: ``generate_batch`` with ``speculative_lookup = K`` drafts K
tokens per row per step (prompt lookup, or the draft model given as
``draft_params`` / ``draft_config``) and verifies them in one forward
(``_generate_spec``); the engines' fused tick is ``spec_slot_step`` /
``spec_paged_step``, drafting with ``draft_slot_step``.

Slot decode (the continuous engines): ``init_slot_state`` / ``slot_prefill``
/ ``slot_step`` over a dense ``[slots, buf_len]`` cache, and
``init_paged_state`` / ``paged_prefill_chunk`` / ``paged_prefill_final`` /
``paged_step`` over the block pool; both steps sample through
``_advance_slots``. Per-slot state: ``last`` (the slot's last token),
``pos`` (its position), ``seen`` ([slots, vocab] bool, for the repetition
penalty), and per slot the request's ``GenerationConfig`` and a
``torch.Generator`` seeded by the request, so a sampled stream is
deterministic in (request, seed) and independent of its neighbours.

Multi-tenant LoRA: ``state["adapter_idx"]`` ([slots] on the host) holds
each slot's adapter pool slot (0: the base model) and ``state["params"]``
the engine's pooled view (``infer/adapters.AdapterRegistry.params``; None:
the base weights). Every step and prefill forwards through that view with
each row's adapter, dead rows on slot 0; a step whose live rows are all on
slot 0 runs no pooled delta at all. The draft model takes no adapter, as
in the JAX package.
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
    greedy_verify,
    gumbel_noise,
    rejection_sample_step,
    rejection_sample_step_traced,
    sample_token,
    uniform_noise,
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


def pool_leaves(pool: dict) -> List[torch.Tensor]:
    """A paged pool's block-major leaves in the JAX package's flatten order:
    layers by sorted string key ("0", "1", "10", ...), each layer's leaves by
    sorted name (``k``, ``k_scale``, ``v``, ``v_scale`` for int8 codes, ``k``,
    ``v`` otherwise)."""
    layers = pool["layers"]
    return [layers[i][name] for i in sorted(layers) for name in sorted(layers[i])]


def _leaf_views(buf: torch.Tensor, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One block's row of each leaf, as typed views into its host bytes."""
    out, off = [], 0
    for leaf in leaves:
        nb = leaf[0].nbytes
        out.append(buf[off: off + nb].view(leaf.dtype).view(leaf.shape[1:]))
        off += nb
    return out


def _entry_bytes(entry: Sequence[torch.Tensor], width: int) -> torch.Tensor:
    """The host byte buffer that one tier entry's arrays are views of (as
    ``paged_block_gather`` makes them), without a copy."""
    storage = entry[0].untyped_storage()
    if storage.nbytes() != width:
        raise RuntimeError("host-tier entry layout does not match this pool")
    return torch.empty(0, dtype=torch.uint8).set_(storage)


class Generator:
    """Generation over a flat parameter dict on one device: dense-cache
    decode, speculation (with an optional draft model of the same
    vocabulary) and the continuous engines' steps."""

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
        if (draft_params is None) != (draft_config is None):
            raise ValueError("draft_params and draft_config come together")
        if draft_config is not None and draft_config.vocab_size != model_config.vocab_size:
            raise ValueError(
                f"draft vocab {draft_config.vocab_size} != target vocab "
                f"{model_config.vocab_size} — speculation verifies token ids"
            )
        check_supported(model_config)
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self._draft_config = draft_config
        self._draft_params = None
        if draft_params is not None:
            check_supported(draft_config)
            # a draft that is the target's own dict stays one copy
            self._draft_params = (self.params if draft_params is params else
                                  {k: v.to(self.device) for k, v in draft_params.items()})
        self.config = model_config
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype
        eos = eos_token_ids
        if eos is None:
            eos = [tokenizer.eos_token_id] if tokenizer.eos_token_id is not None else []
        self.eos_token_ids = tuple(int(e) for e in eos)
        self._eos = self._tensor(np.array(self.eos_token_ids, np.int64))
        # telemetry of the last generate_batch: sequential forwards (prefill
        # included) and, per live row, drafts proposed and accepted; None
        # after a call that did not speculate
        self.last_spec_steps: Optional[int] = None
        self.last_acceptance_rate: Optional[float] = None
        self.last_row_draft_proposed: Optional[np.ndarray] = None
        self.last_row_draft_accepted: Optional[np.ndarray] = None

    def adopt_params(self, old: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> None:
        """An engine swapped its weights from ``old`` to ``new``: where this
        Generator still holds ``old`` (its own ``params``, and a self-draft
        aliasing them) it takes ``new``, so that the old leaves are freed
        once no engine serves them."""
        if self.params is old:
            self.params = new
        if self._draft_params is old:
            self._draft_params = new

    @property
    def has_draft(self) -> bool:
        """True when a draft model is attached (speculation drafts with it)."""
        return self._draft_params is not None

    @property
    def draft_params(self):
        """The draft model's parameter dict, or None."""
        return self._draft_params

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
        + the first token. Returns ``(first [b], cache, seen [b, vocab],
        prompt_lens [b], padded prompt ids [b, bucket])``."""
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
        return first, cache, seen, lens, ids

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

        ``gen.speculative_lookup = K > 0`` takes the speculative decoder
        (``_generate_spec``): drafts from prompt lookup, or from the draft
        model when one is attached, verified K at a time. ``live_rows`` (the
        window batcher's count of real rows before its pads) bounds the rows
        its telemetry counts; the output does not depend on it."""
        gen = gen or GenerationConfig()
        prompts = [[int(t) for t in p] for p in prompts]
        if not prompts or any(not p for p in prompts):
            raise ValueError("generate_batch needs >= 1 non-empty prompt")
        rng = torch.Generator(device=self.device).manual_seed(int(seed))
        if gen.speculative_lookup > 0:
            return self._generate_spec(prompts, gen, rng, live_rows)
        self.last_spec_steps = self.last_acceptance_rate = None
        self.last_row_draft_proposed = self.last_row_draft_accepted = None
        first, cache, seen, lens, _ = self._prompt_prefill(prompts, gen.max_new_tokens, gen, rng)
        b = len(prompts)
        rows = torch.arange(b, device=self.device)
        out = torch.zeros(b, gen.max_new_tokens, dtype=torch.long, device=self.device)
        out[:, 0] = first
        done = torch.isin(first, self._eos)
        t = 1
        # the host reads "every row done" once per step (while_loop's condition)
        while t < gen.max_new_tokens and not bool(done.all()):
            logits = self._step_logits(out[:, t - 1: t], cache, lens + (t - 1))
            nxt = sample_token(logits, seen, gen, generator=rng)
            hit_eos = torch.isin(nxt, self._eos)
            if self.eos_token_ids:
                nxt = torch.where(done, self.eos_token_ids[0], nxt)
            out[:, t] = nxt
            seen[rows, nxt] = True
            done |= hit_eos
            t += 1
        return [self._trim_at_eos(row) for row in out.cpu().tolist()]

    # ------------------------------------------------- speculative decode

    def _lookup_draft(self, ids_buf: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
        """Prompt-lookup proposal [b, k]: the continuation of the most recent
        earlier occurrence of each row's newest bigram (positions pos - 2,
        pos - 1), its start clipped so that k tokens fit. A row without a
        match proposes whatever sits there: verification re-derives every
        token from the model's own choice."""
        b, buf_len = ids_buf.shape
        rows = torch.arange(b, device=self.device)
        l0, l1 = ids_buf[rows, pos - 2], ids_buf[rows, pos - 1]
        j = torch.arange(buf_len - 1, device=self.device)
        match = ((ids_buf[:, :-1] == l0[:, None]) & (ids_buf[:, 1:] == l1[:, None])
                 & (j[None, :] < (pos - 2)[:, None]))
        j_star = torch.where(match, j[None, :], -1).max(dim=1).values
        start = (j_star + 2).clamp(0, buf_len - k)
        return torch.gather(ids_buf, 1, start[:, None] + torch.arange(k, device=self.device))

    def _propose_greedy(self, logits: torch.Tensor, spec_seen: torch.Tensor,
                        penalty) -> torch.Tensor:
        """A draft model's proposal: the target's greedy choice (repetition
        penalty over the speculative ``spec_seen``, which takes the token
        in place), so a draft equal to the target is always accepted."""
        d = torch.argmax(apply_repetition_penalty(logits, spec_seen, penalty), dim=-1)
        spec_seen.scatter_(1, d[:, None], True)  # x[rows, d] = True would sync the host
        return d

    def _model_draft(self, ids_buf, pos, dcache, seen, gen: GenerationConfig) -> torch.Tensor:
        """Draft-model proposal [b, K]: a (K+1)-wide window of accepted tokens
        ending at position pos - 1 is re-ingested into the draft cache
        (overwriting rejected drafts' K/V), its last logits give d_0, then
        K - 1 one-token extensions."""
        K = gen.speculative_lookup
        b = ids_buf.shape[0]
        rows = torch.arange(b, device=self.device)
        dmc, dparams, dtype = self._draft_config, self._draft_params, self.compute_dtype
        start = (pos - (K + 1)).clamp(min=0)
        win = torch.gather(ids_buf, 1, start[:, None] + torch.arange(K + 1, device=self.device))
        dh, _ = forward(dparams, win, dmc, cache=dcache, cache_pos=start, compute_dtype=dtype,
                        output_hidden=True)
        cur_h = dh[rows, pos - 1 - start]
        spec_seen = seen.clone()
        penalty = gen.repetition_penalty
        dbuf = torch.zeros(b, K, dtype=torch.long, device=self.device)
        dbuf[:, 0] = self._propose_greedy(unembed(dparams, cur_h, dmc, compute_dtype=dtype),
                                          spec_seen, penalty)
        for i in range(1, K):
            dh, _ = forward(dparams, dbuf[:, i - 1: i], dmc, cache=dcache, cache_pos=pos + i - 1,
                            compute_dtype=dtype, output_hidden=True)
            dbuf[:, i] = self._propose_greedy(unembed(dparams, dh[:, -1], dmc, compute_dtype=dtype),
                                              spec_seen, penalty)
        return dbuf

    def _generate_spec(self, prompts: List[List[int]], gen: GenerationConfig,
                       rng: torch.Generator, live_rows: Optional[int]) -> List[List[int]]:
        """The speculative decoder (the JAX ``Generator._build_spec``). Each
        step feeds every row's ``[cur, d_1..d_K]`` through one forward at the
        row's own position, then verifies the K+1 positions in order with an
        evolving seen set: greedy rows accept the drafts that equal the
        model's greedy choice (the output is plain greedy decode), sampled
        rows by rejection sampling (``rejection_sample_step``, the output
        distribution is plain sampling's). Position i's token is always
        emitted; position i+1 is taken only while the drafts before it were
        accepted. Rows desynchronize freely; the host reads "every row
        done" once per step. Rejected drafts' K/V sit above the row's new
        position until the next step overwrites them."""
        K, max_new = gen.speculative_lookup, gen.max_new_tokens
        b = len(prompts)
        rows = torch.arange(b, device=self.device)
        first, cache, seen, lens, ids = self._prompt_prefill(prompts, max_new + K + 1, gen, rng)
        pb = ids.shape[1]
        buf_len = pb + max_new + K + 1
        dcache = None
        if self.has_draft:
            # the draft sees the whole prompt; the re-ingest window keeps it
            # in step with the accepted tokens
            dcache = init_cache(self._draft_config, b, buf_len, dtype=self.compute_dtype,
                                device=self.device)
            forward(self._draft_params, ids, self._draft_config, cache=dcache, cache_pos=0,
                    compute_dtype=self.compute_dtype, output_hidden=True)
        valid = torch.arange(pb, device=self.device)[None, :] < lens[:, None]
        # each row's tokens, prompt and generated, at their positions
        ids_buf = torch.zeros(b, buf_len, dtype=torch.long, device=self.device)
        ids_buf[:, :pb] = torch.where(valid, ids, 0)
        ids_buf[rows, lens] = first
        done = torch.isin(first, self._eos)
        n_gen = torch.ones(b, dtype=torch.long, device=self.device)
        row_steps = torch.zeros(b, dtype=torch.long, device=self.device)
        n_steps = 1  # the prefill
        while bool(((n_gen < max_new) & ~done).any()):
            pos = lens + n_gen  # each row's next position
            alive = (n_gen < max_new) & ~done
            if dcache is not None:
                draft = self._model_draft(ids_buf, pos, dcache, seen, gen)
            else:
                draft = self._lookup_draft(ids_buf, pos, K)
            inputs = torch.cat([ids_buf[rows, pos - 1][:, None], draft], dim=1)
            hidden, _ = forward(self.params, inputs, self.config, cache=cache, cache_pos=pos - 1,
                                compute_dtype=self.compute_dtype, output_hidden=True)
            logits_all = unembed(self.params, hidden, self.config, compute_dtype=self.compute_dtype)
            n_acc = torch.zeros(b, dtype=torch.long, device=self.device)
            active = alive
            for i in range(K + 1):
                d = draft[:, min(i, K - 1)]
                if gen.do_sample:
                    tok, keep_going = rejection_sample_step(logits_all[:, i], seen, d, gen,
                                                            bonus=i >= K, generator=rng)
                else:
                    tok = sample_token(logits_all[:, i], seen, gen)
                    # draft i validates token i+1; the bonus position has none
                    keep_going = (d == tok) | (i >= K)
                take = active & ~done & (n_gen + i < max_new)
                seen[rows, tok] |= take
                ids_buf[rows, pos + i] = torch.where(take, tok, ids_buf[rows, pos + i])
                n_acc += take
                done |= take & torch.isin(tok, self._eos)
                active = active & keep_going
            n_gen += n_acc
            n_steps += 1
            row_steps += alive
        out = torch.gather(ids_buf, 1, lens[:, None] + torch.arange(max_new, device=self.device))
        out, n_gen, row_steps = out.cpu().tolist(), n_gen.cpu().numpy(), row_steps.cpu().numpy()
        # telemetry over the live rows: each step a row was still generating
        # in drafted K, and every token past the prefill's and each step's
        # own is an accepted draft
        nl = b if live_rows is None else min(live_rows, b)
        self.last_spec_steps = n_steps
        self.last_row_draft_proposed = row_steps[:nl] * K
        self.last_row_draft_accepted = np.maximum(n_gen[:nl] - 1 - row_steps[:nl], 0)
        self.last_acceptance_rate = (int(self.last_row_draft_accepted.sum())
                                     / max(int(self.last_row_draft_proposed.sum()), 1))
        # positions past a row's count hold rejected-draft leftovers
        return [self._trim_at_eos(row[: int(n)]) for row, n in zip(out, n_gen)]

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
        ``max_new_tokens`` and the host trims it. The tokens are the plain
        decode's, greedy and sampled: like the JAX stream it ignores
        ``gen.speculative_lookup``."""
        gen = gen or GenerationConfig()
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("generate_stream needs a non-empty prompt")
        if chunk < 1:
            raise ValueError(f"stream chunk must be >= 1, got {chunk}")
        rng = torch.Generator(device=self.device).manual_seed(int(seed))
        last, cache, seen, lens, _ = self._prompt_prefill([prompt], gen.max_new_tokens + chunk,
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
            "adapter_idx": np.zeros(slots, np.int64),
            "params": None,
            # the per-slot knobs of ``gen`` on the device, for the spec tick
            **self._knob_tensors([GenerationConfig(do_sample=False)] * slots),
        }

    def _knob_tensors(self, gens: Sequence[GenerationConfig]) -> Dict[str, torch.Tensor]:
        vocab = self.config.vocab_size

        def col(values, dtype):
            return self._tensor(np.array(values, dtype))

        return {
            "temperature": col([g.temperature for g in gens], np.float32),
            "top_p": col([g.top_p for g in gens], np.float32),
            "top_k": col([min(g.top_k or vocab, vocab) for g in gens], np.int64),
            "repetition_penalty": col([g.repetition_penalty for g in gens], np.float32),
            "do_sample": col([g.do_sample for g in gens], np.bool_),
        }

    def init_slot_state(self, slots: int, buf_len: int):
        """Fresh (cache, state) for a ``slots``-wide persistent decode over a
        dense ``[slots, buf_len]`` cache."""
        cache = init_cache(self.config, slots, buf_len, dtype=self.compute_dtype,
                           device=self.device)
        return cache, self._fresh_slot_state(slots)

    def _view(self, state: dict) -> Dict[str, torch.Tensor]:
        """The parameters a slot forward runs: the engine's pooled adapter
        view when it has one, else the base weights."""
        return state.get("params") or self.params

    def _row_adapters(self, state: dict, live: np.ndarray) -> Optional[torch.Tensor]:
        """Each row's adapter slot for one step ([S] on the device, dead
        rows on slot 0), or None when every live row is on the base model,
        so that a base-only step runs no pooled delta."""
        idx = np.where(live, state["adapter_idx"], 0)
        return self._h2d(idx) if idx.any() else None

    def _one_adapter(self, adapter_idx: int) -> Optional[torch.Tensor]:
        """A batch-1 prefill's adapter slot on the device (None: slot 0)."""
        return self._h2d(np.array([adapter_idx], np.int64)) if adapter_idx else None

    def _first_token(self, logits: torch.Tensor, seen_row: torch.Tensor, state: dict,
                     slot: int, prompt_len: int, gen: GenerationConfig, seed: int,
                     adapter_idx: int = 0) -> int:
        """Sample a prompt's first token from its last position's logits
        [1, vocab] and hand the slot to the request: its last token,
        position, seen set, config, generator seeded by ``seed`` and adapter
        slot."""
        rng = torch.Generator(device=self.device).manual_seed(int(seed))
        first = int(sample_token(logits, seen_row, gen, generator=rng)[0])
        seen_row[0, first] = True
        state["last"][slot] = first
        state["pos"][slot] = prompt_len
        state["seen"][slot] = seen_row[0]
        state["gen"][slot] = gen
        state["rng"][slot] = rng
        state["adapter_idx"][slot] = adapter_idx
        for name, value in self._knob_tensors([gen]).items():
            state[name][slot] = value[0]
        return first

    def slot_prefill(self, cache, state, prompt_ids: np.ndarray, prompt_len: int, slot: int,
                     gen: GenerationConfig, seed: int, adapter_idx: int = 0) -> int:
        """Prefill one prompt, right-padded to its bucket (``prompt_ids``
        [1, bucket]), in a private batch-1 cache; sample its first token from
        position ``prompt_len - 1`` as ``_prompt_prefill`` does (the pad keys
        sit above every real query, so the token does not depend on the
        bucket); copy the K/V into row ``slot`` of ``cache`` and set the
        slot's state. ``adapter_idx``: the request's adapter slot in the
        state's pooled view. Returns the first token."""
        ids = self._tensor(prompt_ids).long()
        params = self._view(state)
        small = init_cache(self.config, 1, ids.shape[1], dtype=self.compute_dtype,
                           device=self.device)
        hidden, _ = forward(params, ids, self.config, cache=small, cache_pos=0,
                            compute_dtype=self.compute_dtype, output_hidden=True,
                            adapter_idx=self._one_adapter(adapter_idx))
        logits = unembed(params, hidden[:, prompt_len - 1], self.config,
                         compute_dtype=self.compute_dtype)
        seen_row = torch.zeros(1, self.config.vocab_size, dtype=torch.bool, device=self.device)
        seen_row[0, ids[0, :prompt_len]] = True
        first = self._first_token(logits, seen_row, state, slot, prompt_len, gen, seed,
                                  adapter_idx)
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
        pen = state["repetition_penalty"][:, None]
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
        params = self._view(state)
        hidden, _ = forward(params, state["last"][:, None], self.config, cache=cache,
                            cache_pos=pos, compute_dtype=self.compute_dtype, output_hidden=True,
                            adapter_idx=self._row_adapters(state, live))
        logits = unembed(params, hidden[:, -1], self.config, compute_dtype=self.compute_dtype)
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

    def _h2d(self, array) -> torch.Tensor:
        """A host array on the device without waiting for the device: on
        the card through pinned memory and an asynchronous copy."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def paged_prefill_chunk(self, pool, state, table: np.ndarray, chunk_ids: np.ndarray,
                            chunk_start: int, adapter_idx: int = 0) -> None:
        """Ingest one prefill chunk [1, C] of one prompt through its block
        table [1, nb], starting at logical position ``chunk_start``, with
        adapter slot ``adapter_idx`` in the state's pooled view."""
        forward(
            self._view(state), self._tensor(chunk_ids).long(), self.config, cache=pool,
            cache_pos=int(chunk_start), block_tables=self._tensor(table),
            compute_dtype=self.compute_dtype, output_hidden=True,
            adapter_idx=self._one_adapter(adapter_idx),
        )

    def paged_prefill_final(self, pool, state, table: np.ndarray, chunk_ids: np.ndarray,
                            chunk_start: int, prompt_len: int, seen_row: np.ndarray,
                            slot: int, gen: GenerationConfig, seed: int,
                            adapter_idx: int = 0) -> int:
        """Ingest a prompt's last chunk (padded to its bucket), sample the
        first token from the last prompt position, and set the slot's state.
        ``seen_row`` [1, vocab] covers the whole prompt; ``adapter_idx`` is
        the request's adapter slot in the state's pooled view."""
        params = self._view(state)
        hidden, _ = forward(
            params, self._tensor(chunk_ids).long(), self.config, cache=pool,
            cache_pos=int(chunk_start), block_tables=self._tensor(table),
            compute_dtype=self.compute_dtype, output_hidden=True,
            adapter_idx=self._one_adapter(adapter_idx),
        )
        last_h = hidden[:, prompt_len - 1 - chunk_start]
        logits = unembed(params, last_h, self.config, compute_dtype=self.compute_dtype)
        return self._first_token(logits, self._tensor(seen_row), state, slot, prompt_len, gen,
                                 seed, adapter_idx)

    def paged_step(self, pool, state, live: np.ndarray, tables: np.ndarray) -> np.ndarray:
        """One decode step for every slot: feed each slot's last token at
        its position, sample each live slot's next token with its own config
        and generator. Dead rows run too (their all-null tables send their
        writes to the null block) and keep their state. Returns the tokens
        [slots] on the host."""
        pos = state["pos"]
        params = self._view(state)
        hidden, _ = forward(
            params, state["last"][:, None], self.config, cache=pool, cache_pos=pos,
            block_tables=self._tensor(tables), compute_dtype=self.compute_dtype,
            output_hidden=True, adapter_idx=self._row_adapters(state, live),
        )
        logits = unembed(params, hidden[:, -1], self.config, compute_dtype=self.compute_dtype)
        return self._advance_slots(logits, state, live, pos + 1).cpu().numpy()

    # ------------------------------------------------------- host KV tier
    #
    # A block's entry in the host tier (``infer/paged.HostBlockTier``) is one
    # host byte buffer holding every pool leaf's row of that block back to
    # back, in the JAX package's flatten order (``pool_leaves``); the entry's
    # arrays are typed views into it. One device gather, one copy per block
    # each way, and no compile buckets: nothing here compiles, so no pad rows
    # are ever written and the null block keeps its zero codes and scales.

    def paged_block_gather(self, pool, block_ids: Sequence[int]) -> List[List[torch.Tensor]]:
        """Copy the rows of ``block_ids`` out of ``pool`` into host memory:
        one list of per-leaf arrays per block (``pool_leaves`` order, each of
        its leaf's shape without the block axis). On the card the copies
        land in pinned memory without blocking, and the call returns once
        they have completed, so an entry is whole when the tier publishes
        it. The gather is enqueued on the current stream, before any later
        write to those rows."""
        leaves = pool_leaves(pool)
        n = len(block_ids)
        ids = self._h2d(np.asarray(block_ids, np.int64))
        rows = [leaf.index_select(0, ids).view(torch.uint8).reshape(n, -1) for leaf in leaves]
        packed = torch.cat(rows, dim=1)
        cuda = self.device.type == "cuda"
        host = [torch.empty(packed.shape[1], dtype=torch.uint8, pin_memory=cuda) for _ in range(n)]
        for i, buf in enumerate(host):
            buf.copy_(packed[i], non_blocking=cuda)
        if cuda:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return [_leaf_views(buf, leaves) for buf in host]

    def paged_block_scatter(self, pool, block_ids: Sequence[int],
                            entries: Sequence[Sequence[torch.Tensor]]) -> None:
        """Write host-tier ``entries`` (as ``paged_block_gather`` returns
        them) into rows ``block_ids`` of ``pool``, enqueued on the current
        stream before any later read of those rows. RuntimeError when an
        entry's layout is not this pool's."""
        leaves = pool_leaves(pool)
        for entry in entries:
            if len(entry) != len(leaves) or any(
                    a.shape != leaf.shape[1:] or a.dtype != leaf.dtype
                    for a, leaf in zip(entry, leaves)):
                raise RuntimeError("host-tier entry layout does not match this pool")
        n = len(block_ids)
        ids = self._h2d(np.asarray(block_ids, np.int64))
        cuda = self.device.type == "cuda"
        width = sum(leaf[0].nbytes for leaf in leaves)
        staged = torch.empty((n, width), dtype=torch.uint8, device=self.device)
        for i, entry in enumerate(entries):
            staged[i].copy_(_entry_bytes(entry, width), non_blocking=cuda)
        off = 0
        for leaf in leaves:
            nb = leaf[0].nbytes
            rows = staged[:, off: off + nb].view(leaf.dtype).view(n, *leaf.shape[1:])
            leaf.index_copy_(0, ids, rows)
            off += nb

    # ----------------------------------------- speculative continuous decode
    #
    # The fused draft-verify tick of the continuous engines (``speculative_k
    # > 0``): each slot's ``[last, d_1..d_K]`` goes through one forward at
    # the slot's own position, and a (K+1)-position verify accepts a prefix
    # of each slot's drafts. A slot with ``n_draft == 0`` reduces to the
    # plain step: position 0 is its bonus token. Each live sampled slot
    # draws a fixed K+1 uniforms and K+1 noise rows per tick from its own
    # generator, so its stream depends only on (request, seed, engine K);
    # greedy slots draw nothing. The tick reads ``toks [S, K+1]`` and
    # ``n_emit [S]`` back in one transfer; the host truncates at EOS and
    # budget. Rejected drafts' K/V sit above the slot's new position until
    # the next tick overwrites them (dense), or in the slot's own blocks
    # (paged, whose engine reserves K+1 positions of headroom).

    def _spec_noise(self, state: dict, live: np.ndarray, k1: int):
        """(u [S, k1], gumbel [S, k1, vocab]) for one spec tick, drawn by each
        live sampled slot from its own generator; None when no live slot
        samples."""
        sampled = [s for s in np.flatnonzero(live) if state["gen"][s].do_sample]
        if not sampled:
            return None
        slots, vocab = len(state["gen"]), self.config.vocab_size
        u = torch.zeros(slots, k1, dtype=torch.float32, device=self.device)
        gumbel = torch.zeros(slots, k1, vocab, dtype=torch.float32, device=self.device)
        for s in sampled:
            u[s] = uniform_noise((k1,), state["rng"][s], self.device)
            gumbel[s] = gumbel_noise((k1, vocab), state["rng"][s], self.device)
        return u, gumbel

    def _spec_verify(self, state: dict, live: np.ndarray, drafts: torch.Tensor,
                     n_draft: torch.Tensor, logits_all: torch.Tensor):
        """The verify shared by both fused steps (the JAX
        ``_build_spec_verify``): logits [S, K+1, vocab] of every slot's K+1
        positions -> (emitted run ``toks [S, K+1]``, -1 past it; ``n_emit
        [S]``; live mask on the device). Takes the tokens into ``seen`` and
        ``last``. Position i's token is emitted while the slot is live and
        no EOS came before it in this tick; position i+1 only if position i
        accepted its draft. A tick without a live sampled slot skips the
        sort (``greedy_verify``)."""
        slots, k1 = logits_all.shape[:2]
        rows = torch.arange(slots, device=self.device)
        noise = self._spec_noise(state, live, k1)
        live_t = self._h2d(live)
        seen, last = state["seen"], state["last"]
        toks = torch.full((slots, k1), -1, dtype=torch.long, device=self.device)
        n_emit = torch.zeros(slots, dtype=torch.long, device=self.device)
        active = live_t
        done = torch.zeros(slots, dtype=torch.bool, device=self.device)
        for i in range(k1):
            d = drafts[:, min(i, k1 - 2)]
            bonus = n_draft <= i
            if noise is None:
                tok, accepted, _ = greedy_verify(logits_all[:, i], seen, d,
                                                 state["repetition_penalty"], bonus)
            else:
                tok, accepted = rejection_sample_step_traced(
                    logits_all[:, i], seen, d, temperature=state["temperature"],
                    top_p=state["top_p"], top_k=state["top_k"],
                    repetition_penalty=state["repetition_penalty"], do_sample=state["do_sample"],
                    bonus=bonus, u=noise[0][:, i], gumbel=noise[1][:, i])
            take = active & ~done
            seen[rows, tok] |= take
            toks[:, i] = torch.where(take, tok, -1)
            last = torch.where(take, tok, last)
            n_emit += take
            done |= take & torch.isin(tok, self._eos)
            # position i+1's draft counts only if position i accepted its own
            active = active & accepted & (n_draft > i)
        state["last"] = last
        return toks, n_emit, live_t

    def _spec_inputs(self, state: dict, drafts, n_draft: np.ndarray):
        """(drafts [S, K] and n_draft [S] on the device, the forward's
        input ids ``[last, d_1..d_K]``). ``drafts`` is a host array (prompt
        lookup) or already on the device (``draft_slot_step``)."""
        drafts = drafts if torch.is_tensor(drafts) else self._h2d(drafts)
        drafts = drafts.long()
        return drafts, self._h2d(n_draft), torch.cat([state["last"][:, None], drafts], dim=1)

    @staticmethod
    def _spec_readback(toks: torch.Tensor, n_emit: torch.Tensor):
        """The tick's one device-to-host transfer."""
        out = torch.cat([toks, n_emit[:, None]], dim=1).cpu().numpy()
        return out[:, :-1], out[:, -1]

    def spec_slot_step(self, cache, state, live: np.ndarray, drafts, n_draft: np.ndarray):
        """One fused draft-verify tick over the dense cache: the forward
        writes positions pos..pos+K of each row (writes past the buffer are
        dropped); live slots advance to ``min(pos + n_emit, buf_len - 1)``.
        Returns ``(toks [S, K+1], n_emit [S])`` on the host."""
        drafts, n_draft_t, inputs = self._spec_inputs(state, drafts, n_draft)
        pos = state["pos"]
        params = self._view(state)
        hidden, _ = forward(params, inputs, self.config, cache=cache, cache_pos=pos,
                            compute_dtype=self.compute_dtype, output_hidden=True,
                            adapter_idx=self._row_adapters(state, live))
        logits_all = unembed(params, hidden, self.config, compute_dtype=self.compute_dtype)
        toks, n_emit, live_t = self._spec_verify(state, live, drafts, n_draft_t, logits_all)
        buf_len = cache["layers"]["0"]["k"].shape[1]
        state["pos"] = torch.where(live_t, (pos + n_emit).clamp(max=buf_len - 1), pos)
        return self._spec_readback(toks, n_emit)

    def spec_paged_step(self, pool, state, live: np.ndarray, tables: np.ndarray, drafts,
                        n_draft: np.ndarray):
        """One fused draft-verify tick over the block pool: verify writes go
        through each slot's table like decode writes. No clamp: the engine's
        headroom keeps a live slot's positions in its own blocks, and dead
        rows' all-null tables send theirs to the null block. Returns
        ``(toks [S, K+1], n_emit [S])`` on the host."""
        drafts, n_draft_t, inputs = self._spec_inputs(state, drafts, n_draft)
        pos = state["pos"]
        params = self._view(state)
        hidden, _ = forward(params, inputs, self.config, cache=pool, cache_pos=pos,
                            block_tables=self._h2d(tables), compute_dtype=self.compute_dtype,
                            output_hidden=True, adapter_idx=self._row_adapters(state, live))
        logits_all = unembed(params, hidden, self.config, compute_dtype=self.compute_dtype)
        toks, n_emit, live_t = self._spec_verify(state, live, drafts, n_draft_t, logits_all)
        state["pos"] = torch.where(live_t, pos + n_emit, pos)
        return self._spec_readback(toks, n_emit)

    # The draft model keeps a dense per-slot cache, even under the paged
    # engine. Each tick re-ingests the (K+1)-wide window of accepted tokens
    # (at most K+1 advance per tick, so the window covers what changed) and
    # rolls K greedy proposals under the target's repetition penalty.

    def init_draft_slot_cache(self, slots: int, buf_len: int) -> dict:
        """A fresh dense ``[slots, buf_len]`` cache for the draft model."""
        if self._draft_config is None:
            raise ValueError("no draft model attached")
        return init_cache(self._draft_config, slots, buf_len, dtype=self.compute_dtype,
                          device=self.device)

    def draft_slot_prefill(self, dcache, prompt_ids: np.ndarray, slot: int) -> None:
        """Ingest a right-padded prompt [1, bucket] into the draft model's
        row ``slot``."""
        ids = self._tensor(prompt_ids).long()
        small = init_cache(self._draft_config, 1, ids.shape[1], dtype=self.compute_dtype,
                           device=self.device)
        forward(self._draft_params, ids, self._draft_config, cache=small, cache_pos=0,
                compute_dtype=self.compute_dtype, output_hidden=True)
        insert_cache_row(dcache, small, slot)

    def draft_slot_step(self, dcache, state, window: np.ndarray, start: np.ndarray) -> torch.Tensor:
        """K greedy proposals per slot, ``[S, K]`` on the device. ``window
        [S, K+1]`` holds each slot's tokens at positions start..start+K
        (``start = max(pos - K, 0)``, so ``last`` sits at index pos - start);
        they are written at their positions, then K - 1 one-token forwards
        extend at pos+1..pos+K-1. Window cells past a short context write
        garbage above pos, which the extension overwrites before a draft
        query passes them. Dead rows (window 0, start 0) propose garbage
        that verify ignores."""
        K = window.shape[1] - 1
        dmc, dparams, dtype = self._draft_config, self._draft_params, self.compute_dtype
        start = self._h2d(start).long()
        pos = state["pos"]
        rows = torch.arange(window.shape[0], device=self.device)
        dh, _ = forward(dparams, self._h2d(window).long(), dmc, cache=dcache, cache_pos=start,
                        compute_dtype=dtype, output_hidden=True)
        cur_h = dh[rows, (pos - start).clamp(0, K)]  # a dead row's stale pos: clamped
        spec_seen = state["seen"].clone()
        penalty = state["repetition_penalty"][:, None]
        dbuf = torch.zeros(window.shape[0], K, dtype=torch.long, device=self.device)
        dbuf[:, 0] = self._propose_greedy(unembed(dparams, cur_h, dmc, compute_dtype=dtype),
                                          spec_seen, penalty)
        for i in range(1, K):
            dh, _ = forward(dparams, dbuf[:, i - 1: i], dmc, cache=dcache, cache_pos=pos + i,
                            compute_dtype=dtype, output_hidden=True)
            dbuf[:, i] = self._propose_greedy(unembed(dparams, dh[:, -1], dmc, compute_dtype=dtype),
                                              spec_seen, penalty)
        return dbuf

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
