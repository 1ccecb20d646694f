"""Analytic FLOP and byte counts: the train step's matmul FLOPs by phase
(``layer_matmul_flops_per_token``, ``train_step_flop_split``, copies of the
JAX ``observe/flops.py``), and the work of one serving decode dispatch
(``decode_tick_cost``, summed over dispatches by ``DecodeWork``), which
stands in for the cost analysis that XLA gives the JAX engines.

Conventions of the train-step split (the standard 2 x params accounting):

- a ``[in, out]`` matmul costs ``2*in*out`` FLOPs per token, forward;
- backward costs 2x forward (the dx and dW products);
- remat adds one extra forward per backward for the rematerialized region;
- attention scores and values cost ``4*seq*heads*head_dim`` per token
  (QK^T + AV, not halved for causality, so the model is an upper bound);
- norms, RoPE, softmax and elementwise work are left out: this is a matmul
  FLOP model.

``decode_tick_cost`` counts the useful work of the live rows from host-side
shapes only; ``DecodeWork`` sums those shapes over many dispatches and
``decode_work_cost`` gives the same count for the sum. A dead row, a padded
position, a bucket rounded up or an f32 upcast of a dense buffer add time,
not work, so the MFU and HBM-bandwidth gauges built on it read the same
work whatever kernel does it. The JAX gauges count the compiled program's
whole shapes instead, so the two packages' gauges differ by design.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig

__all__ = ["DecodeWork", "decode_tick_cost", "decode_work_cost", "layer_matmul_flops_per_token",
           "train_step_flop_split"]


def layer_matmul_flops_per_token(mc: ModelConfig, seq_len: int) -> float:
    """Forward matmul FLOPs per token for ONE transformer layer: the seven
    projections (q/k/v/o, gate/up/down; MoE counts the router plus the
    per-token active experts) plus the attention score/value products at
    ``seq_len``."""
    h = mc.hidden_size
    d = mc.head_dim or h // mc.num_heads
    q_dim = mc.num_heads * d
    kv_dim = mc.num_kv_heads * d
    attn_proj = h * q_dim + 2 * h * kv_dim + q_dim * h  # q, k, v, o
    if mc.num_experts:
        mlp = h * mc.num_experts  # router gate
        mlp += mc.num_experts_per_tok * 3 * h * mc.intermediate_size
    else:
        mlp = 3 * h * mc.intermediate_size  # gate, up, down
    scores = 2 * seq_len * mc.num_heads * d  # QK^T + AV, per token
    return 2.0 * (attn_proj + mlp) + 2.0 * scores


def train_step_flop_split(mc: ModelConfig, seq_len: int, frozen_layers: int = 0,
                          remat: bool = True) -> Dict[str, object]:
    """Per-token matmul FLOPs of one train step, split into phases:

    - ``trunk``: layers ``[0, frozen_layers)``, forward only;
    - ``trainable``: the remaining layers, forward + 2x backward (+1 forward
      remat recompute when ``remat``);
    - ``loss``: the unembed projection ``[h, vocab]``, forward + 2x backward.

    Returns ``{"per_token": {phase: flops}, "fractions": {phase: share},
    "total_per_token": flops}``."""
    frozen_layers = max(0, min(int(frozen_layers), mc.num_layers))
    layer_fwd = layer_matmul_flops_per_token(mc, seq_len)
    bwd_mult = 3.0 + (1.0 if remat else 0.0)  # fwd + dx + dW (+ refwd)
    trunk = frozen_layers * layer_fwd
    trainable = (mc.num_layers - frozen_layers) * layer_fwd * bwd_mult
    loss = 3.0 * 2.0 * mc.hidden_size * mc.vocab_size
    total = trunk + trainable + loss
    return {
        "per_token": {"trunk": trunk, "trainable": trainable, "loss": loss},
        "fractions": {"trunk": trunk / total, "trainable": trainable / total,
                      "loss": loss / total},
        "total_per_token": total,
    }


class DecodeWork:
    """Running sums of the timed decode dispatches' live-row shapes, from
    which ``decode_work_cost`` gives their FLOPs and bytes: the per-row
    counts of ``decode_tick_cost`` are linear in them. ``sums`` is
    ``(ticks, sum q_r, sum q_r * P_r, sum P_r, sum ceil(P_r / block_len),
    sum adapters, seconds)``, one tuple replaced whole by each ``add``, so a
    reader on another thread sees whole ticks."""

    def __init__(self):
        self.sums: Tuple[int, int, int, int, int, int, float] = (0, 0, 0, 0, 0, 0, 0.0)

    def add(self, positions: Sequence[int], queries: Sequence[int], block_len: int = 0,
            seconds: float = 0.0, adapters: int = 0) -> None:
        """One dispatch: row ``r`` attends ``positions[r]`` positions with
        ``queries[r]`` query positions; ``block_len`` > 0 counts each row's
        KV blocks (an int8 pool's scales); ``seconds`` is the dispatch's
        time; ``adapters`` is the number of distinct LoRA adapters its live
        rows gathered (0 on a base-only dispatch)."""
        ticks, q, qp, p, blocks, n_adapters, s = self.sums
        for pr, qr in zip(positions, queries):
            q += qr
            qp += qr * pr
            p += pr
            if block_len:
                blocks += -(-pr // block_len)
        self.sums = (ticks + 1, q, qp, p, blocks, n_adapters + int(adapters), s + seconds)


def decode_work_cost(mc: ModelConfig, sums: Sequence, *, weight_bytes: int, kv_itemsize: int,
                     scale_itemsize: int = 0, adapter_bytes: int = 0) -> Tuple[float, float]:
    """``(flops, bytes)`` of the dispatches summed in ``DecodeWork.sums``:
    ``decode_tick_cost`` per dispatch, added up, plus ``adapter_bytes`` (one
    LoRA pool slot's factors) per adapter a dispatch gathered: each adapter
    read once, as the weights are. The LoRA FLOPs are left out (at r 16 they
    are 1-2% of the base projections')."""
    ticks, q, qp, p, blocks, adapters, _ = sums
    L, h, V = mc.num_layers, mc.hidden_size, mc.vocab_size
    hkv = mc.num_kv_heads
    kv_row = L * 2 * hkv * mc.resolved_head_dim * kv_itemsize  # one position's K and V
    layer0 = layer_matmul_flops_per_token(mc, 0)
    per_position = layer_matmul_flops_per_token(mc, 1) - layer0  # the score/value products
    flops = q * (L * layer0 + 2.0 * h * V) + qp * L * per_position
    nbytes = (ticks * weight_bytes + (p + q) * kv_row + q * V * 4
              + blocks * L * 2 * hkv * scale_itemsize + adapters * adapter_bytes)
    return float(flops), float(nbytes)


def decode_tick_cost(mc: ModelConfig, positions: Sequence[int], queries: Sequence[int], *,
                     weight_bytes: int, kv_itemsize: int, block_len: int = 0,
                     scale_itemsize: int = 0) -> Tuple[float, float]:
    """``(flops, bytes)`` of one decode dispatch over the live rows only.

    Row ``r`` attends ``positions[r]`` positions (its own length) and feeds
    ``queries[r]`` query positions: 1 on a plain tick, 1 + its drafts on a
    verify. With ``L`` layers, hidden ``h``, vocab ``V``, ``hkv`` KV heads of
    width ``d`` and a KV element of ``kv_itemsize`` bytes:

    - ``flops = sum_r q_r * (L * layer_matmul_flops_per_token(mc, P_r) +
      2 * h * V)``;
    - ``bytes`` = ``weight_bytes`` (the resident weights as stored, read
      once) + the KV read ``sum_r P_r * L * 2 * hkv * d * kv_itemsize`` +
      the KV written ``sum_r q_r * L * 2 * hkv * d * kv_itemsize`` + the f32
      logits ``sum_r q_r * V * 4``. An int8 pool (``block_len`` and
      ``scale_itemsize`` > 0) adds each row's per-block scales read,
      ``ceil(P_r / block_len) * L * 2 * hkv * scale_itemsize``.
    """
    work = DecodeWork()
    work.add(positions, queries, block_len if scale_itemsize else 0)
    return decode_work_cost(mc, work.sums, weight_bytes=weight_bytes, kv_itemsize=kv_itemsize,
                            scale_itemsize=scale_itemsize)
