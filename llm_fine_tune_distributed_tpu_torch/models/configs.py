"""Model architecture config and presets.

Counterpart of ``llm_fine_tune_distributed_tpu/config.py``'s ``ModelConfig``
and ``models/configs.py``, copied so the port imports nothing of the JAX
package. Field names, defaults and the ``config.json`` mapping are the same,
so a model directory written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of a dense decoder-only transformer (Llama family,
    SmolLM3's NoPE-interleaved RoPE: ``no_rope_layers[i] == 0`` means layer
    *i* applies no rotary embedding)."""

    name: str = "unnamed"
    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_layers: int = 36
    num_heads: int = 16
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rope_theta: float = 2_000_000.0
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    attention_out_bias: bool = True
    qk_norm: bool = False
    hidden_act: str = "silu"
    sandwich_norms: bool = False
    zero_centered_norm: bool = False
    embed_scale: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    alternating_sliding_window: bool = False
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    mlp_bias: bool = False
    no_rope_layers: tuple = ()
    sliding_window: Optional[int] = None
    dtype: str = "bfloat16"
    num_experts: int = 0
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch_chunk: int = 1024

    def __post_init__(self):
        if self.num_experts and self.hidden_act != "silu":
            raise ValueError(
                f"MoE models support hidden_act='silu' only (got {self.hidden_act!r})"
            )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    def uses_rope(self, layer_idx: int) -> bool:
        if not self.no_rope_layers:
            return True
        return bool(self.no_rope_layers[layer_idx])

    def layer_sliding_window(self, layer_idx: int) -> Optional[int]:
        if self.sliding_window is None:
            return None
        if self.alternating_sliding_window and layer_idx % 2 != 0:
            return None
        return self.sliding_window

    @property
    def num_params(self) -> int:
        """Exact parameter count of the dense model (HF
        ``model.num_parameters()``)."""
        h, v, f, L = self.hidden_size, self.vocab_size, self.intermediate_size, self.num_layers
        d = self.resolved_head_dim
        per_layer = (
            h * self.num_heads * d + 2 * h * self.num_kv_heads * d  # q, k, v
            + self.num_heads * d * h + 3 * h * f + 2 * h           # o, MLP, norms
        )
        if self.attention_bias:
            per_layer += (self.num_heads + 2 * self.num_kv_heads) * d
            if self.attention_out_bias:
                per_layer += h
        if self.mlp_bias:
            per_layer += 2 * f + h
        total = v * h + L * per_layer + h
        return total if self.tie_word_embeddings else total + v * h

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _smollm3_no_rope(num_layers: int, interval: int = 4) -> tuple:
    """SmolLM3 NoPE pattern: every ``interval``-th layer (1-indexed) has no
    RoPE (HF ``SmolLM3Config``: ``no_rope_layers[i] = 0 if (i+1) % 4 == 0``)."""
    return tuple(0 if (i + 1) % interval == 0 else 1 for i in range(num_layers))


PRESETS = {
    # unit-test size, same structure as SmolLM3 (GQA + NoPE)
    "tiny": ModelConfig(
        name="tiny",
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=4,
        num_heads=4,
        num_kv_heads=2,
        rope_theta=10_000.0,
        max_position_embeddings=512,
        tie_word_embeddings=True,
        no_rope_layers=_smollm3_no_rope(4),
    ),
    "smollm3_3b": ModelConfig(
        name="smollm3_3b",
        vocab_size=128256,
        hidden_size=2048,
        intermediate_size=11008,
        num_layers=36,
        num_heads=16,
        num_kv_heads=4,
        rope_theta=5_000_000.0,  # HuggingFaceTB/SmolLM3-3B release value
        max_position_embeddings=65536,
        rms_norm_eps=1e-6,
        tie_word_embeddings=True,
        no_rope_layers=_smollm3_no_rope(36),
    ),
}


def get_preset(name: str) -> ModelConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown model preset {name!r}; available: {sorted(PRESETS)}")


def to_hf_dict(mc: ModelConfig) -> dict:
    """ModelConfig -> HF-style ``config.json`` dict with every architecture
    knob explicit, so ``from_hf_config`` round-trips exactly."""
    return {
        "model_type": mc.name,
        "vocab_size": mc.vocab_size,
        "hidden_size": mc.hidden_size,
        "intermediate_size": mc.intermediate_size,
        "num_hidden_layers": mc.num_layers,
        "num_attention_heads": mc.num_heads,
        "num_key_value_heads": mc.num_kv_heads,
        "head_dim": mc.head_dim,
        "rope_theta": mc.rope_theta,
        "max_position_embeddings": mc.max_position_embeddings,
        "rms_norm_eps": mc.rms_norm_eps,
        "tie_word_embeddings": mc.tie_word_embeddings,
        "attention_bias": mc.attention_bias,
        "attention_out_bias": mc.attention_out_bias,
        "qk_norm": mc.qk_norm,
        "hidden_act": mc.hidden_act,
        "hidden_activation": mc.hidden_act,
        "sandwich_norms": mc.sandwich_norms,
        "zero_centered_norm": mc.zero_centered_norm,
        "embed_scale": mc.embed_scale,
        "attn_logit_softcap": mc.attn_logit_softcap,
        "final_logit_softcap": mc.final_logit_softcap,
        "query_pre_attn_scalar": mc.query_pre_attn_scalar,
        "alternating_sliding_window": mc.alternating_sliding_window,
        "rope_scaling": (
            {
                "rope_type": mc.rope_scaling_type,
                "factor": mc.rope_scaling_factor,
                "low_freq_factor": mc.rope_low_freq_factor,
                "high_freq_factor": mc.rope_high_freq_factor,
                "original_max_position_embeddings": mc.rope_original_max_position,
            }
            if mc.rope_scaling_type
            else None
        ),
        "mlp_bias": mc.mlp_bias,
        "no_rope_layers": list(mc.no_rope_layers),
        "sliding_window": mc.sliding_window,
        "num_local_experts": mc.num_experts,
        "num_experts_per_tok": mc.num_experts_per_tok,
        "router_aux_loss_coef": mc.router_aux_coef,
    }


def load_model_config(path: str) -> ModelConfig:
    """Read ``path/config.json`` (HF layout) into a ModelConfig."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"no config.json under {path}")
    with open(cfg_path) as f:
        raw = json.load(f)
    return from_hf_config(SimpleNamespace(**raw))


def _parse_hidden_act(act) -> str:
    act = str(act)
    if act in ("silu", "swish"):
        return "silu"
    if act in ("gelu_tanh", "gelu_pytorch_tanh", "gelu_new"):
        return "gelu_tanh"
    if act == "gelu":
        return "gelu"
    raise ValueError(
        f"unsupported hidden_act {act!r}; supported: silu/swish, "
        "gelu (exact), gelu_pytorch_tanh (tanh-approx GeGLU)"
    )


def from_hf_config(hf_config) -> ModelConfig:
    """Build a ModelConfig from an HF-style config object (attribute access),
    with the same key precedence and model_type heuristics as the JAX
    package's ``models/configs.from_hf_config``."""
    g = lambda k, default=None: getattr(hf_config, k, default)  # noqa: E731
    mt = str(g("model_type") or "")
    validated = {"qwen2", "qwen3", "gemma", "gemma2"}
    framework_save = g("sandwich_norms") is not None and g("qk_norm") is not None
    if mt.startswith(("qwen", "gemma")) and mt not in validated and not framework_save:
        raise ValueError(
            f"unrecognized {mt!r} model_type: the qwen*/gemma* architecture "
            f"heuristics are validated only for {sorted(validated)}"
        )
    rs = g("rope_scaling") or {}
    if not isinstance(rs, dict):
        rs = dict(rs)
    rs_type = rs.get("rope_type", rs.get("type"))
    if rs_type in ("default", None):
        rs_type = None
    elif rs_type not in ("linear", "llama3"):
        raise ValueError(
            f"unsupported rope_scaling type {rs_type!r}; supported: "
            "'llama3' (Llama-3.1 smoothed NTK), 'linear', 'default'"
        )
    return ModelConfig(
        name=g("model_type", "hf_model"),
        vocab_size=g("vocab_size"),
        hidden_size=g("hidden_size"),
        intermediate_size=g("intermediate_size"),
        num_layers=g("num_hidden_layers"),
        num_heads=g("num_attention_heads"),
        num_kv_heads=g("num_key_value_heads") or g("num_attention_heads"),
        head_dim=g("head_dim"),
        rope_theta=g("rope_theta", 10_000.0),
        max_position_embeddings=g("max_position_embeddings", 4096),
        rms_norm_eps=g("rms_norm_eps", 1e-6),
        tie_word_embeddings=bool(g("tie_word_embeddings", False)),
        attention_bias=bool(g("attention_bias", False) or mt.startswith("qwen2")),
        attention_out_bias=bool(g("attention_out_bias", not mt.startswith("qwen2"))),
        qk_norm=bool(g("qk_norm", mt.startswith("qwen3"))),
        hidden_act=_parse_hidden_act(
            (g("hidden_activation") or "gelu_pytorch_tanh")
            if mt.startswith("gemma")
            else (g("hidden_act") or g("hidden_activation") or "silu")
        ),
        sandwich_norms=bool(g("sandwich_norms", mt.startswith("gemma2"))),
        zero_centered_norm=bool(g("zero_centered_norm", mt.startswith("gemma"))),
        embed_scale=bool(g("embed_scale", mt.startswith("gemma"))),
        attn_logit_softcap=g("attn_logit_softcap", None) or g("attn_logit_softcapping", None),
        final_logit_softcap=g("final_logit_softcap", None) or g("final_logit_softcapping", None),
        query_pre_attn_scalar=g("query_pre_attn_scalar"),
        alternating_sliding_window=bool(
            g("alternating_sliding_window", mt.startswith("gemma2"))
        ),
        rope_scaling_type=rs_type,
        rope_scaling_factor=float(rs.get("factor", 1.0)),
        rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
        rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
        rope_original_max_position=int(rs.get("original_max_position_embeddings", 8192)),
        mlp_bias=bool(g("mlp_bias", False)),
        no_rope_layers=tuple(g("no_rope_layers") or ()),
        sliding_window=g("sliding_window") if g("use_sliding_window", True) else None,
        num_experts=g("num_local_experts", 0) or 0,
        num_experts_per_tok=g("num_experts_per_tok", 2) or 2,
        router_aux_coef=(
            0.01 if g("router_aux_loss_coef") is None else g("router_aux_loss_coef")
        ),
    )
