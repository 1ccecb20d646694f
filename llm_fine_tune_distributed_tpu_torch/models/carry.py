"""Carry parameters over from the JAX package.

The JAX package keeps parameters as a nested dict whose paths mirror HF
module names; the port keeps the same leaves, flattened with dots. A caller
flattens the JAX tree to ``{"model.layers.0.self_attn.q_proj.kernel":
np.ndarray, ...}`` (``jax.device_get`` then a dict walk) and hands it here;
this module itself never imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig
from llm_fine_tune_distributed_tpu_torch.models.transformer import check_supported
from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import kmajor


def flatten_tree(tree: dict, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> {"a.b.c": leaf} (the port's parameter naming)."""
    out: Dict[str, object] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def params_from_jax(flat: Dict[str, np.ndarray], config: ModelConfig, device="cpu",
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """JAX parameters as numpy arrays, by flat name -> the port's parameters
    on ``device``. Layouts match leaf for leaf ([in, out] kernels), so this
    is a copy: kernel/weight/bias leaves cast to ``dtype``, the frozen
    trunk's ``kernel_int8`` codes stay int8, K-major in memory as
    ``parallel/freeze.quantize_trunk_int8`` makes them (the layout the w8a8
    kernel reads), their ``kernel_int8_scale`` stays f32, LoRA's
    ``lora_a`` / ``lora_b`` / ``lora_scale`` stay f32 (the JAX package keeps
    them f32 beside any kernel dtype), and the NF4 siblings keep their
    dtypes: ``kernel_nf4`` int32, ``kernel_absmax`` f32, ``kernel_absmax_q``
    int8, ``kernel_absmax_scale`` and ``kernel_absmax_offset`` f32. Any other
    leaf raises."""
    check_supported(config)
    keep = {"kernel_int8": np.int8, "kernel_int8_scale": np.float32, "lora_a": np.float32,
            "lora_b": np.float32, "lora_scale": np.float32, "kernel_nf4": np.int32,
            "kernel_absmax": np.float32, "kernel_absmax_q": np.int8,
            "kernel_absmax_scale": np.float32, "kernel_absmax_offset": np.float32}
    out = {}
    for name, arr in flat.items():
        leaf = name.rpartition(".")[2]
        if leaf in keep:
            t = torch.from_numpy(np.asarray(arr, dtype=keep[leaf]).copy()).to(device)
            out[name] = kmajor(t) if leaf == "kernel_int8" else t
            continue
        if leaf not in ("kernel", "weight", "bias"):
            raise NotImplementedError(
                f"{name}: only kernel/weight/bias, kernel_int8(_scale), the NF4 siblings and "
                "lora_* leaves are ported"
            )
        t = torch.from_numpy(np.asarray(arr, dtype=np.float32).copy())
        out[name] = t.to(device=device, dtype=dtype)
    return out
