"""LoRA adapters: init, merge, strip, validate, and the PEFT-layout adapter
directory (counterpart of the JAX ``parallel/lora.py``).

The reference's end product is a LoRA fine-tune: r 16, alpha 8, dropout
0.05, seven projection targets. In the port's flat parameter dict an
adapter lives beside its kernel as three leaves,

    model.layers.0.self_attn.q_proj.lora_a      [in, r]   (f32)
    model.layers.0.self_attn.q_proj.lora_b      [r, out]  (f32)
    model.layers.0.self_attn.q_proj.lora_scale  []        (alpha / r, f32)

and ``models/transformer._linear`` adds ``(x @ A) @ B * scale``. An
adapter directory is the HF PEFT layout: ``adapter_model.safetensors``
(``base_model.model.<module>.lora_A.weight [r, in]`` and
``lora_B.weight [out, r]``, torch layout) beside ``adapter_config.json``.
It is read and written with the port's own safetensors codec
(``models/hf_io``). Every error message is the JAX package's, word for word.

``add_lora_params`` attaches fresh adapters for training: A is
Kaiming-uniform (bound ``sqrt(3) * sqrt(1 / in)``, HF PEFT's init), B is
zero, so the adapted model starts equal to the base. The JAX package draws
each A from ``fold_in(rng, crc32(path))``; the port draws it from a
``torch.Generator`` seeded with ``crc32(module name)`` started from
``seed`` (a 32-bit seed: the CPU generator keeps only 32 bits), so
its init too is deterministic and independent of the order of the leaves
(the two draws differ: parity tests carry the JAX package's A across).
``lora_dropout`` is recorded but not applied, as in the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import zlib
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.models.hf_io import read_safetensors, write_safetensors

Params = Dict[str, torch.Tensor]

LORA_TARGET_MODULES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)


@dataclass
class LoraConfig:
    """The adapter hyperparameters ``save_lora_adapter`` records and
    ``peft_adapter_state`` falls back to, under the JAX ``TrainConfig``'s
    field names (the reference's recipe as defaults)."""

    lora_rank: int = 16
    lora_alpha: float = 8.0
    lora_dropout: float = 0.05
    lora_target_modules: Sequence[str] = LORA_TARGET_MODULES


def add_lora_params(params: Params, seed: int, *, rank: int = 16, alpha: float = 8.0,
                    target_modules: Sequence[str] = LORA_TARGET_MODULES,
                    dtype=torch.float32) -> Params:
    """A copy of ``params`` with ``lora_a [in, r]`` (Kaiming-uniform),
    ``lora_b [r, out]`` (zeros) and ``lora_scale`` (``alpha / rank``) after
    each target module's ``kernel``, on the kernel's device. ``seed`` and
    the module's name seed each A's generator."""
    out: Params = {}
    for name, t in params.items():
        out[name] = t
        module, _, leaf = name.rpartition(".")
        if leaf != "kernel" or module.rpartition(".")[2] not in target_modules:
            continue
        d_in, d_out = t.shape
        gen = torch.Generator(device=t.device).manual_seed(
            zlib.crc32(module.encode(), seed & 0xFFFFFFFF))
        bound = math.sqrt(3.0) * math.sqrt(1.0 / d_in)  # kaiming, a = sqrt(5)
        a = torch.rand((d_in, rank), generator=gen, device=t.device, dtype=torch.float32)
        out[module + ".lora_a"] = (a * (2 * bound) - bound).to(dtype)
        out[module + ".lora_b"] = torch.zeros((rank, d_out), dtype=dtype, device=t.device)
        out[module + ".lora_scale"] = torch.tensor(alpha / rank, dtype=dtype, device=t.device)
    return out


def add_lora_from_config(params: Params, seed: int, train) -> Params:
    """``add_lora_params`` with the rank, alpha and targets of a
    ``TrainConfig``."""
    return add_lora_params(params, seed, rank=train.lora_rank, alpha=train.lora_alpha,
                           target_modules=tuple(train.lora_target_modules))


def _modules(params: Params, leaf: str):
    """(module name, tensor) of every ``<module>.<leaf>`` in ``params``, in
    the dict's order."""
    suffix = "." + leaf
    return [(name[: -len(suffix)], t) for name, t in params.items() if name.endswith(suffix)]


def merge_lora(params: Params) -> Params:
    """Fold adapters into the base kernels (W' = W + scale * A @ B, in f32,
    cast back to the kernel's dtype) and drop the adapter leaves: the
    serving-time form. A module without a plain ``kernel`` keeps its
    adapter, as in the JAX package."""
    merged: Params = {}
    for module, a in _modules(params, "lora_a"):
        kernel = params.get(module + ".kernel")
        if kernel is not None:
            delta = (a @ params[module + ".lora_b"]) * params[module + ".lora_scale"]
            merged[module] = (kernel.float() + delta.float()).to(kernel.dtype)
    out: Params = {}
    for name, t in params.items():
        module, _, leaf = name.rpartition(".")
        if module in merged:
            if leaf.startswith("lora_"):
                continue
            if leaf == "kernel":
                t = merged[module]
        out[name] = t
    return out


def strip_lora(params: Params) -> Params:
    """Remove adapter leaves without merging (back to the pristine base)."""
    return {name: t for name, t in params.items()
            if not name.rpartition(".")[2].startswith("lora_")}


def lora_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """Adapters as a PEFT-style state dict: ``base_model.model.<module>.
    lora_A.weight [r, in]`` and ``lora_B.weight [out, r]`` (torch layout)."""
    flat: Dict[str, torch.Tensor] = {}
    for module, a in _modules(params, "lora_a"):
        base = f"base_model.model.{module}"
        flat[f"{base}.lora_A.weight"] = a.detach().to("cpu").T.contiguous()
        flat[f"{base}.lora_B.weight"] = params[module + ".lora_b"].detach().to("cpu").T.contiguous()
    return flat


def save_lora_adapter(params: Params, path: str, train=None) -> None:
    """Write ``adapter_model.safetensors`` + ``adapter_config.json`` (the HF
    PEFT directory layout). ``train`` gives the recorded hyperparameters
    (``LoraConfig`` or anything with its field names; default the
    reference's)."""
    train = train if train is not None else LoraConfig()
    os.makedirs(path, exist_ok=True)
    state = lora_state_dict(params)
    if not state:
        raise ValueError("params carry no LoRA adapters")
    write_safetensors(os.path.join(path, "adapter_model.safetensors"), state,
                      metadata={"format": "pt"})
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump(
            {
                "peft_type": "LORA",
                "r": train.lora_rank,
                "lora_alpha": train.lora_alpha,
                "lora_dropout": train.lora_dropout,
                "target_modules": list(train.lora_target_modules),
                "task_type": "CAUSAL_LM",
            },
            f,
            indent=2,
        )


def _kernel_module_names(params: Params) -> set:
    """Names of every linear module in the model (the last component of
    each module that holds a plain ``kernel``)."""
    names = {module.rpartition(".")[2] for module, _ in _modules(params, "kernel")}
    names.discard("")
    return names


def validate_adapter_config(acfg: dict, params: Params, path: str = "") -> None:
    """Validate an ``adapter_config.json`` against the model before any
    tensor is attached: ``r`` (positive int), ``lora_alpha`` (positive
    number), ``target_modules`` (non-empty, every name a linear module the
    model has). A ValueError names the offending field."""
    where = f" ({path})" if path else ""
    r = acfg.get("r")
    if not isinstance(r, int) or isinstance(r, bool) or r < 1:
        raise ValueError(
            f"adapter_config.json{where}: field 'r' must be a positive "
            f"integer, got {r!r}"
        )
    alpha = acfg.get("lora_alpha")
    if not isinstance(alpha, (int, float)) or isinstance(alpha, bool) or alpha <= 0:
        raise ValueError(
            f"adapter_config.json{where}: field 'lora_alpha' must be a "
            f"positive number, got {alpha!r}"
        )
    targets = acfg.get("target_modules")
    if not targets or not isinstance(targets, (list, tuple)):
        raise ValueError(
            f"adapter_config.json{where}: field 'target_modules' must be a "
            f"non-empty list of module names, got {targets!r}"
        )
    known = _kernel_module_names(params)
    unknown = sorted(t for t in targets if t not in known)
    if unknown:
        raise ValueError(
            f"adapter_config.json{where}: field 'target_modules' names "
            f"modules the model does not have: {unknown} (model linear "
            f"modules: {sorted(known)})"
        )


def peft_adapter_state(params: Params, path: str, train=None
                       ) -> Tuple[Dict[str, Tuple[torch.Tensor, torch.Tensor]], float, dict]:
    """Load and validate a PEFT adapter directory against ``params``.

    Returns ``(entries, scale, acfg)``: ``entries`` maps each adapted
    module's name (``model.layers.0.self_attn.q_proj``) to ``(A [in, r],
    B [r, out])`` f32 CPU tensors in the kernel layout; ``scale`` is
    ``alpha / r`` rounded to f32. The rank and the in/out sizes of every
    tensor are checked against the config and the model's kernels, with
    errors that name the field or the module."""
    state = read_safetensors(os.path.join(path, "adapter_model.safetensors"))
    cfg_path = os.path.join(path, "adapter_config.json")
    acfg = None
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            acfg = json.load(f)
        validate_adapter_config(acfg, params, path)
        rank = int(acfg["r"])
        scale = float(acfg["lora_alpha"]) / rank
    elif train is not None:
        rank = int(train.lora_rank)
        scale = float(train.lora_alpha) / rank
    else:
        raise ValueError(f"{path} has no adapter_config.json and no TrainConfig given")

    entries: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for module, kernel in _modules(params, "kernel"):
        base = f"base_model.model.{module}"
        a_name = f"{base}.lora_A.weight"
        if a_name not in state:
            continue
        a_t, b_t = state[a_name], state[f"{base}.lora_B.weight"]
        # torch layout: lora_A.weight [r, in], lora_B.weight [out, r]
        if a_t.shape[0] != rank or b_t.shape[-1] != rank:
            raise ValueError(
                f"adapter_config.json ({path}): field 'r' = {rank} does "
                f"not match the saved tensors for {module} "
                f"(lora_A {tuple(a_t.shape)}, lora_B {tuple(b_t.shape)})"
            )
        d_in, d_out = kernel.shape
        if a_t.shape[1] != d_in or b_t.shape[0] != d_out:
            raise ValueError(
                f"adapter ({path}) does not fit the model: {module} has "
                f"kernel [in={d_in}, out={d_out}] but the adapter was "
                f"trained for [in={a_t.shape[1]}, out={b_t.shape[0]}]"
            )
        entries[module] = (a_t.T.float().contiguous(), b_t.T.float().contiguous())
    if not entries:
        raise ValueError(
            f"adapter ({path}) matched no module of the model: its tensor "
            "names do not line up with any kernel path"
        )
    return entries, float(np.float32(scale)), acfg


def load_lora_adapter(params: Params, path: str, train=None) -> Params:
    """Attach the adapters of a PEFT directory to a copy of ``params``:
    ``lora_a`` / ``lora_b`` / ``lora_scale`` leaves (f32, on each kernel's
    device) after each adapted kernel. The scale comes from the directory's
    own ``adapter_config.json``; ``train`` is only the fallback for a bare
    directory."""
    entries, scale, _ = peft_adapter_state(params, path, train)
    out: Params = {}
    for name, t in params.items():
        out[name] = t
        module = name[: -len(".kernel")] if name.endswith(".kernel") else None
        if module in entries:
            a, b = entries[module]
            out[module + ".lora_a"] = a.to(t.device)
            out[module + ".lora_b"] = b.to(t.device)
            out[module + ".lora_scale"] = torch.tensor(scale, dtype=torch.float32, device=t.device)
    return out
