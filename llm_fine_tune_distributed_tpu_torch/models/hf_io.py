"""HF safetensors <-> flat parameter dict (counterpart of the JAX
``models/hf_io.py``).

The mapping is mechanical: HF ``Linear.weight [out, in]`` <-> ``kernel [in,
out]`` (transpose); embeddings, norms and biases copy through. The files are
read and written by the small safetensors codec below (an 8-byte
little-endian header length, a JSON header, then the raw tensor bytes), so
loading a model needs neither the ``safetensors`` nor the ``transformers``
package.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional, Tuple

import torch

from llm_fine_tune_distributed_tpu_torch.models.configs import ModelConfig

_KERNEL_LEAF = "kernel"
_MAX_SHARD_BYTES = 4 * 1024**3

_ST_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F64": torch.float64,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


# ---------------------------------------------------------------------------
# safetensors codec
# ---------------------------------------------------------------------------


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read one ``.safetensors`` file into CPU tensors. The data section is
    read once, straight into one uint8 buffer, and every tensor is a view of
    it (no per-tensor copy; the views keep the buffer alive after the file
    is closed). A tensor whose offset is not a multiple of its element size
    is copied out instead."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size - 8 - n
        data = torch.empty(size, dtype=torch.uint8)
        if size and f.readinto(memoryview(data.numpy())) != size:
            raise ValueError(f"{path}: truncated data section")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = data[start:end]
        if start % _itemsize(dtype):
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def write_safetensors(path, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write CPU-copyable tensors as one ``.safetensors`` file (``path``, or
    a binary file object open for writing). Each tensor's bytes go to the
    file straight from its host copy. The tensors are laid out by element
    size, largest first, so every offset is a multiple of its tensor's
    element size and ``read_safetensors`` can view each in place."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs = []
    offset = 0
    for name, t in sorted(tensors.items(), key=lambda kv: -kv[1].element_size()):
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {
            "dtype": _ST_NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + raw.size],
        }
        blobs.append(raw)
        offset += raw.size
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # keep the data section 8-byte aligned

    def emit(f) -> None:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            if raw.size:
                f.write(memoryview(raw))

    if hasattr(path, "write"):
        emit(path)
        return
    with open(path, "wb") as f:
        emit(f)


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Read one file, a sharded checkpoint (``model.safetensors.index.json``)
    or every ``*.safetensors`` file of a directory."""
    if os.path.isfile(path):
        return read_safetensors(path)
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        state: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            state.update(read_safetensors(os.path.join(path, shard)))
        return state
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return read_safetensors(single)
    shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    state = {}
    for shard in shards:
        state.update(read_safetensors(os.path.join(path, shard)))
    return state


# ---------------------------------------------------------------------------
# name mapping
# ---------------------------------------------------------------------------


def _needs_transpose(name: str) -> bool:
    return name.endswith(".weight") and any(
        part in name
        for part in ("q_proj", "k_proj", "v_proj", "o_proj",
                     "gate_proj", "up_proj", "down_proj", "lm_head")
    )


def pytree_to_hf_state_dict(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Flat params -> {hf_name: tensor in torch layout}."""
    state = {}
    for name, t in params.items():
        head, _, leaf = name.rpartition(".")
        if leaf == _KERNEL_LEAF:
            state[head + ".weight"] = t.T.contiguous()
        elif leaf in ("lora_a", "lora_b", "lora_scale"):
            continue  # adapters are exported separately in the JAX package
        else:
            state[name] = t.contiguous()
    return state


def _flat_leaf(name: str, t: torch.Tensor, dtype=None) -> Tuple[str, torch.Tensor]:
    """One HF tensor -> (flat name, leaf): cast to ``dtype``, a Linear weight
    transposed to ``kernel [in, out]``."""
    if ".experts." in name or "block_sparse_moe" in name:
        raise NotImplementedError(
            "MoE checkpoints are not ported "
            "(llm_fine_tune_distributed_tpu.models.hf_io.hf_state_dict_to_pytree has them)"
        )
    if dtype is not None:
        t = t.to(dtype)
    if _needs_transpose(name):
        return name[: -len(".weight")] + "." + _KERNEL_LEAF, t.T.contiguous()
    return name, t


def _tie_head(flat: Dict[str, torch.Tensor], config: ModelConfig) -> Dict[str, torch.Tensor]:
    """A tied config drops ``lm_head``; an untied one without it takes the
    transposed embedding, as HF stores tied models."""
    if config.tie_word_embeddings:
        flat.pop("lm_head." + _KERNEL_LEAF, None)
    elif "lm_head." + _KERNEL_LEAF not in flat:
        embed = flat.get("model.embed_tokens.weight")
        if embed is None:
            raise ValueError("checkpoint has neither lm_head nor embed_tokens")
        flat["lm_head." + _KERNEL_LEAF] = embed.T.contiguous()
    return flat


def hf_state_dict_to_pytree(state: Dict[str, torch.Tensor], config: ModelConfig,
                            dtype=None) -> Dict[str, torch.Tensor]:
    """{hf_name: tensor} -> flat params (transposing Linear weights). A tied
    config drops ``lm_head``; an untied one without ``lm_head`` takes the
    transposed embedding, as HF stores tied models."""
    return _tie_head(dict(_flat_leaf(name, t, dtype) for name, t in state.items()), config)


def load_hf_checkpoint(path: str, config: ModelConfig, dtype=None,
                       device="cpu") -> Dict[str, torch.Tensor]:
    """Load an HF checkpoint directory (or file) into flat params on
    ``device``; ``dtype=None`` keeps the stored dtype. Each tensor goes to
    ``device`` as stored and is cast and transposed there, one at a time (on
    a GPU, a device copy instead of a pass over the weights in host memory)."""
    state = load_safetensors_dir(path)
    flat = dict(_flat_leaf(name, state.pop(name).to(device), dtype) for name in list(state))
    return _tie_head(flat, config)


def save_hf_checkpoint(params: Dict[str, torch.Tensor], path: str, *,
                       metadata: Optional[Dict[str, str]] = None, save_dtype=None) -> None:
    """Write params as HF-layout safetensors under ``path``: one
    ``model.safetensors``, or 4 GB shards plus an index, as HF does."""
    os.makedirs(path, exist_ok=True)
    state = pytree_to_hf_state_dict(params)
    if save_dtype is not None:
        state = {k: v.to(save_dtype) for k, v in state.items()}
    meta = {"format": "pt", **(metadata or {})}
    total = sum(v.numel() * v.element_size() for v in state.values())
    if total <= _MAX_SHARD_BYTES:
        write_safetensors(os.path.join(path, "model.safetensors"), state, meta)
        return
    shards: list = [{}]
    sizes = [0]
    for name, t in state.items():
        nbytes = t.numel() * t.element_size()
        if sizes[-1] + nbytes > _MAX_SHARD_BYTES and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nbytes
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(path, fname), shard, meta)
        for name in shard:
            weight_map[name] = fname
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
