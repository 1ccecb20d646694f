"""w8a8 int8 matmul for the frozen-trunk training fast path (counterpart of
the JAX ``ops/int8_matmul.py``).

Both operands are int8:

- weights: the serving sibling leaves, ``kernel_int8 [in, out]`` codes with
  per-output-channel ``kernel_int8_scale [out]`` f32 (``ops/int8.quantize_int8``);
  the trunk keeps the codes' shape and values but K-major memory
  (``kmajor``), the layout the kernel reads;
- activations: quantized per row (per token) on every call, absmax/127
  symmetric over the feature dim (``quantize_rows_int8``, plain torch here as
  it is plain XLA there);
- the product accumulates in int32 and one f32 rescale
  ``(acc * row_scale) * col_scale`` dequantizes, cast once.

``w8a8_matmul`` is the kernel's wrapper: on a CUDA tensor it launches
``csrc/w8a8_matmul.cu`` (which takes K-major ``wq`` only) and adds one to
``w8a8_matmul.launches``; on a CPU tensor it runs the plain version
``int8_w8a8_matmul_reference``, which takes any layout. There is no
other path and no mode switch (the JAX package's ``TRUNK_MATMUL`` is not
carried over): an input the kernel does not take raises. The int32 sum is
exact in any order, so kernel and plain version agree bit for bit.

The op has no gradient, in the JAX package either: the trunk runs under
``torch.no_grad()`` (``models/transformer.forward``), and a call with grad
enabled on an input that requires grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from llm_fine_tune_distributed_tpu_torch.ops import _build

# |sum_k xq * wq| <= K * 127^2 must fit in int32
MAX_K = (2**31 - 1) // 127**2  # 133144
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def quantize_rows_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [..., in]`` -> ``(codes int8 [..., in], scale f32 [...])``: absmax/127
    symmetric scales over the trailing dim. All-zero rows get scale 1/127 and
    zero codes, so they dequantize to exact zeros."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax == 0.0, 1.0, absmax) / 127.0
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def kmajor(codes: torch.Tensor) -> torch.Tensor:
    """``codes [K, N]`` -> the same values in K-major memory: the transposed
    view of a contiguous ``[N, K]`` tensor, strides ``(1, K)``. The kernel
    reads each output column's K codes as one contiguous row, as the int8
    tensor cores want both operands; the trunk's codes are kept this way
    from the start, so no second copy exists."""
    return codes.t().contiguous().t()


def _check_kmajor(wq):
    """Raise, naming the layout, unless ``wq [K, N]`` is K-major (what
    ``kmajor`` makes): the only layout the CUDA kernel takes."""
    if not wq.t().is_contiguous():
        raise ValueError(
            "the w8a8 kernel takes wq [K, N] K-major: the transposed view of a contiguous "
            f"[N, K] tensor, strides (1, K) (ops.int8_matmul.kmajor makes it), got strides "
            f"{tuple(wq.stride())}")


def int8_w8a8_matmul_reference(xq, x_scale, wq, w_scale, out_dtype=torch.bfloat16):
    """Plain version of the kernel: ``xq [M, K]`` int8, ``x_scale [M]`` f32,
    ``wq [K, N]`` int8 in any layout, ``w_scale [N]`` f32 -> ``[M, N]`` in
    ``out_dtype``. The int32 product is taken as an f64 matmul, which is
    exact here (|acc| <= K * 127^2 < 2^53), then the epilogue in the JAX
    order."""
    acc = (xq.double() @ wq.double()).to(torch.int32)
    return ((acc.float() * x_scale[:, None]) * w_scale).to(out_dtype)


def _check(xq, x_scale, wq, w_scale, out_dtype):
    """Raise, naming the constraint, on inputs the kernel does not take."""
    if xq.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"w8a8_matmul takes xq [M, K] and wq [K, N], got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    m, k = xq.shape
    k2, n = wq.shape
    if k != k2:
        raise ValueError(f"inner dims differ: xq {tuple(xq.shape)}, wq {tuple(wq.shape)}")
    if k > MAX_K:
        raise ValueError(f"K = {k} > {MAX_K}: K * 127^2 would overflow the int32 accumulator")
    for name, t, dtype in (("xq", xq, torch.int8), ("wq", wq, torch.int8),
                           ("x_scale", x_scale, torch.float32),
                           ("w_scale", w_scale, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if x_scale.shape != (m,) or w_scale.shape != (n,):
        raise ValueError(f"scales must be x_scale [{m}] and w_scale [{n}], got "
                         f"{tuple(x_scale.shape)} and {tuple(w_scale.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"the output must be bf16 or f32, got {out_dtype}")
    tensors = (xq, x_scale, wq, w_scale)
    if any(t.device != xq.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if xq.device.type not in ("cuda", "cpu"):
        raise ValueError(f"w8a8_matmul runs on cuda or cpu, got {xq.device}")
    if not all(t.is_contiguous() for t in (xq, x_scale, w_scale)):
        raise ValueError("xq, x_scale and w_scale must be contiguous")
    if xq.device.type == "cuda":
        _check_kmajor(wq)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")


def w8a8_matmul(xq, x_scale, wq, w_scale, out_dtype=torch.bfloat16):
    """``out[m, n] = cast((float(sum_k xq[m, k] wq[k, n]) * x_scale[m]) *
    w_scale[n])``, shapes as in ``int8_w8a8_matmul_reference``. A CUDA tensor
    launches ``csrc/w8a8_matmul.cu`` on the current stream without
    synchronising and adds one to ``w8a8_matmul.launches``; it takes ``wq``
    K-major only (``kmajor``) and raises on any other layout. A CPU tensor
    runs the plain version, in any layout of ``wq``."""
    _check(xq, x_scale, wq, w_scale, out_dtype)
    if xq.device.type == "cpu":
        return int8_w8a8_matmul_reference(xq, x_scale, wq, w_scale, out_dtype)
    m, k = xq.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    err = _library().w8a8_matmul_launch(
        xq.data_ptr(), wq.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        m, n, k, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(xq.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"w8a8_matmul kernel launch failed: cudaError {err}")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("w8a8_matmul")
    fn = lib.w8a8_matmul_launch
    if fn.argtypes is None:  # first use: pointers and the stream as c_void_p
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def int8_w8a8_matmul(x: torch.Tensor, q: Dict[str, torch.Tensor],
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [..., in]`` x int8 weight ``q`` (``{"int8" [in, out], "int8_scale"
    [out]}``) -> ``[..., out]`` in ``compute_dtype``: per-row activation
    quantization, then one ``w8a8_matmul`` (the kernel on a CUDA tensor)."""
    if torch.is_grad_enabled() and (x.requires_grad or q["int8_scale"].requires_grad):
        raise RuntimeError(
            "int8_w8a8_matmul has no gradient: call it under torch.no_grad() (the frozen "
            "trunk does) or on inputs that do not require grad"
        )
    return _entry(w8a8_matmul, x, q, compute_dtype)


def int8_w8a8_matmul_plain(x: torch.Tensor, q: Dict[str, torch.Tensor],
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``int8_w8a8_matmul`` through the plain version on any device (the
    yardstick the kernel is held to)."""
    return _entry(int8_w8a8_matmul_reference, x, q, compute_dtype)


def _entry(matmul, x, q, compute_dtype):
    lead = x.shape[:-1]
    xq, x_scale = quantize_rows_int8(x.reshape(-1, x.shape[-1]))
    out = matmul(xq, x_scale, q["int8"], q["int8_scale"], compute_dtype)
    return out.reshape(*lead, out.shape[-1])
