"""int8-weight matmul kernel (CUDA, tensor cores) and its plain PyTorch version.

Replaces ``rnagan_tpu/ops/quant_matmul.py::pallas_int8_matmul`` (body
``_kernel``)::

    out[n, m] = (sum_k bf16(x[n, k]) * bf16(w_q[k, m])) * scale[m] + bias[m]

with a float32 sum. ``quantize_per_channel`` is a copy of the JAX package's:
symmetric max-abs int8 per output column, in numpy float32, bit-equal to it.

Bound on the H100 (N=128, K=2048, M=32768): 85.2 MB moved, 25.4 us at
3.35 TB/s; the 17.2 GFLOP take 17.4 us on the bf16 tensor cores and 257 us
at the float32 rate outside them. ``csrc/quant_matmul.cu`` says how its
design meets that.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rnagan_tpu_torch.kernels import _build

#: the kernel's tile along N and step along K (``csrc/quant_matmul.cu``
#: ``kBM``, ``kBK``): its bf16 copy of x is padded to whole tiles
TILE_N, TILE_K = 128, 32


def quantize_per_channel(w) -> Tuple[np.ndarray, np.ndarray]:
    """w (K, M) float -> (int8 (K, M), scales (M,)) with symmetric max-abs
    per-output-column quantization (``ops/quant_matmul.py:30-37``)."""
    w = np.asarray(w, np.float32)
    absmax = np.abs(w).max(axis=0)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scales[None, :]), -127, 127).astype(np.int8)
    return q, scales


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch ops: a float32 product of the
    bf16-rounded x and the widened int8 weight (exact values), then
    ``acc * scale + bias``."""
    acc = torch.matmul(x.float().to(torch.bfloat16).float(), w_q.float())
    return acc * scale + bias


def _round_up(v: int, to: int) -> int:
    return (v + to - 1) // to * to


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x (N, K) float32; w_q (K, M) int8; scale, bias (M,) float32 -> (N, M)
    float32. Any N >= 1, K and M."""
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0] or x.shape[0] < 1:
        raise ValueError(f"expected x (N, K) and w_q (K, M); got {tuple(x.shape)}, {tuple(w_q.shape)}")
    n, k = x.shape
    m = w_q.shape[1]
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, not {x.device}")
    for name, t, dtype, shape in (("x", x, torch.float32, (n, k)), ("w_q", w_q, torch.int8, (k, m)),
                                  ("scale", scale, torch.float32, (m,)),
                                  ("bias", bias, torch.float32, (m,))):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on {x.device}")
    xb = torch.empty((_round_up(n, TILE_N), _round_up(k, TILE_K)), dtype=torch.bfloat16,
                     device=x.device)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().rnagan_int8_matmul(
            x.data_ptr(), xb.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, k, m, torch.cuda.current_stream().cuda_stream)
    _build.check("rnagan_int8_matmul", err)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
