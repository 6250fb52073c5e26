"""int8-weight matmul kernels (CUDA, tensor cores) and their plain PyTorch version.

Replaces ``rnagan_tpu/ops/quant_matmul.py::pallas_int8_matmul`` (body
``_kernel``)::

    out[n, m] = (sum_k bf16(x[n, k]) * bf16(w_q[k, m])) * scale[m] + bias[m]

with a float32 sum. ``quantize_per_channel`` is a copy of the JAX package's:
symmetric max-abs int8 per output column, in numpy float32, bit-equal to it.

Bound on the H100 (N=128, K=2048, M=32768): 85.2 MB moved, 25.4 us at
3.35 TB/s; the 17.2 GFLOP take 17.4 us on the bf16 tensor cores.
``csrc/quant_matmul.cu`` has two kernels, and :func:`plan` picks one by shape:
the TMA + ``wgmma`` kernel where TMA can read the weight (M a multiple of 16,
a 16-byte aligned weight pointer), the byte-wise ``mma.sync`` kernel
otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from rnagan_tpu_torch.kernels import _build

#: the wgmma kernel's N tiles (the ``wgmma`` N width, ``csrc/quant_matmul.cu``
#: ``int8_matmul_wgmma<BN>``); a larger N takes several tiles of the largest
WGMMA_TILES_N = (32, 64, 128)
#: its bf16 copy of x keeps N rows and pads K to this (``kKPitch``: TMA reads
#: rows whose pitch is a multiple of 16 bytes)
WGMMA_K_PITCH = 8
#: the byte-wise kernel's tile along N and step along K (``kByteBM``,
#: ``kByteBK``): its bf16 copy of x is padded to whole tiles
BYTEWISE_TILE_N, BYTEWISE_TILE_K = 128, 32
ROUTES = ("wgmma", "bytewise")


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


@dataclass(frozen=True)
class Plan:
    route: str  # "wgmma" or "bytewise"
    tile_n: int  # rows of x a block takes
    scratch: Tuple[int, int]  # shape of the kernel's bf16 copy of x


def plan(n: int, k: int, m: int, w_ptr: int) -> Plan:
    """The kernel for x (n, k) and a (k, m) int8 weight at address ``w_ptr``,
    by shape only: TMA reads the weight when its rows are whole 16-byte units
    from a 16-byte aligned start."""
    if m % 16 == 0 and w_ptr % 16 == 0:
        tile = next((t for t in WGMMA_TILES_N if n <= t), WGMMA_TILES_N[-1])
        return Plan("wgmma", tile, (n, _round_up(k, WGMMA_K_PITCH)))
    return Plan("bytewise", BYTEWISE_TILE_N,
                (_round_up(n, BYTEWISE_TILE_N), _round_up(k, BYTEWISE_TILE_K)))


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x (N, K) float32; w_q (K, M) int8; scale, bias (M,) float32 -> (N, M)
    float32. Any N, K, M >= 1."""
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0] or 0 in (*x.shape, w_q.shape[1]):
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
    p = plan(n, k, m, w_q.data_ptr())
    xb = torch.empty(p.scratch, dtype=torch.bfloat16, device=x.device)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), xb.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, k, m)
    name = f"rnagan_int8_matmul_{p.route}"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(_build.library(), name)
        err = fn(*args, p.tile_n, stream) if p.route == "wgmma" else fn(*args, stream)
    _build.check(name, err)
    int8_matmul.launches += 1
    int8_matmul.launches_by_route[p.route] += 1
    return out


int8_matmul.launches = 0
int8_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
