"""tanh -> uint8 egress kernel (CUDA) and its plain PyTorch version.

Replaces ``rnagan_tpu/ops/quantize.py::pallas_tanh_to_uint8`` (body
``_quant_kernel``): ``trunc(clip((tanh(x) * 0.5 + 0.5) * 255 + 0.5, 0, 255))``,
rounding half up as the Pallas kernel does. It reads the generator's NCHW
pre-tanh float32 output and writes the JAX package's NHWC uint8 layout in the
same pass.

Bound on the H100 (N=128, 3x256x256): 100.7 MB in and 25.2 MB out, 37.6 us
at 3.35 TB/s; bytes bound it. ``csrc/quantize.cu`` says how its design meets that.
"""

from __future__ import annotations

import torch

from rnagan_tpu_torch.kernels import _build


def tanh_to_uint8_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) pre-tanh -> (N, H, W, C) uint8, in PyTorch ops."""
    x01 = torch.tanh(x.float()) * 0.5 + 0.5
    q = torch.clamp(x01 * 255.0 + 0.5, 0.0, 255.0).to(torch.int32).to(torch.uint8)
    return q.permute(0, 2, 3, 1).contiguous()


def tanh_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) float32 pre-tanh generator output -> (N, H, W, C) uint8."""
    if x.ndim != 4:
        raise ValueError(f"expected (N, C, H, W); got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return tanh_to_uint8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"tanh_to_uint8 runs on CUDA or CPU tensors, not {x.device}")
    n, c, h, w = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned float32 tensor")
    if c != 3 or (h * w) % 4:
        raise ValueError(f"the kernel takes 3 channels and H*W divisible by 4; got {tuple(x.shape)}")
    out = torch.empty((n, h, w, c), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().rnagan_tanh_to_uint8(
            x.data_ptr(), out.data_ptr(), n, h * w, torch.cuda.current_stream().cuda_stream)
    _build.check("rnagan_tanh_to_uint8", err)
    tanh_to_uint8.launches += 1
    return out


tanh_to_uint8.launches = 0
