"""Infused-noise kernel (CUDA) and its plain PyTorch version.

Replaces ``rnagan_tpu/ops/infusion.py::pallas_infused_noise`` (body
``_infusion_kernel``): ``standardize(U(-r, r) + z_mean)`` over the batch, per
column, ddof=1, ``+1e-12`` inside the sqrt. ``pop_mean``/``pop_std`` switch
the normalization to fixed population statistics
(``infused_noise_population``), so both generation modes run through the
kernel.

Uniforms: pass ``u`` (already in [-r, r]) for exact parity, or ``seed`` for a
Philox4x32-10 stream with counter (row, col, 0, 0) and key (seed, 0), the top
24 bits of word 0 mapped to [0, 1) as the TPU kernel maps its random bits.
The plain version runs the same Philox in int64 tensor ops, so on one device
a seed gives the kernel and the plain version the same uniforms. Neither
reproduces the TPU's bits.

Bound on the H100 (N=128, D=2048): 1 MiB in, 1 MiB out, 0.6 us at
3.35 TB/s: the kernel is bound by latency; ``csrc/infusion.cu`` has a
one-pass kernel (each thread keeps its rows in registers) for N up to
``ROW_GROUPS * REGISTER_ROWS[-1]`` and a three-pass loop kernel above, and
:func:`rows_per_thread` picks one by N.
"""

from __future__ import annotations

from typing import Optional

import torch

from rnagan_tpu_torch.kernels import _build

_MASK = 0xFFFFFFFF
_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
#: threads that share a column in the one-pass kernel (``kStripGroups``)
ROW_GROUPS = 32
#: rows each of them keeps in registers: one instance of the kernel each
REGISTER_ROWS = (1, 2, 4, 8)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for c in [0, 2**32), in int64 without
    overflow: c splits into 16-bit halves so every product stays below 2**49."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return ((b >> 16) + (t >> 32)) & _MASK, t & _MASK


def philox4x32(counter, key):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 values.
    ``counter``: four tensors (or ints) of one shape; ``key``: two ints."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform(seed: int, n: int, d: int, noise_range: float, device) -> torch.Tensor:
    """(n, d) float32 uniforms in [-noise_range, noise_range) from the
    kernel's Philox stream."""
    row = torch.arange(n, dtype=torch.int64, device=device)[:, None].expand(n, d)
    col = torch.arange(d, dtype=torch.int64, device=device)[None, :].expand(n, d)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0 = philox4x32((row, col, zero, zero), (int(seed), 0))[0]
    u01 = (w0 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return (u01 * 2.0 - 1.0) * noise_range


def rows_per_thread(n: int) -> int:
    """The one-pass kernel's rows a thread for a batch of ``n`` rows: the
    fewest that cover it, or 0 (the loop kernel) above the largest."""
    return next((r for r in REGISTER_ROWS if n <= ROW_GROUPS * r), 0)


def _var_u(noise_range: float) -> float:
    return (2.0 * noise_range) ** 2 / 12.0  # variance of U(-r, r)


def standardize_batch(x: torch.Tensor) -> torch.Tensor:
    """Per-column standardization over the batch, ddof=1 (torch.std parity)."""
    c = x - x.mean(dim=0)
    var = (c * c).sum(dim=0) / max(x.shape[0] - 1, 1)
    return c / torch.sqrt(var + 1e-12)


def infused_noise_plain(z: torch.Tensor, n: int, *, seed: Optional[int] = None,
                        u: Optional[torch.Tensor] = None, noise_range: float = 0.3,
                        pop_mean: Optional[torch.Tensor] = None,
                        pop_std: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops (same arguments as :func:`infused_noise`)."""
    if u is None:
        u = philox_uniform(seed, n, z.shape[1], noise_range, z.device)
    x = u + z
    if pop_mean is not None:
        return (x - pop_mean) / torch.sqrt(pop_std * pop_std + _var_u(noise_range))
    return standardize_batch(x)


def infused_noise(z: torch.Tensor, n: int, *, seed: Optional[int] = None,
                  u: Optional[torch.Tensor] = None, noise_range: float = 0.3,
                  pop_mean: Optional[torch.Tensor] = None,
                  pop_std: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, D) float32 infused noise from z_mean ``z`` of shape (n, D) or (1, D)
    (one patient broadcast over n rows). Exactly one of ``seed`` and ``u``
    (float32 (n, D), in [-noise_range, noise_range]). With ``pop_mean`` and
    ``pop_std`` (D,) it normalizes with those instead of the batch statistics."""
    if (seed is None) == (u is None):
        raise ValueError("pass exactly one of seed and u")
    if (pop_mean is None) != (pop_std is None):
        raise ValueError("pass pop_mean and pop_std together")
    if z.ndim != 2 or z.shape[0] not in (1, n) or n < 1:
        raise ValueError(f"z must be (n, D) or (1, D) with n >= 1; got {tuple(z.shape)}, n={n}")
    d = z.shape[1]
    if z.device.type == "cpu":
        return infused_noise_plain(z, n, seed=seed, u=u, noise_range=noise_range,
                                   pop_mean=pop_mean, pop_std=pop_std)
    if z.device.type != "cuda":
        raise ValueError(f"infused_noise runs on CUDA or CPU tensors, not {z.device}")
    for name, t, shape in (("z", z, None), ("u", u, (n, d)),
                           ("pop_mean", pop_mean, (d,)), ("pop_std", pop_std, (d,))):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != z.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {z.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}; got {tuple(t.shape)}")
    out = torch.empty((n, d), dtype=torch.float32, device=z.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(z.device):
        err = _build.library().rnagan_infused_noise(
            z.data_ptr(), 0 if z.shape[0] == 1 else d, ptr(u), ptr(pop_mean), ptr(pop_std),
            out.data_ptr(), n, d, 0 if seed is None else int(seed) & _MASK, noise_range,
            _var_u(noise_range), rows_per_thread(n), torch.cuda.current_stream().cuda_stream)
    _build.check("rnagan_infused_noise", err)
    infused_noise.launches += 1
    return out


infused_noise.launches = 0
