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
reproduces the TPU's bits. ``seed`` is a host int, or an int32/int64 tensor
of one element on ``z``'s device that the kernel reads there (the TPU
kernel's ``seed_ref`` operand): a step captured in a CUDA graph takes its
seed from a device table, and draws what the same int draws.

Bound on the H100 (N=128, D=2048): 1 MiB in, 1 MiB out, 0.6 us at
3.35 TB/s: the kernel is bound by latency; ``csrc/infusion.cu`` has a
one-pass kernel (each thread keeps its rows in registers) for N up to
``ROW_GROUPS * REGISTER_ROWS[-1]`` and a three-pass loop kernel above, and
:func:`rows_per_thread` picks one by N.

Group mode (``group=`` a ``torch.distributed`` group of more than one rank):
the batch is split over the group's ranks, this rank holding rows ``[row0,
row0 + n)`` of the global batch, and the standardization is over the global
batch (what pjit makes of the JAX package's batch statistics). Three
launches of the group kernel with an all-reduce of a (D + 1,) buffer after
each of the first two (column sums and row count, then centered sums); the
Philox counter takes ``row0``, so the ranks draw the global batch's
uniforms. :func:`infused_noise_group_plain` is its plain version; the
one-device path is untouched.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

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


def philox_key(seed):
    """A Philox key word from a host int or a one-element integer tensor
    (an int64 0-dim tensor then, read on its device without a host sync)."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64)
    return int(seed)


def philox_uniform(seed, n: int, d: int, noise_range: float, device, row0: int = 0) -> torch.Tensor:
    """(n, d) float32 uniforms in [-noise_range, noise_range) from the
    kernel's Philox stream, rows ``[row0, row0 + n)`` of it; ``seed`` an int
    or a one-element integer tensor on ``device``."""
    row = torch.arange(row0, row0 + n, dtype=torch.int64, device=device)[:, None].expand(n, d) & _MASK
    col = torch.arange(d, dtype=torch.int64, device=device)[None, :].expand(n, d)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0 = philox4x32((row, col, zero, zero), (philox_key(seed), 0))[0]
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


def infused_noise_plain(z: torch.Tensor, n: int, *, seed=None,
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


def infused_noise_group_plain(z: torch.Tensor, n: int, group, *, seed: Optional[int] = None,
                              u: Optional[torch.Tensor] = None, noise_range: float = 0.3,
                              row0: int = 0) -> torch.Tensor:
    """The group kernel's function in PyTorch ops: this rank's rows ``[row0,
    row0 + n)`` of the global batch's infused noise, standardized over the
    global batch (two all-reduces over ``group``, as the kernel's wrapper)."""
    if u is None:
        u = philox_uniform(seed, n, z.shape[1], noise_range, z.device, row0)
    x = u + z
    sums = torch.cat([x.sum(dim=0), torch.full((1,), float(n), device=x.device)])
    dist.all_reduce(sums, group=group)
    count = sums[-1]
    c = x - sums[:-1] / count
    sq = (c * c).sum(dim=0)
    dist.all_reduce(sq, group=group)
    return c / torch.sqrt(sq / torch.clamp(count - 1.0, min=1.0) + 1e-12)


def _check_seed(seed, z: torch.Tensor) -> None:
    if isinstance(seed, torch.Tensor) and (seed.device != z.device or seed.numel() != 1
                                           or seed.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"a tensor seed must be one int32 or int64 element on {z.device}; "
                         f"got {seed.dtype} {tuple(seed.shape)} on {seed.device}")


def _check_inputs(z: torch.Tensor, n: int, d: int, **given: Optional[torch.Tensor]) -> None:
    shapes = {"u": (n, d), "pop_mean": (d,), "pop_std": (d,)}
    for name, t in (("z", z), *given.items()):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != z.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {z.device}")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must have shape {shapes[name]}; got {tuple(t.shape)}")


def _grouped(group) -> bool:
    return group is not None and dist.get_world_size(group) > 1


def infused_noise(z: torch.Tensor, n: int, *, seed=None,
                  u: Optional[torch.Tensor] = None, noise_range: float = 0.3,
                  pop_mean: Optional[torch.Tensor] = None,
                  pop_std: Optional[torch.Tensor] = None, group=None, row0: int = 0) -> torch.Tensor:
    """(n, D) float32 infused noise from z_mean ``z`` of shape (n, D) or (1, D)
    (one patient broadcast over n rows). Exactly one of ``seed`` (an int, or
    an int32/int64 tensor of one element on ``z``'s device, read there) and
    ``u`` (float32 (n, D), in [-noise_range, noise_range]). With ``pop_mean`` and
    ``pop_std`` (D,) it normalizes with those instead of the batch statistics.
    With ``group`` (more than one rank) the rows are ``[row0, row0 + n)`` of
    a global batch split over the group, standardized over all of it (the
    group mode; ``n`` may differ between ranks, and be 0)."""
    if (seed is None) == (u is None):
        raise ValueError("pass exactly one of seed and u")
    if (pop_mean is None) != (pop_std is None):
        raise ValueError("pass pop_mean and pop_std together")
    grouped = _grouped(group)
    if grouped and pop_mean is not None:
        raise ValueError("population statistics need no group: pass one or the other")
    if grouped and isinstance(seed, torch.Tensor):
        raise ValueError("the group mode takes a host int seed")
    _check_seed(seed, z)
    if z.ndim != 2 or z.shape[0] not in (1, n) or n < (0 if grouped else 1):
        raise ValueError(f"z must be (n, D) or (1, D) with n >= 1; got {tuple(z.shape)}, n={n}")
    d = z.shape[1]
    if grouped:
        return _infused_noise_group(z, n, group, seed, u, noise_range, row0)
    if z.device.type == "cpu":
        return infused_noise_plain(z, n, seed=seed, u=u, noise_range=noise_range,
                                   pop_mean=pop_mean, pop_std=pop_std)
    if z.device.type != "cuda":
        raise ValueError(f"infused_noise runs on CUDA or CPU tensors, not {z.device}")
    _check_inputs(z, n, d, u=u, pop_mean=pop_mean, pop_std=pop_std)
    out = torch.empty((n, d), dtype=torch.float32, device=z.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    on_device = isinstance(seed, torch.Tensor)
    host_seed = 0 if seed is None or on_device else int(seed) & _MASK
    with torch.cuda.device(z.device):
        err = _build.library().rnagan_infused_noise(
            z.data_ptr(), 0 if z.shape[0] == 1 else d, ptr(u), ptr(pop_mean), ptr(pop_std),
            out.data_ptr(), n, d, host_seed, seed.data_ptr() if on_device else None,
            seed.element_size() if on_device else 0, noise_range, _var_u(noise_range), rows_per_thread(n),
            torch.cuda.current_stream().cuda_stream)
    _build.check("rnagan_infused_noise", err)
    infused_noise.launches += 1
    return out


infused_noise.launches = 0
#: launches of the group kernel (three a group-mode call)
infused_noise.group_launches = 0


def _infused_noise_group(z, n, group, seed, u, noise_range, row0) -> torch.Tensor:
    if z.device.type == "cpu":
        return infused_noise_group_plain(z, n, group, seed=seed, u=u, noise_range=noise_range, row0=row0)
    if z.device.type != "cuda":
        raise ValueError(f"infused_noise runs on CUDA or CPU tensors, not {z.device}")
    d = z.shape[1]
    _check_inputs(z, n, d, u=u)
    out = torch.empty((n, d), dtype=torch.float32, device=z.device)
    sums = torch.empty(d + 1, dtype=torch.float32, device=z.device)
    sums[d:].fill_(float(n))  # this rank's row count, summed with the column sums
    sq = torch.empty(d, dtype=torch.float32, device=z.device)
    lib = _build.library()
    seed32 = 0 if seed is None else int(seed) & _MASK
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        for phase, reduced in ((0, sums), (1, sq), (2, None)):
            err = lib.rnagan_infused_noise_group(
                z.data_ptr(), 0 if z.shape[0] == 1 else d, None if u is None else u.data_ptr(),
                out.data_ptr(), sums.data_ptr(), sq.data_ptr(), n, d, int(row0), seed32, noise_range,
                phase, stream)
            _build.check("rnagan_infused_noise_group", err)
            infused_noise.group_launches += 1
            if reduced is not None:
                dist.all_reduce(reduced, group=group)
    return out
