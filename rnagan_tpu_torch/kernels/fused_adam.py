"""Multi-tensor Adam kernel (CUDA) and its plain PyTorch version.

Replaces ``rnagan_tpu/ops/fused_adam.py::adam_update_flat`` (body
``_adam_kernel``): one in-place Adam step with optax's arithmetic, the bias
corrections ``c1 = 1 - b1^t`` and ``c2 = 1 - b2^t`` given as scalars, or as
``corr``, a float32 (2,) tensor on the parameters' device that the kernel
reads there (the TPU kernel's SMEM ``corr`` operand; a step captured in a
CUDA graph takes them from a device table). ``corr`` may also be (3,),
``(c1, c2, lr)``: the step's rate is then read from device memory too (a
schedule's rate, which optax evaluates inside the JAX step), with the same
arithmetic and roundings as a launch with that float32 rate::

    mu = b1*mu + (1-b1)*g
    nu = b2*nu + ((1-b2)*g)*g
    u  = (mu/c1) / (sqrt(nu/c2) + eps)
    u  = u + wd*p          (optax.adamw's decoupled weight decay, when wd != 0)
    p  = p - lr * u

The TPU kernel runs over one flat copy of every parameter; this one walks the
model's tensors in place, one launch per call (``csrc/fused_adam.cu``). Both
versions round each step separately and in the same order, so on one device
they agree bit for bit. ``mu`` may be bfloat16 (optax ``mu_dtype``): it is
read into float32, used in float32 and rounded to nearest even on store.

Bound on the H100: 28 bytes a parameter (24 with a bf16 ``mu``); the
training step's 156,554,948 parameters take 1.3085 ms at 3.35 TB/s,
ResNet50's 23,512,130 (2 classes) 0.1965 ms.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from rnagan_tpu_torch.kernels import _build

#: tensors one launch takes (the kernel's parameter-block table; the DCGAN
#: generator has 20 tensors, ResNet50's classifier 161, ResNet152's 467)
MAX_TENSORS = 512


def adam_update_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                      mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                      c1: Optional[float], c2: Optional[float], lr: Optional[float], b1: float, b2: float,
                      eps: float, wd: float = 0.0, corr: Optional[torch.Tensor] = None) -> None:
    """The kernel's arithmetic in separate PyTorch ops, in place on
    ``params``, ``mus`` and ``nus``. ``c1`` and ``c2`` (or ``corr``'s first
    two values, ``c1`` and ``c2`` then None) divide as tensors on the
    parameters' device: PyTorch's CUDA division by a Python number multiplies
    by its reciprocal, which rounds differently. A (3,) ``corr`` holds the
    rate as its third value (``lr`` then None): a float32 product by a 0-dim
    tensor rounds as the product by the same float32 number. ``wd`` adds
    ``wd * p`` to the update (AdamW)."""
    with torch.no_grad():
        dev = params[0].device
        if corr is not None:
            c1, c2 = corr[0], corr[1]
            if corr.shape[0] == 3:
                lr = corr[2]
        else:
            c1, c2 = torch.tensor(c1, device=dev), torch.tensor(c2, device=dev)
        for p, g, mu, nu in zip(params, grads, mus, nus):
            m = mu.float() * b1 + g * (1.0 - b1)
            v = nu * b2 + (g * (1.0 - b2)) * g
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            if wd:
                upd = upd + p * wd
            p.sub_(upd * lr)
            mu.copy_(m)
            nu.copy_(v)


def _check(params, grads, mus, nus) -> torch.dtype:
    n = len(params)
    if not (len(grads) == len(mus) == len(nus) == n) or n == 0:
        raise ValueError("params, grads, mus and nus must be non-empty lists of one length")
    if n > MAX_TENSORS:
        raise ValueError(f"one launch takes at most {MAX_TENSORS} tensors; got {n}")
    dev = params[0].device
    mu_dtype = mus[0].dtype
    if mu_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mu must be float32 or bfloat16, not {mu_dtype}")
    for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus)):
        for name, t in (("param", p), ("grad", g), ("mu", mu), ("nu", nu)):
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name} {i} must be a contiguous tensor on {dev}")
            if t.numel() != p.numel():
                raise ValueError(f"{name} {i} has {t.numel()} elements, its param {p.numel()}")
        if p.dtype != torch.float32 or g.dtype != torch.float32 or nu.dtype != torch.float32:
            raise ValueError(f"param, grad and nu {i} must be float32")
        if mu.dtype != mu_dtype:
            raise ValueError("every mu must have one dtype")
    return mu_dtype


def _check_corr(c1, c2, lr, corr, dev) -> None:
    if (corr is None) == (c1 is None or c2 is None):
        raise ValueError("pass c1 and c2, or corr")
    if corr is not None and (corr.dtype != torch.float32 or corr.device != dev
                             or tuple(corr.shape) not in ((2,), (3,)) or not corr.is_contiguous()):
        raise ValueError(f"corr must be a contiguous float32 (2,) or (3,) tensor on {dev}; "
                         f"got {corr.dtype} {tuple(corr.shape)} on {corr.device}")
    holds_lr = corr is not None and corr.shape[0] == 3
    if holds_lr and lr is not None:
        raise ValueError("corr must be (2,) beside lr: a (3,) corr holds the rate")
    if not holds_lr and lr is None:
        raise ValueError("pass lr, or a (3,) corr that holds it")


def fused_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor], *, c1: Optional[float] = None,
               c2: Optional[float] = None, lr: Optional[float], b1: float, b2: float, eps: float,
               wd: float = 0.0, corr: Optional[torch.Tensor] = None) -> None:
    """One Adam step over every tensor of a model (at most
    :data:`MAX_TENSORS`), in place on ``params``, ``mus`` and ``nus``, in one
    launch. ``c1``/``c2`` are the bias corrections for this step, or
    ``corr`` holds them on the device (float32 (2,)), or them and the rate
    (float32 (3,), ``lr`` then None); ``wd`` is AdamW's decoupled weight
    decay (0: Adam)."""
    params, grads, mus, nus = list(params), list(grads), list(mus), list(nus)
    mu_dtype = _check(params, grads, mus, nus)
    dev = params[0].device
    _check_corr(c1, c2, lr, corr, dev)
    if dev.type == "cpu":
        adam_update_plain(params, grads, mus, nus, c1, c2, lr, b1, b2, eps, wd, corr=corr)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused_adam runs on CUDA or CPU tensors, not {dev}")
    table = (ctypes.c_ulonglong * (5 * len(params)))(
        *(w for p, g, mu, nu in zip(params, grads, mus, nus)
          for w in (p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel())))
    with torch.cuda.device(dev):
        err = _build.library().rnagan_fused_adam(
            ctypes.addressof(table), len(params), int(mu_dtype == torch.bfloat16), 0.0 if lr is None else lr,
            b1, b2, 1.0 - b1, 1.0 - b2, eps, 0.0 if corr is not None else c1, 0.0 if corr is not None else c2,
            None if corr is None else corr.data_ptr(), 0 if corr is None else corr.shape[0], wd,
            torch.cuda.current_stream().cuda_stream)
    _build.check("rnagan_fused_adam", err)
    fused_adam.launches += 1


fused_adam.launches = 0
