"""Train-mode BatchNorm (+ LeakyReLU) of a bf16 channels-last map: CUDA kernels and their plain versions.

Replaces no TPU kernel: the JAX package's BatchNorm is flax's
``nn.BatchNorm``, which XLA fuses on the TPU; ``models/batchnorm.py`` writes
its arithmetic as PyTorch ops, about ten float32 passes over the map. Here
the same function is one autograd op, :func:`batch_norm_act`, with flax's
semantics (``models/batchnorm.py``'s docstring) and LeakyReLU fused after it
where ``slope`` is given. A channels-last (N, C, H, W) map is the row-major
(R, C) matrix with R = N * H * W; every stage works on that view:

* statistics (``rnagan_bn_stats``): per channel ``m = E[x]``,
  ``raw = E[x^2] - m^2``, ``rstd = rsqrt(max(raw, 0) + eps)``, ``mul = rstd *
  scale`` and the new running statistics, as a (4, C) float32 ``stats``
  (m, rstd, mul, raw);
* normalize (``rnagan_bn_apply``): ``z = bf16((x - m) * mul + bias)``, ``y =
  z > 0 ? z : bf16(z * slope)``;
* the backward's sums (``rnagan_bn_grad_sums``): ``dbias = sum g'`` and
  ``dscale = sum g' * xh``, ``g'`` the output gradient through the
  activation at z (recomputed from x), ``xh = (x - m) * rstd``;
* the backward's ``dx`` (``rnagan_bn_grad_input``): ``mul * (g' - dbias / R -
  [raw >= 0] * xh * dscale / R)``;
* the double backward's sums (``rnagan_bn_grad2_sums``): per channel
  ``E[u]``, ``E[u * xh]`` and ``sum u * g'`` of the cotangent ``u`` of dx,
  turned into :data:`GRAD2_COEFS` coefficients and the scale's gradient;
* the double backward's maps (``rnagan_bn_grad2_input``): the gradients of
  g and x, each an affine function of ``u``, ``g'`` and ``xh`` a channel.

The backward is itself an autograd op (:class:`_BatchNormActGrad`), so the
gradient penalty can differentiate it once more; ``csrc/batchnorm.cu``
states the double backward's closed form. A CPU tensor takes each stage's
plain version (in float64 for a float64 map, else float32); a CUDA tensor
launches the kernels on a map that :func:`kernel_map` admits or raises.

Bound on the H100: bytes. The function needs 4 bytes an element forward (x
read, y written), 6 backward (x and g read, dx written) and 10 in the double
backward (x, g and u read, two maps written); this design reads each input
twice, 6, 10 and 16 bytes an element. ``csrc/batchnorm.cu`` says why its
sums are bit-stable; each launch that sums counts its blocks' arrivals on
tickets of its own, so launches may overlap on any streams.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rnagan_tpu_torch.kernels import _build

#: flax's BatchNorm: the weight of the old running statistics, and epsilon (``csrc/batchnorm.cu``'s own)
MOMENTUM = 0.9
EPS = 1e-5
#: threads a block, bf16 channels a thread's vector, channel groups a block's tile, rows a thread's step
THREADS, VEC, TILE_GROUPS, UNROLL = 256, 8, 32, 4
#: blocks a statistics launch aims at (two a streaming multiprocessor of the H100's 132), and an elementwise one
SUM_BLOCKS, MAP_BLOCKS = 264, 1056
#: partial sums of one kind a statistics launch leaves a tile's last block (chunks x the tile's channels)
MAX_PARTIALS = 32768
#: per-channel coefficients of the double backward's maps (``csrc/batchnorm.cu``'s ``kGrad2Coefs``)
GRAD2_COEFS = 5


def tiles(channels: int) -> int:
    """Channel tiles of a launch: the grid's second dimension."""
    return -(-(channels // VEC) // TILE_GROUPS)


def plan(rows: int, channels: int, sums: bool) -> Tuple[int, int]:
    """``(chunks, rows_per_chunk)`` of a launch over an (R, C) map: the row
    chunks of the grid's first dimension (its second is the channel tiles).
    A statistics launch (``sums``) takes fewer, so each tile's last block has
    few partials to add; every chunk gives each thread at least ``UNROLL``
    rows."""
    groups = min(channels // VEC, TILE_GROUPS)
    rows_at_once = THREADS // groups
    chunks = min(-(-(SUM_BLOCKS if sums else MAP_BLOCKS) // tiles(channels)), -(-rows // (rows_at_once * UNROLL)))
    if sums:
        chunks = min(chunks, MAX_PARTIALS // min(channels, TILE_GROUPS * VEC))
    per = -(-rows // max(chunks, 1))
    return -(-rows // per), per


def rows_of(t: torch.Tensor) -> torch.Tensor:
    """The (R, C) rows of an (N, C, H, W) map: a view of a channels-last one."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _map_like(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(R, C) rows as a map of ``like``'s shape and memory format."""
    n, c, h, w = like.shape
    out = rows.reshape(n, h, w, c).permute(0, 3, 1, 2)
    if like.is_contiguous(memory_format=torch.channels_last):
        return out
    return out.contiguous()


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


# ----------------------------------------------------------------- plain versions


def stats_plain(x: torch.Tensor, scale: Optional[torch.Tensor], mean: torch.Tensor,
                var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(stats, new_mean, new_var)`` of (R, C) rows: ``stats`` (4, C) holds m, rstd, mul, raw."""
    xf = x.to(_acc(x.dtype))
    n = x.shape[0]
    m = xf.sum(0) / n
    raw = (xf * xf).sum(0) / n - m * m
    v = torch.clamp(raw, min=0.0)
    r = torch.rsqrt(v + EPS)
    mul = r if scale is None else r * scale
    new_mean = MOMENTUM * mean + (1.0 - MOMENTUM) * m
    new_var = MOMENTUM * var + (1.0 - MOMENTUM) * v
    return torch.stack([m, r, mul, raw]), new_mean, new_var


def _normalized(xf: torch.Tensor, stats: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """``z = (x - m) * mul + bias``, rounded to the map's dtype as the kernels round it."""
    z = (xf - stats[0]) * stats[2]
    if bias is not None:
        z = z + bias
    return z.to(dtype)


def _through_act(g: torch.Tensor, z: torch.Tensor, slope: Optional[float]) -> torch.Tensor:
    """``g'``: the output gradient through the activation at ``z`` (LeakyReLU's backward in g's dtype)."""
    if slope is not None:
        g = torch.where(z > 0, g, g * slope)
    return g.to(_acc(z.dtype))


def apply_plain(x: torch.Tensor, stats: torch.Tensor, bias: Optional[torch.Tensor],
                slope: Optional[float]) -> torch.Tensor:
    """``act(z)`` of (R, C) rows, in x's dtype."""
    z = _normalized(x.to(_acc(x.dtype)), stats, bias, x.dtype)
    return z if slope is None else F.leaky_relu(z, slope)


def grad_sums_plain(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor, bias: Optional[torch.Tensor],
                    slope: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dbias, dscale)`` = ``(sum g', sum g' * xh)`` over (R, C) rows."""
    xf = x.to(_acc(x.dtype))
    gp = _through_act(g, _normalized(xf, stats, bias, x.dtype), slope)
    return gp.sum(0), (gp * (xf - stats[0])).sum(0) * stats[1]


def grad_input_plain(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor, bias: Optional[torch.Tensor],
                     slope: Optional[float], dbias: torch.Tensor, dscale: torch.Tensor) -> torch.Tensor:
    """``dx`` of (R, C) rows, in x's dtype."""
    n = x.shape[0]
    xf = x.to(_acc(x.dtype))
    gp = _through_act(g, _normalized(xf, stats, bias, x.dtype), slope)
    xh = (xf - stats[0]) * stats[1]
    mean_gx = torch.where(stats[3] >= 0, dscale / n, torch.zeros_like(dscale))  # the clamp passes none
    return (stats[2] * (gp - dbias / n - xh * mean_gx)).to(x.dtype)


def grad2_sums_plain(g: torch.Tensor, x: torch.Tensor, u: torch.Tensor, stats: torch.Tensor,
                     bias: Optional[torch.Tensor], slope: Optional[float], dbias: torch.Tensor, dscale: torch.Tensor,
                     a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(coef, dscale_grad)`` of the double backward over (R, C) rows: ``u``,
    ``a`` and ``b`` are the cotangents of dx, dscale and dbias (``a``, ``b``
    may be None); ``coef`` (``GRAD2_COEFS``, C) holds the coefficient of xh
    and the constant of d/dg's inner term, then those of u, xh and 1 in
    d/dx (g''s is ``rstd`` times the first)."""
    n = x.shape[0]
    xf = x.to(_acc(x.dtype))
    m, r, mul, raw = stats
    xh = (xf - m) * r
    gp = _through_act(g, _normalized(xf, stats, bias, x.dtype), slope)
    uf = u.to(xf.dtype)
    mu, ux, ug = uf.sum(0) / n, (uf * xh).sum(0) / n, (uf * gp).sum(0)
    c = (raw >= 0).to(xf.dtype)
    av = torch.zeros_like(m) if a is None else a
    bv = torch.zeros_like(m) if b is None else b
    q = ug - dbias * mu - c * dscale * ux
    xh_g = av - c * mul * ux
    p_mean = -c * mul * (mu * dscale / n) + xh_g * dbias / n
    pxh_mean = xh_g * dscale / n - c * mul * ux * dscale / n
    coef = torch.stack([xh_g, bv - mul * mu, -r * c * mul * dscale / n, -c * (r * pxh_mean + r * mul * q / n),
                        -r * p_mean])
    return coef, r * q


def grad2_input_plain(g: torch.Tensor, x: torch.Tensor, u: torch.Tensor, stats: torch.Tensor,
                      bias: Optional[torch.Tensor], slope: Optional[float],
                      coef: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d/dg, d/dx)`` of the double backward over (R, C) rows, in g's and x's dtypes."""
    xf = x.to(_acc(x.dtype))
    m, r, mul, _ = stats
    z = _normalized(xf, stats, bias, x.dtype)
    gp = _through_act(g, z, slope)
    xh = (xf - m) * r
    uf = u.to(xf.dtype)
    inner = mul * uf + coef[0] * xh + coef[1]
    if slope is not None:
        inner = torch.where(z > 0, inner, inner * slope)
    gx = coef[2] * uf + r * coef[0] * gp + coef[3] * xh + coef[4]
    return inner.to(g.dtype), gx.to(x.dtype)


# ----------------------------------------------------------------- kernels


def kernel_map(t: torch.Tensor) -> bool:
    """Whether the kernels read the map ``t`` as it is: a bf16 channels-last
    (N, C, H, W) map with C % 8 == 0 and at least one element, 16-byte
    aligned. The one statement of the kernels' input contract:
    ``models/batchnorm.py`` routes by it and the op checks by it."""
    return (t.ndim == 4 and t.dtype == torch.bfloat16 and t.shape[1] % VEC == 0 and t.numel() > 0
            and t.is_contiguous(memory_format=torch.channels_last) and t.data_ptr() % 16 == 0)


def _check_map(t: torch.Tensor) -> None:
    if not kernel_map(t):
        raise ValueError(f"the kernels take a bf16 channels-last (N, C, H, W) map with C % {VEC} == 0 and at "
                         f"least one element, 16-byte aligned; got {t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """A gradient map as the kernels read it: copied into channels-last
    order where its layout or alignment is not theirs, then checked."""
    if not kernel_map(t):
        t = t.clone(memory_format=torch.channels_last)
    _check_map(t)
    return t


def _check_vector(name: str, t: Optional[torch.Tensor], x: torch.Tensor) -> None:
    if t is None:
        return
    if t.dtype != torch.float32 or t.device != x.device or tuple(t.shape) != (x.shape[1],) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 ({x.shape[1]},) tensor on {x.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _act(slope: Optional[float]) -> Tuple[float, int]:
    """The kernels' ``slope, act`` arguments: LeakyReLU(slope), or identity for None."""
    return (0.0, 0) if slope is None else (slope, 1)


def _tickets(c: int, device: torch.device) -> torch.Tensor:
    """A summing launch's tickets, one a channel tile (its launcher zeroes them on its stream)."""
    return torch.empty(tiles(c), dtype=torch.int32, device=device)


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = getattr(_build.library(), name)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(name, err)
    batch_norm_act.launches += 1


def _device(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernels (CUDA) or the plain versions (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_act runs on CUDA or CPU tensors, not {x.device}")
    return True


def _stats(x, scale, mean, var):
    if not _device(x):
        return stats_plain(x, scale, mean, var)
    for name, t in (("scale", scale), ("mean", mean), ("var", var)):
        _check_vector(name, t, x)
    rows, c = x.shape
    chunks, per = plan(rows, c, sums=True)
    part = torch.empty((chunks, 2, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    new_mean, new_var = torch.empty_like(mean), torch.empty_like(var)
    _launch("rnagan_batch_norm_stats", x.device, x.data_ptr(), _ptr(scale), mean.data_ptr(), var.data_ptr(),
            part.data_ptr(), _tickets(c, x.device).data_ptr(), stats.data_ptr(), new_mean.data_ptr(),
            new_var.data_ptr(), rows, c, chunks, per)
    return stats, new_mean, new_var


def _apply(x, stats, bias, slope):
    if not _device(x):
        return apply_plain(x, stats, bias, slope)
    _check_vector("bias", bias, x)
    rows, c = x.shape
    chunks, per = plan(rows, c, sums=False)
    y = torch.empty_like(x)
    _launch("rnagan_batch_norm_apply", x.device, x.data_ptr(), stats.data_ptr(), _ptr(bias), y.data_ptr(),
            rows, c, chunks, per, *_act(slope))
    return y


def _grad_sums(g, x, stats, bias, slope):
    if not _device(x):
        return grad_sums_plain(g, x, stats, bias, slope)
    rows, c = x.shape
    chunks, per = plan(rows, c, sums=True)
    part = torch.empty((chunks, 2, c), dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(dbias)
    _launch("rnagan_batch_norm_grad_sums", x.device, g.data_ptr(), x.data_ptr(), stats.data_ptr(), _ptr(bias),
            part.data_ptr(), _tickets(c, x.device).data_ptr(), dbias.data_ptr(), dscale.data_ptr(), rows, c, chunks,
            per, *_act(slope))
    return dbias, dscale


def _grad_input(g, x, stats, bias, slope, dbias, dscale):
    if not _device(x):
        return grad_input_plain(g, x, stats, bias, slope, dbias, dscale)
    rows, c = x.shape
    chunks, per = plan(rows, c, sums=False)
    dx = torch.empty_like(x)
    _launch("rnagan_batch_norm_grad_input", x.device, g.data_ptr(), x.data_ptr(), stats.data_ptr(), _ptr(bias),
            dbias.data_ptr(), dscale.data_ptr(), dx.data_ptr(), rows, c, chunks, per,
            *_act(slope))
    return dx


def _grad2_sums(g, x, u, stats, bias, slope, dbias, dscale, a, b):
    if not _device(x):
        return grad2_sums_plain(g, x, u, stats, bias, slope, dbias, dscale, a, b)
    for name, t in (("a", a), ("b", b)):
        _check_vector(name, t, x)
    rows, c = x.shape
    chunks, per = plan(rows, c, sums=True)
    part = torch.empty((chunks, 3, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((GRAD2_COEFS, c), dtype=torch.float32, device=x.device)
    dscale_grad = torch.empty(c, dtype=torch.float32, device=x.device)
    _launch("rnagan_batch_norm_grad2_sums", x.device, g.data_ptr(), x.data_ptr(), u.data_ptr(), stats.data_ptr(),
            _ptr(bias), dbias.data_ptr(), dscale.data_ptr(), _ptr(a), _ptr(b), part.data_ptr(),
            _tickets(c, x.device).data_ptr(), coef.data_ptr(), dscale_grad.data_ptr(), rows, c, chunks, per,
            *_act(slope))
    return coef, dscale_grad


def _grad2_input(g, x, u, stats, bias, slope, coef):
    if not _device(x):
        return grad2_input_plain(g, x, u, stats, bias, slope, coef)
    rows, c = x.shape
    chunks, per = plan(rows, c, sums=False)
    gg, gx = torch.empty_like(g), torch.empty_like(x)
    _launch("rnagan_batch_norm_grad2_input", x.device, g.data_ptr(), x.data_ptr(), u.data_ptr(), stats.data_ptr(),
            _ptr(bias), coef.data_ptr(), gg.data_ptr(), gx.data_ptr(), rows, c, chunks, per,
            *_act(slope))
    return gg, gx


# ----------------------------------------------------------------- autograd


class _BatchNormAct(torch.autograd.Function):
    """``(y, new_mean, new_var)``: the statistics and normalize stages; the backward is :class:`_BatchNormActGrad`."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, slope):
        stats, new_mean, new_var = _stats(rows_of(x), scale, mean, var)
        y = _apply(rows_of(x), stats, bias, slope)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.slope = slope
        ctx.mark_non_differentiable(new_mean, new_var)
        return _map_like(y, x), new_mean, new_var

    @staticmethod
    def backward(ctx, gy, _mean, _var):
        x, scale, bias, stats = ctx.saved_tensors
        dx, dscale, dbias = _BatchNormActGrad.apply(gy, x, scale, bias, stats, ctx.slope)
        return dx, None if scale is None else dscale, None if bias is None else dbias, None, None, None


class _BatchNormActGrad(torch.autograd.Function):
    """``(dx, dscale, dbias)`` from the output gradient ``g``: the two backward
    stages. Its own backward (the penalty's double backward) is the two
    double-backward stages: the gradients of g, x and scale for the
    cotangents of dx, dscale and dbias (none of bias: it reaches the
    backward only through the activation's mask)."""

    @staticmethod
    def forward(ctx, g, x, scale, bias, stats, slope):
        if g.is_cuda:
            g = _kernel_operand(g)
        gr, xr = rows_of(g), rows_of(x)
        dbias, dscale = _grad_sums(gr, xr, stats, bias, slope)
        dx = _grad_input(gr, xr, stats, bias, slope, dbias, dscale)
        ctx.save_for_backward(g, x, scale, bias, stats, dbias, dscale)
        ctx.slope = slope
        ctx.set_materialize_grads(False)
        return _map_like(dx, x), dscale, dbias

    @staticmethod
    def backward(ctx, u, a, b):
        g, x, scale, bias, stats, dbias, dscale = ctx.saved_tensors
        need_g, need_x, need_scale = ctx.needs_input_grad[:3]
        if u is None:
            u = torch.zeros_like(x)
        elif u.is_cuda:
            u = _kernel_operand(u)
        a, b = (None if t is None else t.to(dbias.dtype).contiguous() for t in (a, b))
        gr, xr, ur = rows_of(g), rows_of(x), rows_of(u)
        coef, dscale_grad = _grad2_sums(gr, xr, ur, stats, bias, ctx.slope, dbias, dscale, a, b)
        gg, gx = _grad2_input(gr, xr, ur, stats, bias, ctx.slope, coef)
        return (_map_like(gg, g) if need_g else None, _map_like(gx, x) if need_x else None,
                dscale_grad.to(scale.dtype) if need_scale and scale is not None else None, None, None, None)


def batch_norm_act(x: torch.Tensor, scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                   mean: torch.Tensor, var: torch.Tensor,
                   slope: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of an (N, C, H, W) map with flax's semantics,
    then LeakyReLU(``slope``) unless ``slope`` is None: ``(y, new_mean,
    new_var)``, ``y`` in x's dtype and memory format. ``scale``, ``bias``
    (either may be None) and the running ``mean``, ``var`` are (C,); on the
    card float32 beside an ``x`` that :func:`kernel_map` admits."""
    if x.ndim != 4:
        raise ValueError(f"batch_norm_act takes an (N, C, H, W) map; got {tuple(x.shape)}")
    if slope is not None and not math.isfinite(slope):
        raise ValueError(f"slope must be finite; got {slope}")
    if x.is_cuda:
        _check_map(x)
    return _BatchNormAct.apply(x, scale, bias, mean, var, slope)


batch_norm_act.launches = 0
