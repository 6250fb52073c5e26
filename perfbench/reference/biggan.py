"""The published BigGAN (the port's arch ``biggan_pub``) as plain float32 functions.

The equations of the authors' code (github.com/ajbrock/BigGAN-PyTorch,
``BigGAN.py``'s ``G_arch``/``D_arch`` and ``layers.py``'s ``SN``, ``ccbn``,
``bn``, ``Attention``, ``GBlock``, ``DBlock``), written out over parameter
dicts keyed by the port's state_dict names, so one set of weights loads into
the program and feeds these functions. With ``ch = step_channels``:

* generator: ``shared`` class embedding; z split into chunks of
  ``encoding_dims // (blocks + 1)`` (``torch.split``: a remainder feeds
  nothing); ``linear`` on chunk 0 viewed NCHW ``(N, -1, 4, 4)``; blocks
  ``h = conv1(up2(relu(ccbn1(x, c)))); h = conv2(relu(ccbn2(h, c))); h +
  conv_sc(up2(x))`` with ``c = [shared(y), chunk i+1]``; attention after the
  block at ``attn_size``; ``tanh(output_conv(relu(output_bn(h))))``;
* discriminator: blocks ``conv2(relu(conv1(pre(x))))`` pooled where the table
  pools, shortcut ``conv_sc`` then the pool (pre-activated blocks) or the
  pool then ``conv_sc`` (block 0), the identity where neither the width
  changes nor the block pools; attention after the block at ``attn_size``;
  ``linear(sum_hw relu(h)) + <embed(y), sum_hw relu(h)>``;
* every convolution, linear map, ``ccbn`` gain and bias and the critic's
  ``embed`` spectrally normalized by ``layers.SN``'s one power iteration on
  ``weight.view(out, -1)`` (``F.normalize``, eps 1e-12), ``u`` updated in
  train mode, ``sigma`` differentiated through the weight.

Departures from the published code, each the port's as its module states:
BatchNorm keeps flax's statistics (``nets.py``: the biased batch variance,
momentum 0.9 on the old value), and the state (running statistics and each
``u``) is returned as new values, never written in place. ``q`` rounds the
operands of every convolution, linear map and attention product (the
lower-precision control), as in ``nets.py``. Imports nothing of the port.

:func:`specs` lists the parameters and the state; :func:`weights` draws the
published initialization from a seed (orthogonal weights, zero biases,
``output_bn`` scale 1, attention's ``gamma`` 0, ``u`` standard normal;
running statistics mean 0, variance 1).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.nets import BN_EPS, MOMENTUM, Round, identity

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]

SN_EPS = 1e-12
#: ``G_arch``: out_size -> (in, out) channel multiples of ``ch`` a block, each block doubling the map from 4x4
G_ARCH = {32: ((4, 4), (4, 4), (4, 4)),
          64: ((16, 16), (16, 8), (8, 4), (4, 2)),
          256: ((16, 16), (16, 8), (8, 8), (8, 4), (4, 2), (2, 1))}
#: ``D_arch``: out_size -> (in, out, pools, resolution) a block; in 0 stands for the image's channels
D_ARCH = {32: ((0, 4, True, 16), (4, 4, True, 16), (4, 4, False, 16), (4, 4, False, 16)),
          64: ((0, 1, True, 32), (1, 2, True, 16), (2, 4, True, 8), (4, 8, True, 4), (8, 16, False, 4)),
          256: ((0, 1, True, 128), (1, 2, True, 64), (2, 4, True, 32), (4, 8, True, 16), (8, 8, True, 8),
                (8, 16, True, 4), (16, 16, False, 4))}


def chunk(m: dict) -> int:
    return m["encoding_dims"] // (len(G_ARCH[m["out_size"]]) + 1)


def attention_widths(c: int) -> Tuple[int, int]:
    """theta's and phi's width, g's width (the port floors both at 1 for tiny nets)."""
    return max(c // 8, 1), max(c // 2, 1)


def g_blocks(m: dict) -> List[Tuple[int, int, int, bool]]:
    """(in channels, out channels, output resolution, attention after) of each generator block."""
    ch, out, size = m["step_channels"], [], 4
    for cin, cout in G_ARCH[m["out_size"]]:
        size *= 2
        out.append((cin * ch, cout * ch, size, size == m["attn_size"]))
    return out


def d_blocks(m: dict) -> List[Tuple[int, int, bool, int, bool]]:
    """(in channels, out channels, pools, input resolution, attention after) of each critic block."""
    ch, out, size = m["step_channels"], [], m["out_size"]
    for i, (cin, cout, pools, res) in enumerate(D_ARCH[m["out_size"]]):
        out.append((cin * ch if i else m["out_channels"], cout * ch, pools, size, res == m["attn_size"]))
        size //= 2 if pools else 1
    return out


def specs(m: dict) -> Tuple[list, list]:
    """``(params, state)`` of both nets in module order: params ``(net,
    name, shape, kind)``, kinds ``ortho`` (an orthogonal weight), ``bias``,
    ``bn_scale``, ``zero`` (a BatchNorm bias, attention's gamma); state
    ``(net, prefix, kind, width)``, kinds ``bn`` (running statistics) and
    ``sn`` (``u`` of a spectrally normalized weight with ``width`` rows)."""
    params, state = [], []

    def sn(net, prefix, shape, bias=True):
        params.append((net, prefix + "weight", shape, "ortho"))
        if bias:
            params.append((net, prefix + "bias", (shape[0],), "bias"))
        state.append((net, prefix, "sn", shape[0]))

    def attention(net, prefix, c):
        qk, v = attention_widths(c)
        for name, shape in (("theta", (qk, c)), ("phi", (qk, c)), ("g", (v, c)), ("o", (c, v))):
            sn(net, f"{prefix}{name}.", (*shape, 1, 1), bias=False)
        params.append((net, prefix + "gamma", (), "zero"))

    cond = m["embed_dim"] + chunk(m)
    params.append(("G", "shared.weight", (m["num_classes"], m["embed_dim"]), "ortho"))
    blocks = g_blocks(m)
    sn("G", "linear.", (blocks[0][0] * 16, chunk(m)))
    for i, (cin, cout, _, attn) in enumerate(blocks):
        pre = f"blocks.{i}.0."
        for bn, c, conv, shape in (("bn1.", cin, "conv1.", (cout, cin, 3, 3)),
                                   ("bn2.", cout, "conv2.", (cout, cout, 3, 3))):
            state.append(("G", pre + bn + "bn.", "bn", c))
            sn("G", pre + bn + "gain.", (c, cond), bias=False)
            sn("G", pre + bn + "bias.", (c, cond), bias=False)
            sn("G", pre + conv, shape)
        sn("G", pre + "conv_sc.", (cout, cin, 1, 1))
        if attn:
            attention("G", f"blocks.{i}.1.", cout)
    last = blocks[-1][1]
    params += [("G", "output_bn.weight", (last,), "bn_scale"), ("G", "output_bn.bias", (last,), "zero")]
    state.append(("G", "output_bn.", "bn", last))
    sn("G", "output_conv.", (m["out_channels"], last, 3, 3))
    for i, (cin, cout, pools, _, attn) in enumerate(d_blocks(m)):
        pre = f"blocks.{i}.0."
        sn("D", pre + "conv1.", (cout, cin, 3, 3))
        sn("D", pre + "conv2.", (cout, cout, 3, 3))
        if cin != cout or pools:
            sn("D", pre + "conv_sc.", (cout, cin, 1, 1))
        if attn:
            attention("D", f"blocks.{i}.1.", cout)
    width = d_blocks(m)[-1][1]
    sn("D", "linear.", (1, width))
    sn("D", "embed.", (m["num_classes"], width), bias=False)
    return params, state


def state_names(m: dict) -> List[str]:
    """The compared state's names: each BatchNorm's running mean and variance and each ``u``, ``G.``/``D.`` first."""
    out = []
    for net, prefix, kind, _ in specs(m)[1]:
        leaves = ("running_mean", "running_var") if kind == "bn" else ("sn_u",)
        out += [f"{net}.{prefix}{leaf}" for leaf in leaves]
    return out


def weights(m: dict, seed: int, device) -> Dict[str, Params]:
    """``{"G": state_dict, "D": state_dict}`` (parameters and buffers) of the
    published initialization, drawn in ``specs`` order from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, Params] = {"G": {}, "D": {}}
    for net, name, shape, kind in specs(m)[0]:
        t = torch.empty(shape, device=device)
        if kind == "ortho":
            torch.nn.init.orthogonal_(t, generator=gen)
        else:
            t.fill_(1.0 if kind == "bn_scale" else 0.0)
        out[net][name] = t
    for net, prefix, kind, width in specs(m)[1]:
        sd = out[net]
        if kind == "bn":
            sd[prefix + "running_mean"] = torch.zeros(width, device=device)
            sd[prefix + "running_var"] = torch.ones(width, device=device)
            sd[prefix + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            sd[prefix + "sn_u"] = torch.empty((1, width), device=device).normal_(generator=gen)
            sd[prefix + "sn_sigma"] = torch.ones((), device=device)
    return out


# ------------------------------------------------------------------ layers


class _Net:
    """One forward's parameters, incoming state, new state, mode and rounding."""

    def __init__(self, p: Params, state: State, train: bool, q: Round):
        self.p, self.state, self.train, self.q = p, state, train, q
        self.new: State = {}

    def sn(self, prefix: str) -> torch.Tensor:
        """``layers.SN.W_()``: the weight over its largest singular value's estimate."""
        w = self.p[prefix + "weight"]
        mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = F.normalize(self.state[prefix + "sn_u"] @ mat, eps=SN_EPS)
            u = F.normalize(v @ mat.t(), eps=SN_EPS)
        if self.train:
            self.new[prefix + "sn_u"] = u
        return w / torch.squeeze((v @ mat.t()) @ u.t())

    def conv(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        w = self.sn(prefix)
        return F.conv2d(self.q(x), self.q(w), self.p.get(prefix + "bias"), padding=w.shape[-1] // 2)

    def linear(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.q(x), self.q(self.sn(prefix)), self.p.get(prefix + "bias"))

    def bn(self, prefix: str, x: torch.Tensor, scale=None, bias=None) -> torch.Tensor:
        """flax's BatchNorm (``nets.bn_train``/``bn_eval``), with or without scale and bias."""
        mean, var = self.state[prefix + "running_mean"], self.state[prefix + "running_var"]
        if self.train:
            m = x.mean((0, 2, 3))
            v = torch.clamp((x * x).mean((0, 2, 3)) - m * m, min=0.0)
            self.new[prefix + "running_mean"] = (MOMENTUM * mean + (1.0 - MOMENTUM) * m).detach()
            self.new[prefix + "running_var"] = (MOMENTUM * var + (1.0 - MOMENTUM) * v).detach()
        else:
            m, v = mean, var
        mul = torch.rsqrt(v + BN_EPS)
        if scale is not None:
            mul = mul * scale
        y = (x - m[None, :, None, None]) * mul[None, :, None, None]
        return y if bias is None else y + bias[None, :, None, None]

    def ccbn(self, prefix: str, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        gain = self.linear(prefix + "gain.", c)[:, :, None, None]
        bias = self.linear(prefix + "bias.", c)[:, :, None, None]
        return self.bn(prefix + "bn.", x) * (1.0 + gain) + bias

    def attention(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        """``layers.Attention``: 1x1 theta, phi, g and o; phi and g 2x2 max-pooled; gamma from 0."""
        n, c, h, w = x.shape
        qk, cv = attention_widths(c)
        theta = self.conv(prefix + "theta.", x).view(n, qk, h * w)
        phi = F.max_pool2d(self.conv(prefix + "phi.", x), 2).view(n, qk, h * w // 4)
        g = F.max_pool2d(self.conv(prefix + "g.", x), 2).view(n, cv, h * w // 4)
        beta = F.softmax(torch.bmm(self.q(theta).transpose(1, 2), self.q(phi)), -1)
        o = self.conv(prefix + "o.", torch.bmm(self.q(g), self.q(beta).transpose(1, 2)).view(n, cv, h, w))
        return x + self.p[prefix + "gamma"] * o

    def result(self) -> State:
        return {**self.state, **self.new}


def up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def generator(p: Params, state: State, z: torch.Tensor, labels: torch.Tensor, train: bool, m: dict,
              q: Round = identity) -> Tuple[torch.Tensor, State]:
    """z (N, encoding_dims), labels (N,) -> images (N, C, H, W) in [-1, 1] and the new state."""
    net = _Net(p, state, train, q)
    zs = torch.split(z, chunk(m), 1)
    y = F.embedding(labels, p["shared.weight"])
    h = net.linear("linear.", zs[0])
    h = h.view(h.shape[0], -1, 4, 4)
    for i, (_, _, _, attn) in enumerate(g_blocks(m)):
        pre, c = f"blocks.{i}.0.", torch.cat([y, zs[i + 1]], 1)
        x = h
        h = net.conv(pre + "conv1.", up2(F.relu(net.ccbn(pre + "bn1.", x, c))))
        h = net.conv(pre + "conv2.", F.relu(net.ccbn(pre + "bn2.", h, c)))
        h = h + net.conv(pre + "conv_sc.", up2(x))
        if attn:
            h = net.attention(f"blocks.{i}.1.", h)
    h = F.relu(net.bn("output_bn.", h, p["output_bn.weight"], p["output_bn.bias"]))
    return torch.tanh(net.conv("output_conv.", h)), net.result()


def discriminator(p: Params, state: State, x: torch.Tensor, labels: torch.Tensor, train: bool, m: dict,
                  q: Round = identity) -> Tuple[torch.Tensor, State]:
    """images (N, C, H, W), labels (N,) -> scores (N,) and the new state."""
    net = _Net(p, state, train, q)
    h = x
    for i, (cin, cout, pools, _, attn) in enumerate(d_blocks(m)):
        pre, x = f"blocks.{i}.0.", h
        pool = (lambda t: F.avg_pool2d(t, 2)) if pools else (lambda t: t)  # noqa: E731
        h = net.conv(pre + "conv1.", F.relu(x) if i else x)
        h = pool(net.conv(pre + "conv2.", F.relu(h)))
        if cin == cout and not pools:
            h = h + x
        elif i:
            h = h + pool(net.conv(pre + "conv_sc.", x))
        else:
            h = h + net.conv(pre + "conv_sc.", pool(x))
        if attn:
            h = net.attention(f"blocks.{i}.1.", h)
    h = torch.sum(F.relu(h), [2, 3])
    out = net.linear("linear.", h)[:, 0]
    emb = F.embedding(labels, net.sn("embed."))
    return out + torch.sum(q(emb) * q(h), 1), net.result()
