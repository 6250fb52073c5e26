"""K3, the port's Adam kernel, through its plain PyTorch version on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it bit-equal to
the plain version there). Here the plain version and the port's ``Adam`` are
held against the Pallas kernel they replace (``ops/fused_adam.py``, interpret
mode) and against ``optax.adam``, at rtol 1e-6 (the tolerance of
``tests/test_ops.py``): the host's float32 ``1 - b^t`` may differ from
``jnp.power`` by an ulp, and XLA may round ``(1-b2)*g*g`` in another order.
``AdamW`` (K3 with its decoupled decay) is held to ``optax.adamw`` the same
way, and with ``weight_decay=0`` bit-equal to ``Adam``.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnagan_tpu.ops.fused_adam import adam_update_flat
from rnagan_tpu_torch.kernels.fused_adam import MAX_TENSORS, adam_update_plain, fused_adam
from rnagan_tpu_torch.optim.adam import Adam, AdamW, bias_corrections

LR, B1, B2, EPS = 1e-4, 0.5, 0.999, 1e-8
#: a model's mix: conv kernels, BN vectors, and tensors of 1 and 3 elements
SHAPES = [(16, 8, 4, 4), (8,), (8,), (3,), (1,), (8, 3, 4, 4), (1000,)]


def _state(rng, shapes=SHAPES):
    """p, g, mu, nu as a step-5 state holds them: nu >> (1-b2)*g^2, so the
    update is no longer the sign(g)*lr of a first step."""
    draw = lambda scale: [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]  # noqa: E731
    nu = [(rng.rand(*s) * 1e-5 + 1e-6).astype(np.float32) for s in shapes]
    return draw(0.1), draw(1e-3), draw(1e-3), nu


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a.copy()).to(dtype) for a in arrays]


def _flat(arrays):
    return jnp.asarray(np.concatenate([a.ravel() for a in arrays]))


def _split(flat, shapes=SHAPES):
    out, i = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(np.asarray(flat[i:i + n]).reshape(s))
        i += n
    return out


def _close(got, ref, rtol=1e-6, atol=0.0):
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", [0, 5, 40])
def test_plain_matches_pallas_kernel(rng, step):
    p, g, mu, nu = _state(rng)
    with pltpu.force_tpu_interpret_mode():
        rp, rmu, rnu = adam_update_flat(_flat(p), _flat(g), _flat(mu), _flat(nu), jnp.asarray(step),
                                        lr=LR, b1=B1, b2=B2, eps=EPS)
    tp, tg, tmu, tnu = _torch(p), _torch(g), _torch(mu), _torch(nu)
    c1, c2 = bias_corrections(step + 1, B1, B2)
    fused_adam(tp, tg, tmu, tnu, c1=c1, c2=c2, lr=LR, b1=B1, b2=B2, eps=EPS)  # CPU: the plain version
    _close(tp, _split(rp))
    _close(tmu, _split(rmu))
    _close(tnu, _split(rnu))


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adam_matches_optax_from_step_5(rng, mu_dtype):
    """``Adam.step`` from a count-5 state against ``optax.adam`` (with its
    ``mu_dtype``), two steps: params, mu, nu and the count."""
    p, g, mu, nu = _state(rng)
    jdt = jnp.bfloat16 if mu_dtype else jnp.float32
    tx = optax.adam(LR, b1=B1, b2=B2, eps=EPS, mu_dtype=jdt if mu_dtype else None)
    params = [jnp.asarray(a) for a in p]
    st = tx.init(params)
    st = (st[0]._replace(count=jnp.asarray(5, jnp.int32), mu=[jnp.asarray(a, jdt) for a in mu],
                         nu=[jnp.asarray(a) for a in nu]),) + tuple(st[1:])
    tdt = torch.bfloat16 if mu_dtype else torch.float32
    opt = Adam(_torch(p), lr=LR, b1=B1, b2=B2, eps=EPS, mu_dtype=tdt)
    opt.mu = [torch.from_numpy(np.array(m, np.float32)).to(tdt) for m in st[0].mu]
    opt.nu = _torch(nu)
    opt.count = 5
    tp = _torch(p)
    for k in range(2):
        grads = [a * (k + 1) for a in g]
        upd, st = tx.update([jnp.asarray(a) for a in grads], st, params)
        params = optax.apply_updates(params, upd)
        opt.step(tp, _torch(grads))
    assert opt.count == int(st[0].count) == 7
    assert all(m.dtype == tdt for m in opt.mu)
    _close(tp, params)
    # a bf16 mu is rounded from nearly equal float32 values: one bf16 ulp apart at most
    _close(opt.mu, st[0].mu, rtol=1e-6 if mu_dtype is None else 2**-7)
    _close(opt.nu, st[0].nu)


def test_adam_matches_optax_from_zero(rng):
    """Three steps from a fresh state: the first is sign(g)*lr, and the bias
    corrections of t = 1, 2, 3 enter one after another."""
    p, g, _, _ = _state(rng)
    tx = optax.adam(LR, b1=B1, b2=B2, eps=EPS)
    params = [jnp.asarray(a) for a in p]
    st = tx.init(params)
    opt = Adam(_torch(p), lr=LR, b1=B1, b2=B2, eps=EPS)
    tp = _torch(p)
    for _ in range(3):
        upd, st = tx.update([jnp.asarray(a) for a in g], st, params)
        params = optax.apply_updates(params, upd)
        opt.step(tp, _torch(g))
    # the first update is +-lr: one ulp of it (1.5e-11) on a weight near 0 is a large relative error
    _close(tp, params, atol=1e-10)
    _close(opt.mu, st[0].mu)
    _close(opt.nu, st[0].nu)


def test_bias_corrections_match_jnp_power():
    for t in (1, 2, 6, 100, 5000):
        ref = [1.0 - jnp.power(jnp.float32(b), jnp.float32(t)) for b in (B1, B2)]
        np.testing.assert_allclose(bias_corrections(t, B1, B2), np.asarray(ref), rtol=1e-6)


def test_state_dict_is_torch_adam_layout(rng):
    """``Adam.state_dict`` loads into ``torch.optim.Adam``, whose next step
    agrees with the port's (torch rounds in another order: rtol 1e-5), and
    reads back into ``Adam`` unchanged."""
    p, g, mu, nu = _state(rng)
    opt = Adam(_torch(p), lr=LR, b1=B1, b2=B2, eps=EPS)
    opt.mu, opt.nu, opt.count = _torch(mu), _torch(nu), 5
    sd = opt.state_dict()
    params = [torch.nn.Parameter(t) for t in _torch(p)]
    ref = torch.optim.Adam(params, lr=LR, betas=(B1, B2), eps=EPS)
    ref.load_state_dict(sd)
    for q, a in zip(params, g):
        q.grad = torch.from_numpy(a)
    ref.step()
    tp = _torch(p)
    opt.step(tp, _torch(g))
    for got, want in zip(tp, params):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-9)
    back = Adam(_torch(p), lr=LR, b1=B1, b2=B2, eps=EPS, mu_dtype=torch.bfloat16)
    back.load_state_dict(opt.state_dict())
    assert back.count == 6 and back.mu[0].dtype == torch.bfloat16
    assert torch.equal(back.nu[3], opt.nu[3])


def test_plain_version_is_in_place_and_keeps_mu_dtype(rng):
    p, g, mu, nu = _state(rng)
    tp, tmu = _torch(p), _torch(mu, torch.bfloat16)
    before = [t.clone() for t in tp]
    adam_update_plain(tp, _torch(g), tmu, _torch(nu), 0.9, 0.1, LR, B1, B2, EPS)
    assert all(m.dtype == torch.bfloat16 for m in tmu)
    assert all(not torch.equal(a, b) for a, b in zip(tp, before))


def test_empty_tensor_and_table_size(rng):
    """A 0-element tensor is taken; more tensors than one launch's table are refused."""
    shapes = [(3,), (0,), (5,)]
    p, g, mu, nu = _state(rng, shapes)
    tp = _torch(p)
    fused_adam(tp, _torch(g), _torch(mu), _torch(nu), c1=0.5, c2=0.01, lr=LR, b1=B1, b2=B2, eps=EPS)
    ref = _torch(p)
    adam_update_plain(ref, _torch(g), _torch(mu), _torch(nu), 0.5, 0.01, LR, B1, B2, EPS)
    assert all(torch.equal(a, b) for a, b in zip(tp, ref))
    many = [torch.zeros(2) for _ in range(MAX_TENSORS + 1)]
    with pytest.raises(ValueError, match="at most"):
        fused_adam(many, many, many, many, c1=0.5, c2=0.01, lr=LR, b1=B1, b2=B2, eps=EPS)


@pytest.mark.parametrize("case", ["lengths", "dtype", "mu_dtype", "contiguous", "mixed_mu", "empty"])
def test_fused_adam_rejects_bad_arguments(case):
    p, g, mu, nu = [torch.zeros(4)], [torch.zeros(4)], [torch.zeros(4)], [torch.zeros(4)]
    if case == "lengths":
        g = [torch.zeros(5)]
    elif case == "dtype":
        nu = [torch.zeros(4, dtype=torch.float64)]
    elif case == "mu_dtype":
        mu = [torch.zeros(4, dtype=torch.float16)]
    elif case == "contiguous":
        g = [torch.zeros(4, 2).t()[0]]
    elif case == "mixed_mu":
        p, g, nu = p * 2, g * 2, nu * 2
        mu = [torch.zeros(4), torch.zeros(4, dtype=torch.bfloat16)]
    else:
        p, g, mu, nu = [], [], [], []
    with pytest.raises(ValueError):
        fused_adam(p, g, mu, nu, c1=0.5, c2=0.1, lr=LR, b1=B1, b2=B2, eps=EPS)


def test_fused_adam_takes_cpu_or_cuda_only():
    t = [torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_adam(t, t, t, t, c1=0.5, c2=0.1, lr=LR, b1=B1, b2=B2, eps=EPS)


def _adamw_pair(p, mu, nu, count, wd, lr=3e-5):
    """``optax.adamw`` at ``count`` with the given moments, and the port's
    ``AdamW`` in the same state."""
    tx = optax.adamw(lr, weight_decay=wd)
    params = [jnp.asarray(a) for a in p]
    st = tx.init(params)
    if count:
        st = (st[0]._replace(count=jnp.asarray(count, jnp.int32), mu=[jnp.asarray(a) for a in mu],
                             nu=[jnp.asarray(a) for a in nu]),) + tuple(st[1:])
    opt = AdamW(_torch(p), lr, weight_decay=wd)
    if count:
        opt.mu, opt.nu, opt.count = _torch(mu), _torch(nu), count
    return tx, params, st, opt


@pytest.mark.parametrize("count", [0, 5])
@pytest.mark.parametrize("wd", [0.01, 1e-6])
def test_adamw_matches_optax(rng, count, wd):
    """``AdamW`` (K3's plain version on the CPU) against ``optax.adamw``,
    three steps from a fresh state and from a count-5 one, at the ML
    experiment's rate and decay (0.01) and SimCLR's decay (1e-6)."""
    p, g, mu, nu = _state(rng)
    tx, params, st, opt = _adamw_pair(p, mu, nu, count, wd)
    tp = _torch(p)
    for k in range(3):
        grads = [a * (k + 1) for a in g]
        upd, st = tx.update([jnp.asarray(a) for a in grads], st, params)
        params = optax.apply_updates(params, upd)
        opt.step(tp, _torch(grads))
    assert opt.count == int(st[0].count) == count + 3
    # from count 0 the first update is +-lr: one ulp of it on a weight near 0 is a large relative error
    _close(tp, params, atol=1e-12 if count else 3e-12)
    _close(opt.mu, st[0].mu)
    _close(opt.nu, st[0].nu)


def test_adamw_without_decay_is_adam_bit_for_bit(rng):
    p, g, mu, nu = _state(rng)
    a, w = Adam(_torch(p), lr=LR, b1=B1, b2=B2, eps=EPS), AdamW(_torch(p), LR, 0.0, b1=B1, b2=B2, eps=EPS)
    for opt in (a, w):
        opt.mu, opt.nu, opt.count = _torch(mu), _torch(nu), 5
    ta, tw = _torch(p), _torch(p)
    for _ in range(2):
        a.step(ta, _torch(g))
        w.step(tw, _torch(g))
    for x, y in zip([*ta, *a.mu, *a.nu], [*tw, *w.mu, *w.nu]):
        assert torch.equal(x, y)


def test_plain_decay_is_a_separate_rounding(rng):
    """With ``wd`` the plain version adds ``p * wd`` to the rounded Adam update,
    then scales by the rate: ``p - lr * (u + wd * p)``, each op rounded alone."""
    p, g, mu, nu = _state(rng, [(257,)])
    tp, tmu, tnu = _torch(p), _torch(mu), _torch(nu)
    p0 = tp[0].clone()
    adam_update_plain(tp, _torch(g), tmu, tnu, 0.9, 0.1, LR, B1, B2, EPS, wd=0.01)
    c1, c2 = torch.tensor(0.9), torch.tensor(0.1)
    u = (tmu[0] / c1) / (torch.sqrt(tnu[0] / c2) + EPS)
    assert torch.equal(tp[0], p0 - (u + p0 * 0.01) * LR)


def test_adamw_state_dict_is_torch_adamw_layout(rng):
    """``AdamW.state_dict`` loads into ``torch.optim.AdamW`` (its decay is
    ``p * (1 - lr * wd)`` first, which rounds otherwise: rtol 1e-5) and reads
    back unchanged."""
    p, g, mu, nu = _state(rng)
    opt = AdamW(_torch(p), LR, 0.01, b1=B1, b2=B2, eps=EPS)
    opt.mu, opt.nu, opt.count = _torch(mu), _torch(nu), 5
    sd = opt.state_dict()
    assert sd["param_groups"][0]["weight_decay"] == 0.01
    params = [torch.nn.Parameter(t) for t in _torch(p)]
    ref = torch.optim.AdamW(params, lr=LR, betas=(B1, B2), eps=EPS, weight_decay=0.01)
    ref.load_state_dict(sd)
    for q, a in zip(params, g):
        q.grad = torch.from_numpy(a)
    ref.step()
    tp = _torch(p)
    opt.step(tp, _torch(g))
    for got, want in zip(tp, params):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-9)
    back = AdamW(_torch(p), LR, 0.01)
    back.load_state_dict(opt.state_dict())
    assert back.count == 6 and all(torch.equal(x, y) for x, y in zip(back.mu, opt.mu))


def test_one_launch_takes_resnet152(rng):
    """ResNet152's 467 tensors fit one launch's table (512 rows)."""
    from rnagan_tpu_torch.models.resnet import resnet152

    shapes = [tuple(q.shape) for q in resnet152(num_classes=2, device="meta").parameters()]
    assert len(shapes) == 467 <= MAX_TENSORS
    small = [(int(np.prod(s)) % 7 + 1,) for s in shapes]  # the count, not the size, is the point
    p, g, mu, nu = _state(rng, small)
    tp, ref = _torch(p), _torch(p)
    fused_adam(tp, _torch(g), _torch(mu), _torch(nu), c1=0.5, c2=0.01, lr=LR, b1=B1, b2=B2, eps=EPS, wd=0.01)
    adam_update_plain(ref, _torch(g), _torch(mu), _torch(nu), 0.5, 0.01, LR, B1, B2, EPS, 0.01)
    assert all(torch.equal(a, b) for a, b in zip(tp, ref))
