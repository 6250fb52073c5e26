"""The port's β-VAE training slice against the JAX package on the CPU.

Both packages get the same weights (numpy trees in the flax layout, moved by
``rnagan_tpu_torch.convert``), the same data and the same random draws: the
JAX side's dropout mask and reparametrization ``eps`` are replaced through
``flax.linen.intercept_methods`` (the JAX package is not touched), and the
port takes them as ``draws``. Train steps start from a JAX state advanced 5
steps (Adam's ``nu`` far above ``(1-b2)*g^2``, so an update is smooth in the
gradient), on a one-device mesh, at float32.

Tolerances: train-mode forward and BatchNorm statistics 1e-5 relative plus
1e-6 of the tensor's largest value (bfloat16: 2e-2 plus 4e-2, roundings of
2^-8 compounding through the stack); a step's losses 1e-5 relative;
parameters and statistics 1e-5 relative plus 1e-6 of each tensor's largest
value, optimizer moments 1e-5 plus 1e-5 (XLA and PyTorch sum the gradients
in other orders, and small elements come from cancelling sums); steps and
counts exactly. The data
layer matches the JAX package's pandas path exactly, or to 1e-12 where
pandas' own float parser reads the CSV.
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from flax import linen as nn
from flax import serialization
from test_torch_port_parity import jax_vae_variables

from rnagan_tpu.core import config as jcfg
from rnagan_tpu.data import batching as jbatching
from rnagan_tpu.data import rna as jrna
from rnagan_tpu.eval import interpolate as jinterp
from rnagan_tpu.eval import sample as jsample
from rnagan_tpu.losses import vae as jloss
from rnagan_tpu.models.betavae import BetaVAE as JaxBetaVAE
from rnagan_tpu.parallel.mesh import make_mesh
from rnagan_tpu.train import schedules as jsched
from rnagan_tpu.train.vae_trainer import VAETrainer as JaxVAETrainer
from rnagan_tpu.train.vae_trainer import VAETrainState as JaxVAEState
from rnagan_tpu.train.vae_trainer import _masked_losses
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.cli import betavae_train
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.core.checkpoint import BestKeeper
from rnagan_tpu_torch.core.metrics import MetricsLogger
from rnagan_tpu_torch.data import batching as tbatching
from rnagan_tpu_torch.data import rna as trna
from rnagan_tpu_torch.eval import interpolate as tinterp
from rnagan_tpu_torch.eval import sample as tsample
from rnagan_tpu_torch.losses import vae as tloss
from rnagan_tpu_torch.models import betavae as tbetavae
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.train import schedules as tsched
from rnagan_tpu_torch.train.gan_trainer import GANTrainer
from rnagan_tpu_torch.train.vae_trainer import VAETrainer

F32 = np.float32
MODEL_KW = dict(rna_features=64, z_dim=16, encoder_dims=(48, 32, 16), decoder_dims=(32, 48))
N = 8  # batch
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.detach().float().cpu().numpy()


def _models(**kw):
    kw = {**MODEL_KW, **kw}
    return jcfg.VAEModelConfig(**kw), tcfg.VAEModelConfig(**kw)


def _cfgs(model_kw=None, **kw):
    jm, tm = _models(**(model_kw or {}))
    base = {**dict(lr=1e-3, batch_size=N, warmup_steps=6, cosine_steps=3), **kw}
    return (jcfg.VAEConfig(model=jm, mesh=jcfg.MeshConfig(data=1, model=1), **base),
            tcfg.VAEConfig(model=tm, **base))


def _port_vae(tm, variables):
    vae = BetaVAE(tm)
    vae.load_state_dict(convert.betavae_state_dict_from_jax(tm, variables))
    return vae


def _interceptor(keep=None, eps=None):
    """Replace flax's dropout mask with ``keep`` and ``reparametrize``'s
    draw with ``eps`` (either may be None: that draw is left to flax)."""
    def icpt(next_fun, args, kwargs, context):
        if keep is not None and isinstance(context.module, nn.Dropout):
            x = args[0]
            return jax.lax.select(keep, x / (1.0 - context.module.rate), jnp.zeros_like(x))
        if eps is not None and isinstance(context.module, JaxBetaVAE) and context.method_name == "reparametrize":
            z_mean, z_logvar = args
            return z_mean + eps * jnp.exp(0.5 * z_logvar)
        return next_fun(*args, **kwargs)
    return icpt


def _close(got, ref, rtol=1e-5, scaled=1e-6, atol=0.0, msg=""):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, msg
    bound = atol + (scaled * float(np.abs(ref).max()) if ref.size else 0.0)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=bound, err_msg=msg)


def _close_trees(got, ref, **kw):
    """Leaf by leaf over two trees of one structure (flax state-dict form)."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    jax.tree_util.tree_map_with_path(
        lambda path, g, r: _close(g, r, msg=jax.tree_util.keystr(path), **kw), got, ref)


def _close_state(got, ref):
    """Two ``VAETrainState``s in flax's state-dict form: the step exactly;
    parameters and statistics 1e-5 relative + 1e-6 of each tensor's largest
    value; optimizer moments 1e-5 + 1e-5 (their small elements come from
    cancelling sums); counts exactly."""
    assert int(got["step"]) == int(ref["step"])
    _close_trees(got["params"], ref["params"])
    _close_trees(got["batch_stats"], ref["batch_stats"])
    _close_trees(got["opt_state"], ref["opt_state"], scaled=1e-5)


def _stats_list(tree):
    return [(tree[side][name]["mean"], tree[side][name]["var"])
            for side in ("encoder", "decoder") for name in sorted(tree[side])]


def _port_stats(vae):
    return [(m.running_mean, m.running_var) for m in vae.modules() if isinstance(m, torch.nn.BatchNorm1d)]


# -------------------------------------------------------- train-mode forward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_forward_and_stats_match_flax(rng, dtype):
    """Encode and decode in train mode (dropout off): outputs and the
    running statistics against flax's updated ``batch_stats`` (momentum 0.9,
    biased variance, reduced in float32). bfloat16 trains too."""
    jm, tm = _models(dropout_rate=0.0, compute_dtype=dtype)
    variables = jax_vae_variables(jm, seed=1)
    x = (rng.randn(6, 64) * 2 + 0.5).astype(F32)
    model = JaxBetaVAE(jm)
    (mu, lv, enc), upd = model.apply(variables, jnp.asarray(x), train=True, method=JaxBetaVAE.encode,
                                     mutable=["batch_stats"])
    dec, upd2 = model.apply({"params": variables["params"], "batch_stats": upd["batch_stats"]}, mu,
                            train=True, method=JaxBetaVAE.decode, mutable=["batch_stats"])
    vae = _port_vae(tm, variables).train()
    t_mu, t_lv, t_enc = vae.encode(torch.from_numpy(x))
    t_dec = vae.decode(torch.from_numpy(np.array(mu)))
    # bfloat16: roundings of 2^-8 compound through the stack; 4e-2 of the
    # tensor's largest value
    tol = dict(rtol=1e-5, scaled=1e-6) if dtype == "float32" else dict(rtol=2e-2, scaled=4e-2)
    for got, ref in ((t_mu, mu), (t_lv, lv), (t_enc, enc), (t_dec, dec)):
        _close(_np(got), np.asarray(ref, F32), **tol)
    assert t_mu.dtype == torch.float32 and t_enc.dtype == vae._dt
    ref_stats = (_stats_list({"encoder": upd["batch_stats"]["encoder"], "decoder": {}})
                 + _stats_list({"encoder": {}, "decoder": upd2["batch_stats"]["decoder"]}))
    for (gm, gv), (rm, rv) in zip(_port_stats(vae), ref_stats, strict=True):
        _close(_np(gm), rm, **tol)
        _close(_np(gv), rv, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_with_given_draws_matches_flax(rng, dtype):
    """The whole train-mode forward with dropout 0.5: the given mask and eps
    on the port, the same ones through flax's interceptors."""
    jm, tm = _models(compute_dtype=dtype)
    variables = jax_vae_variables(jm, seed=2)
    x = rng.randn(N, 64).astype(F32)
    keep = rng.rand(N, 64) < 0.5
    eps = rng.randn(N, 16).astype(F32)
    with nn.intercept_methods(_interceptor(jnp.asarray(keep), jnp.asarray(eps))):
        (out, mu, lv), upd = JaxBetaVAE(jm).apply(variables, jnp.asarray(x), train=True,
                                                  mutable=["batch_stats"])
    vae = _port_vae(tm, variables).train()
    t_out, t_mu, t_lv = vae(torch.from_numpy(x), keep=torch.from_numpy(keep), eps=torch.from_numpy(eps))
    tol = dict(rtol=1e-5, scaled=1e-6) if dtype == "float32" else dict(rtol=2e-2, scaled=4e-2)
    for got, ref in ((t_out, out), (t_mu, mu), (t_lv, lv)):
        assert got.dtype == torch.float32
        _close(_np(got), ref, **tol)


@pytest.mark.parametrize("rate,dtype", [(0.5, jnp.float32), (0.3, jnp.float32), (0.3, jnp.bfloat16)])
def test_dropout_is_flax_arithmetic(rng, rate, dtype):
    """``dropout`` with flax's own mask (read off flax's output on ones) gives
    flax's output bit for bit, ``x / keep_prob`` rounded in ``x``'s dtype."""
    x = jnp.asarray(rng.randn(16, 40), dtype)
    key = {"dropout": jax.random.key(3)}
    layer = nn.Dropout(rate, deterministic=False)
    ref = layer.apply({}, x, rngs=key)
    keep = np.asarray(layer.apply({}, jnp.ones_like(x), rngs=key)) != 0
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = tbetavae.dropout(xt, rate, torch.from_numpy(keep))
    np.testing.assert_array_equal(_np(got), np.asarray(ref.astype(jnp.float32)))


def test_dropout_draws_from_its_generator_only():
    x = torch.ones(200, 50)
    a = tbetavae.dropout(x, 0.5, generator=torch.Generator().manual_seed(1))
    b = tbetavae.dropout(x, 0.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and set(a.unique().tolist()) == {0.0, 2.0}
    assert abs(float((a > 0).float().mean()) - 0.5) < 0.02
    assert torch.equal(tbetavae.dropout(x, 0.0), x)
    with pytest.raises(ValueError, match="Generator"):
        tbetavae.dropout(x, 0.5)
    vae = BetaVAE(tcfg.VAEModelConfig(**MODEL_KW)).eval()  # eval mode: no dropout, no draw needed
    z1, _, _ = vae.encode(torch.ones(3, 64))
    assert torch.isfinite(z1).all()


# ---------------------------------------------------------------- train step


def _fill_opt(opt, params, step, rng):
    """An optax state with its counts at ``step`` and Adam moments random,
    nu far above (1-b2)*g^2 (at count 0 too: the pre-BatchNorm biases'
    gradients are rounding noise, mathematically 0, which zero moments would
    turn into sign-like updates)."""
    if not hasattr(opt, "_fields"):
        return tuple(_fill_opt(o, params, step, rng) for o in opt) if isinstance(opt, tuple) else opt
    if "mu" in opt._fields:
        return opt._replace(
            count=jnp.asarray(step, jnp.int32),
            mu=jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape) * 1e-3, jnp.float32), params),
            nu=jax.tree_util.tree_map(lambda p: jnp.asarray((rng.rand(*p.shape) + 0.5) * 1e-2, jnp.float32),
                                      params))
    if "count" in opt._fields:
        return opt._replace(count=jnp.asarray(step, jnp.int32))
    return opt


def _jax_state(jtr, jc, step=5, seed=0):
    rng = np.random.RandomState(seed)
    v = jax_vae_variables(jc.model, seed=seed + 1)
    opt = _fill_opt(jtr.tx.init(v["params"]), v["params"], step, rng)
    return JaxVAEState(step=jnp.asarray(step, jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=opt)


def _jax_trainer(jc):
    return JaxVAETrainer(jc, mesh=make_mesh(jc.mesh, devices=jax.devices()[:1]))


def _jax_step_with_draws(jtr):
    def step(state, batch, mask, keep, eps):
        with nn.intercept_methods(_interceptor(keep, eps)):
            return jtr._train_step_impl(state, batch, mask)
    return jax.jit(step)


#: name -> (VAEConfig fields, start count, steps). From count 5 the rates are
#: warmup 5/6 of lr, then the cosine's peak and 3/4 of it (warmup 6, cosine 3),
#: so the steps cross the warmup's end; with warmup 2, cosine 3 they are the
#: periodic cosine's 0, 1/4 and 3/4 of lr; from count 0 the first rate is
#: the warmup's 0 and RAdam's first steps are unrectified (ro < 5).
STEP_CASES = {
    "adam_1": ({}, 5, 1),
    "adam_3": ({}, 5, 3),
    "adam_wd_3": ({"weight_decay": 1e-2}, 5, 3),
    "adam_wd_warmup2_cosine3_3": ({"weight_decay": 1e-2, "warmup_steps": 2, "cosine_steps": 3}, 5, 3),
    "adam_from_0": ({}, 0, 2),
    "sgd_3": ({"optimizer": "sgd"}, 5, 3),
    "sgd_wd_1": ({"optimizer": "sgd", "weight_decay": 1e-2}, 5, 1),
    "radam_3": ({"optimizer": "radam"}, 5, 3),
    "radam_wd_1": ({"optimizer": "radam", "weight_decay": 1e-2}, 5, 1),
    "radam_from_0": ({"optimizer": "radam"}, 0, 3),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    cfg_kw, start, steps = STEP_CASES[case]
    jc, tc = _cfgs(**cfg_kw)
    jtr = _jax_trainer(jc)
    js = _jax_state(jtr, jc, step=start)
    tr = VAETrainer(tc, device="cpu")
    ts = tr.state_from_jax(serialization.to_state_dict(js))
    jstep = _jax_step_with_draws(jtr)
    rng = np.random.RandomState(3)
    for k in range(steps):
        x = rng.randn(N, 64).astype(F32)
        mask = np.array([1.0] * (N - 2) + [0.0] * 2, F32)  # a wrap-padded tail
        keep = rng.rand(N, 64) < 0.5
        eps = rng.randn(N, 16).astype(F32)
        js, jl = jstep(js, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(keep), jnp.asarray(eps))
        ts, tl = tr.train_step(ts, x, mask, draws={"keep": keep, "eps": eps})
        assert set(tl) == set(jl)
        for name in jl:
            np.testing.assert_allclose(_np(tl[name]), np.asarray(jl[name]), rtol=1e-5, err_msg=f"{k} {name}")
    assert ts.step == int(js.step) == start + steps
    _close_state(tr.state_to_jax(ts), serialization.to_state_dict(js))


def test_first_step_runs_at_lr_zero():
    """optax's scale_by_schedule reads the count before the update: the
    warmup's step 0 has lr 0, so Adam's moments move and the parameters do not."""
    _, tc = _cfgs()
    tr = VAETrainer(tc, device="cpu")
    st = tr.init_state()
    before = [p.detach().clone() for p in st.model.parameters()]
    x = np.random.RandomState(0).randn(N, 64).astype(F32)
    tr.train_step(st, x, np.ones(N, F32))
    assert all(torch.equal(a, b) for a, b in zip(before, st.model.parameters()))
    assert all(float(m.abs().max()) > 0 for m in st.opt.rule.mu)
    assert st.opt.lr() > 0 and st.step == 1


def test_train_step_draws_its_own_masks_deterministically():
    _, tc = _cfgs()
    x = np.random.RandomState(1).randn(N, 64).astype(F32)
    totals = []
    for seed in (99, 99, 7):
        tr = VAETrainer(dataclasses.replace(tc, seed=seed), device="cpu")
        st = tr.init_state()
        st.model.load_state_dict(VAETrainer(tc, device="cpu").init_state().model.state_dict())
        _, losses = tr.train_step(st, x, np.ones(N, F32))
        totals.append(float(losses["total_loss"]))
    assert totals[0] == totals[1] != totals[2]


@pytest.mark.parametrize("optimizer,wd", [("adam", 0.0), ("adam", 1e-2), ("sgd", 0.0), ("sgd", 1e-2),
                                          ("radam", 1e-2)])
def test_train_state_moves_both_ways_exactly(optimizer, wd):
    jc, tc = _cfgs(optimizer=optimizer, weight_decay=wd)
    jtr = _jax_trainer(jc)
    js = _jax_state(jtr, jc, step=5, seed=4)
    tr = VAETrainer(tc, device="cpu")
    ts = tr.state_from_jax(serialization.to_state_dict(js))
    assert ts.step == 5 and ts.opt.count == 5 and ts.opt.name == optimizer
    assert len(list(ts.model.parameters())) == 26  # one K3 launch takes them all
    assert len(ts.opt.rule.mu) == (0 if optimizer == "sgd" else 26)
    back = serialization.from_state_dict(js, tr.state_to_jax(ts))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, js)


def test_eval_step_matches_jax(rng):
    jc, tc = _cfgs()
    jtr = _jax_trainer(jc)
    js = _jax_state(jtr, jc)
    tr = VAETrainer(tc, device="cpu")
    ts = tr.state_from_jax(serialization.to_state_dict(js))
    x = rng.randn(N, 64).astype(F32)
    mask = np.array([1.0] * 5 + [0.0] * 3, F32)
    eps = rng.randn(N, 16).astype(F32)

    def step(state, batch, m, e):
        with nn.intercept_methods(_interceptor(eps=e)):
            return jtr._eval_step_impl(state, batch, m, jax.random.key(0))

    (jl, jout) = jax.jit(step)(js, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(eps))
    tl, tout = tr.eval_step(ts, x, mask, eps=eps)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=1e-5, atol=1e-6)
    for name in jl:
        np.testing.assert_allclose(_np(tl[name]), np.asarray(jl[name]), rtol=1e-5)
    assert float(tl["total_loss"]) == float(tl["reconstruction_loss"])


# -------------------------------------------------- fit, evaluate, checkpoints


@pytest.fixture
def no_reparam_noise(monkeypatch):
    """eps = 0 in both packages (z = z_mean): fit and evaluate draw their own
    eps from streams that differ between the packages."""
    monkeypatch.setattr(BetaVAE, "reparametrize", staticmethod(lambda z_mean, z_logvar, generator=None,
                                                               eps=None: z_mean))
    with nn.intercept_methods(_interceptor(eps=0.0)):
        yield


def _lowrank(rng, n):
    return np.tanh(rng.randn(n, 4) @ rng.randn(4, 64) * 0.5).astype(F32)


def test_fit_and_evaluate_match_jax(no_reparam_noise, tmp_path):
    """Three epochs of ``fit`` (dropout off, eps 0, a short final batch) on
    both packages from one state: per-epoch means, the best epoch, the best
    state, the ``.pt`` files, then ``evaluate`` on that state."""
    jc, tc = _cfgs(model_kw={"dropout_rate": 0.0}, num_epochs=3, lr=2e-2, batch_size=16,
                   warmup_steps=2, cosine_steps=50)
    rng = np.random.RandomState(5)
    train, val = _lowrank(rng, 40), rng.randn(12, 64).astype(F32)  # noise to validate on
    jtr = _jax_trainer(jc)
    js = _jax_state(jtr, jc, step=0)
    tr = VAETrainer(tc, device="cpu")
    ts = tr.state_from_jax(serialization.to_state_dict(js))
    scaler = trna.Scaler.fit(rng.randn(20, 64))
    jbest, jres = jtr.fit(train, val, state=js)
    tbest, tres = tr.fit(train, val, save_dir=str(tmp_path), scaler=scaler, state=ts)
    assert tres["best_epoch"] == jres["best_epoch"]
    assert tres["best_epoch"] < 2  # validation on noise worsens: the best state is a copy of an earlier one
    for split in ("train", "val"):
        for got, ref in zip(tres["history"][split], jres["history"][split], strict=True):
            for name in ref:
                np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, err_msg=f"{split} {name}")
    _close_state(tr.state_to_jax(tbest), serialization.to_state_dict(jbest))
    assert tbest is not ts and tbest.step == 3 * (tres["best_epoch"] + 1)  # 40 rows: 3 batches an epoch
    # the best .pt is the best state, strictly loadable; the scaler beside it
    best = convert.load_betavae_state_dict(str(tmp_path / "model_dict_best.pt"))
    fresh = BetaVAE(tc.model)
    fresh.load_state_dict(best, strict=True)
    for k, v in tbest.model.state_dict().items():
        assert torch.equal(best[k], v), k
    last = convert.load_betavae_state_dict(str(tmp_path / "model_last.pt"))
    assert all(torch.equal(last[k], v) for k, v in ts.model.state_dict().items())
    with open(tmp_path / "model_dict_best.json") as f:
        assert json.load(f)["epoch"] == tres["best_epoch"]
    s2 = trna.Scaler.load(str(tmp_path / "scaler.npz"))
    np.testing.assert_array_equal(s2.offset, scaler.offset)
    # evaluate: 12 rows at batch 16, one padded batch
    jl, jpred = jtr.evaluate(val, jbest)
    tl, tpred = tr.evaluate(val, tbest)
    assert tpred.shape == (12, 64)
    np.testing.assert_allclose(tpred, jpred, rtol=1e-5, atol=1e-6)
    for name in jl:
        np.testing.assert_allclose(tl[name], jl[name], rtol=1e-5)


def test_fit_keeps_best_when_validation_worsens(tmp_path):
    """best-on-val is a copy: later epochs do not move it, and its ``.pt``
    and the returned state agree."""
    _, tc = _cfgs(num_epochs=3, lr=5e-2, batch_size=16, warmup_steps=1, cosine_steps=1000)
    rng = np.random.RandomState(6)
    tr = VAETrainer(tc, device="cpu")
    val_totals = iter([0.5, 0.2, 0.9])  # the validation means, epoch by epoch
    run_epoch = tr._run_epoch

    def scripted(state, data, *, train, epoch):
        state, means = run_epoch(state, data, train=train, epoch=epoch)
        return state, (means if train else {**means, "total_loss": next(val_totals)})

    tr._run_epoch = scripted
    best, res = tr.fit(_lowrank(rng, 32), _lowrank(rng, 8), save_dir=str(tmp_path))
    assert res["best_epoch"] == 1 and res["best_loss"]["total_loss"] == 0.2
    assert best.step == 4
    saved = convert.load_betavae_state_dict(str(tmp_path / "model_dict_best.pt"))
    assert all(torch.equal(saved[k], v) for k, v in best.model.state_dict().items())


def test_best_checkpoint_feeds_the_gan(tmp_path):
    """The pipeline: ``VAETrainer.fit``'s best ``.pt`` is the frozen VAE of a
    ``GANTrainer`` through ``GANConfig(vae_checkpoint=...)``."""
    _, tc = _cfgs(num_epochs=1, batch_size=16)
    rng = np.random.RandomState(7)
    tr = VAETrainer(tc, device="cpu")
    best, _ = tr.fit(_lowrank(rng, 32), _lowrank(rng, 8), save_dir=str(tmp_path))
    path = str(tmp_path / "model_dict_best.pt")
    gcfg = tcfg.GANConfig(model=tcfg.GANModelConfig(out_size=16, encoding_dims=16, step_channels=4,
                                                    compute_dtype="float32"),
                          vae=tc.model, vae_checkpoint=path, batch_size=4)
    gtr = GANTrainer(gcfg, device="cpu")
    for k, v in best.model.state_dict().items():
        assert torch.equal(gtr.vae.state_dict()[k], v), k
    st = gtr.init_state()
    _, met = gtr.train_step(st, {"image": (rng.rand(4, 16, 16, 3) * 255).astype(np.uint8),
                                 "rna_data": _lowrank(rng, 4)})
    assert all(np.isfinite(float(v)) for v in met.values())


def test_best_keeper_writes_only_on_improvement(tmp_path):
    keeper = BestKeeper(str(tmp_path))
    sd = {"w": torch.ones(2)}
    assert keeper.update(0, 1.0, sd) and not keeper.update(1, 2.0, {"w": torch.zeros(2)})
    assert torch.equal(torch.load(keeper.best_path, weights_only=True)["w"], torch.ones(2))
    assert not os.path.exists(keeper.scaler_path)
    keeper.save_last({"w": torch.zeros(2)})
    assert sorted(os.listdir(tmp_path)) == ["model_dict_best.json", "model_dict_best.pt", "model_last.pt"]


# ------------------------------------------------------------------- losses


@pytest.mark.parametrize("training", [True, False])
def test_losses_match_jax(rng, training):
    x, xr = rng.randn(8, 20).astype(F32), np.tanh(rng.randn(8, 20)).astype(F32)
    mu, lv = rng.randn(8, 5).astype(F32), (0.5 * rng.randn(8, 5)).astype(F32)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 1], F32)
    ref = jloss.beta_vae_loss(*map(jnp.asarray, (x, xr, mu, lv)), 0.3, training)
    got = tloss.beta_vae_loss(*map(torch.from_numpy, (x, xr, mu, lv)), 0.3, training)
    mref = _masked_losses(*map(jnp.asarray, (x, xr, mu, lv, mask)), 0.3, training)
    mgot = tloss.masked_beta_vae_loss(*map(torch.from_numpy, (x, xr, mu, lv, mask)), 0.3, training)
    for a, b in ((got, ref), (mgot, mref)):
        for name in b:
            np.testing.assert_allclose(_np(a[name]), np.asarray(b[name]), rtol=1e-6, err_msg=name)
    if not training:
        assert float(mgot["total_loss"]) == float(mgot["reconstruction_loss"])


# ----------------------------------------------------------------- schedule


@pytest.mark.parametrize("kw", [dict(base_lr=5e-5), dict(base_lr=1e-3, warmup_steps=2, cosine_steps=3),
                                dict(base_lr=1e-2, warmup_steps=7, cosine_steps=11, multiplier=2.0,
                                     eta_min=1e-4)])
def test_schedule_matches_jax(kw):
    """float32 on the host against the JAX schedule's float32, over warmup,
    cosine and past its period: within an ulp of ``cos``."""
    steps = list(range(0, 40)) + [999, 1000, 1001, 1250, 1499, 1500, 2100]
    ref = jsched.gradual_warmup_cosine(**kw)
    got = tsched.gradual_warmup_cosine(**kw)
    ulp = np.spacing(np.float32(kw["base_lr"] * kw.get("multiplier", 1.0)))  # of the peak rate
    for s in steps:
        r, g = float(ref(s)), got(s)
        assert isinstance(g, np.float32)
        assert abs(g - r) <= 2 * ulp, (s, g, r)  # numpy's and XLA's float32 cos
    assert tsched.constant(3e-4)(10) == np.float32(3e-4) == float(jsched.constant(3e-4)(10))


# --------------------------------------------------------------- data layer


def _fake_df(n, genes=12, seed=0, extra=True):
    r = np.random.RandomState(seed)
    vals = r.gamma(2.0, 50.0, size=(n, genes))
    vals[r.rand(n, genes) < 0.2] = 0.0
    df = pd.DataFrame(vals, columns=[f"rna_g{i}" for i in range(genes)])
    if extra:
        df.insert(3, "case_id", [f"case_{i}" for i in range(n)])
        df["wsi_file_name"] = [f"slide_{seed}_{i}" for i in range(n)]
    return df


def _csvs(tmp_path, sizes):
    paths = []
    for t, n in enumerate(sizes):
        p = tmp_path / f"tissue{t}.csv"
        _fake_df(n, seed=t).to_csv(p, index=False)
        paths.append(str(p))
    return paths


def test_read_csv_matches_pandas(tmp_path):
    path = _csvs(tmp_path, [9])[0]
    table = trna.RNATable.read_csv(path)
    df = pd.read_csv(path)
    assert list(table.columns) == jrna.rna_columns(df)
    np.testing.assert_allclose(table.values, df[jrna.rna_columns(df)].values, rtol=1e-15)
    assert list(table.wsi_file_name) == list(df["wsi_file_name"]) and table.shape == (9, 13)


@pytest.mark.parametrize("quick", [False, True])
def test_tissue_splits_match_pandas_path(tmp_path, quick):
    paths = _csvs(tmp_path, [25, 31, 7])
    ref = jrna.load_tissue_splits(paths, seed=7, quick=quick)
    got = trna.load_tissue_splits(paths, seed=7, quick=quick)
    for t, df in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(trna.rna_matrix(t), jrna.rna_matrix(df), rtol=1e-12)
        assert list(t.wsi_file_name) == list(df["wsi_file_name"])
    np.testing.assert_array_equal(got[3], ref[3])
    n = sum(len(t) for t in got[:3])
    assert n == (10 + 10 + 7 if quick else 63)


@pytest.mark.parametrize("n,k,seed", [(25, 10, 7), (10, 10, 0), (7, 7, 99), (1000, 10, 123)])
def test_quick_sample_matches_pandas(n, k, seed):
    df = _fake_df(n, genes=3, seed=1)
    ref = df.sample(k, random_state=seed)
    table = trna.RNATable(("a", "b", "c"), df.iloc[:, [0, 1, 2]].values, np.asarray(df.index))
    got = trna.sample_rows(table, k, seed)
    np.testing.assert_array_equal(got.wsi_file_name, ref.index.values)


def test_split_matches_jax():
    df = _fake_df(23, seed=3)
    table = trna.RNATable(tuple(jrna.rna_columns(df)), df[jrna.rna_columns(df)].values,
                          df["wsi_file_name"].values)
    for frac, seed in ((0.2, 5), (0.5, 0), (0.1, 2)):
        (a, b), (ra, rb) = trna.split_df(table, frac, seed), jrna.split_df(df, frac, seed)
        assert list(a.wsi_file_name) == list(ra["wsi_file_name"])
        assert list(b.wsi_file_name) == list(rb["wsi_file_name"])


@pytest.mark.parametrize("norm", ["standard", "minmax"])
def test_normalize_and_scaler_match_jax(tmp_path, norm):
    paths = _csvs(tmp_path, [20, 15])
    rtr, rva, rte, rsc = jrna.normalize_dfs(*jrna.load_tissue_splits(paths, seed=3)[:3], norm)
    ttr, tva, tte, tsc = trna.normalize_dfs(*trna.load_tissue_splits(paths, seed=3)[:3], norm)
    for t, df in ((ttr, rtr), (tva, rva), (tte, rte)):
        np.testing.assert_allclose(trna.rna_matrix(t), jrna.rna_matrix(df), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsc.offset, rsc.offset, rtol=1e-12)
    np.testing.assert_allclose(tsc.scale, rsc.scale, rtol=1e-12)
    x = np.random.RandomState(0).randn(4, 12)
    np.testing.assert_array_equal(tsc.transform(x), rsc.transform(x))
    np.testing.assert_array_equal(tsc.inverse_transform(x), rsc.inverse_transform(x))
    # the state dicts are one form: each package reads the other's
    back = jrna.Scaler.from_state_dict(tsc.state_dict())
    assert back.kind == norm and np.array_equal(back.scale, tsc.scale)
    assert trna.Scaler.from_state_dict(rsc.state_dict()).kind == norm


def test_log_transform_and_batch_iterator_match_jax():
    vals = np.abs(np.random.RandomState(2).randn(5, 6)) * (np.arange(6) > 1)
    np.testing.assert_array_equal(trna.log_transform(vals), jrna.log_transform(vals))
    data = np.arange(30, dtype=F32).reshape(10, 3)
    for kw in (dict(batch_size=4), dict(batch_size=4, shuffle=True, seed=3, epoch=2),
               dict(batch_size=3, pad_to=2), dict(batch_size=16), dict(batch_size=4, drop_remainder=True)):
        got, ref = list(trna.batch_iterator(data, **kw)), list(jrna.batch_iterator(data, **kw))
        assert len(got) == len(ref)
        for (gb, gm), (rb, rm) in zip(got, ref):
            np.testing.assert_array_equal(gb, rb)
            np.testing.assert_array_equal(gm, rm)
    for n, b in ((10, 4), (3, 8), (9, 3)):
        for (gi, gm), (ri, rm) in zip(tbatching.batch_indices(n, b, shuffle=True, seed=1),
                                      jbatching.batch_indices(n, b, shuffle=True, seed=1), strict=True):
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gm, rm)


def test_configs_from_json_match_jax():
    raw = tcfg.load_reference_json(os.path.join(REPO, "configs", "betavae_tissues.json"))
    t, j = tcfg.vae_config_from_json(raw), jcfg.vae_config_from_json(raw)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    assert {k: v for k, v in dataclasses.asdict(j).items() if k != "model"} == \
        {k: v for k, v in dataclasses.asdict(t).items() if k != "model"}
    assert dataclasses.asdict(tcfg.data_config_from_json(raw, 7)) == \
        dataclasses.asdict(jcfg.data_config_from_json(raw, 7))
    assert dataclasses.asdict(tcfg.VAEConfig()) == dataclasses.asdict(jcfg.VAEConfig())


# ------------------------------------------------------ sampling, interpolation


def test_sample_expression_matches_jax(rng):
    jm, tm = _models()
    variables = jax_vae_variables(jm, seed=8)
    scaler = jrna.Scaler.fit(rng.randn(30, 64) * 2 + 1)
    direction = rng.randn(16).astype(F32)
    key = jax.random.key(4)
    ref = jsample.sample_expression(JaxBetaVAE(jm), variables, scaler, 6, key, direction, 0.7)
    z = jax.random.normal(key, (6, 16), jnp.float32)  # the JAX function's own latents
    vae = _port_vae(tm, variables)
    tscaler = trna.Scaler.from_state_dict(scaler.state_dict())
    got = tsample.sample_expression(vae, tscaler, 6, interpolation=direction, alpha=0.7,
                                    z=torch.from_numpy(np.asarray(z)))
    assert got.dtype == np.float32 and got.shape == (6, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    drawn = tsample.sample_expression(vae, tscaler, 6, torch.Generator().manual_seed(1))
    assert np.array_equal(drawn, tsample.sample_expression(vae, tscaler, 6, torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="Generator"):
        tsample.sample_expression(vae, tscaler, 2)


def test_interpolation_report_matches_jax(rng):
    jm, tm = _models()
    variables = jax_vae_variables(jm, seed=9)
    data = rng.randn(300, 64).astype(F32)  # two encode batches of 256
    labels = rng.randint(0, 3, 300)
    ref = jinterp.interpolation_report(JaxBetaVAE(jm), variables, data, labels, alpha=0.5)
    got = tinterp.interpolation_report(_port_vae(tm, variables), data, labels, alpha=0.5)
    np.testing.assert_allclose(got["z_mu"], ref["z_mu"], rtol=1e-5, atol=1e-6)
    assert set(got["difference_vectors"]) == set(ref["difference_vectors"]) and len(got["recons"]) == 6
    for pair in ref["difference_vectors"]:
        np.testing.assert_allclose(got["difference_vectors"][pair], ref["difference_vectors"][pair], atol=1e-5)
        np.testing.assert_allclose(got["recons"][pair], ref["recons"][pair], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ CLI, plumbing


def test_betavae_train_cli(tmp_path, capsys):
    paths = _csvs(tmp_path, [20, 20])
    save_dir = tmp_path / "ckpt"
    cfg = {"path_csv": paths, "lr": 1e-3, "num_epochs": 2, "batch_size": 8, "beta": 0.0005,
           "rna_features": 12, "z_dim": 4, "encoder_dims": [10, 8], "decoder_dims": [10],
           "save_dir": str(save_dir), "summary_path": str(tmp_path / "logs"), "flag": "t"}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    res = betavae_train.main(["--config", str(cfg_path), "--device", "cpu", "--seed", "3", "--log"])
    assert len(res["history"]["val"]) == 2
    with open(save_dir / "test_results.pkl", "rb") as f:
        out = pickle.load(f)
    assert out["predictions"].shape == out["real"].shape == (8, 12)
    assert list(out["test_labels"]) == [0] * 4 + [1] * 4 and out["test_ids"][0].startswith("slide_")
    assert {"model_dict_best.pt", "model_last.pt", "scaler.npz"} <= set(os.listdir(save_dir))
    assert os.path.exists(tmp_path / "logs" / "t.jsonl")
    # a second run starts from the best checkpoint
    betavae_train.main(["--config", str(cfg_path), "--device", "cpu",
                        "--checkpoint", str(save_dir / "model_dict_best.pt")])
    assert "Best epoch" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        betavae_train.build_parser().parse_args([])


def test_metrics_logger_and_step_timer(tmp_path):
    log = MetricsLogger(str(tmp_path), run_name="r")
    log.scalars("train", {"loss": np.float32(0.5)}, 3)
    log.scalars("val", {"loss": 0.25}, 3)
    log.close()
    lines = [json.loads(s) for s in (tmp_path / "r.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["step"], r["loss"]) for r in lines] == [("train", 3, 0.5), ("val", 3, 0.25)]
