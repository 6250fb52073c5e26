"""The β-VAE's steps as one program and what they read from device memory,
on the CPU, and the SAGAN and BigGAN graph bodies.

* the quality tool's VAE pre-train on the JAX tool's protocol:
  ``VAETrainer.run_resident`` against the JAX trainer's ``_train_step_impl``
  looped over the same row indices, with the same dropout masks and eps
  handed to both sides (the JAX side's draws replaced through
  ``flax.linen.intercept_methods``, ``tests/test_torch_port_vae.py``);
  ``VAETrainer.val_recons`` against ``tools/quality_run.py``'s score; the
  port's ``train_vae`` in 25-epoch chunks at ``--smoke`` size.
* K3's plain version with ``corr = (c1, c2, lr)``, and its refusals.
* ``ScheduledOptimizer.plan``'s rows against the host's values, and the
  float32 product by a rate tensor against the product by the float.
* The four-word Philox draw (``core/rng.py::uniform4``, ``randint``).
* The graph bodies (``VAETrainer._body``, ``GANTrainer._body``) run eagerly
  from table rows, against the eager steps, bit for bit: every VAE
  optimizer, SAGAN and BigGAN with remat off and on.

The captured paths themselves need a card: ``chip_smoke.py`` phase 16 holds
them against the eager steps there, bit for bit; here ``StepGraph`` refuses
to run (``tests/test_torch_port_step_graph.py``).

Tolerances: against JAX, the losses within 1e-5 relative and the state at
``tests/test_torch_port_vae.py``'s bounds (parameters and statistics 1e-5
relative plus 1e-6 of each tensor's largest value, moments 1e-5 plus 1e-5);
the validation score within 1e-5 relative. Within the port, bit-equal.
"""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization
from test_torch_port_vae import (_cfgs, _close_state, _interceptor, _jax_state, _jax_step_with_draws,
                                 _jax_trainer)

from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.core import rng as trng
from rnagan_tpu_torch.kernels.fused_adam import adam_update_plain, fused_adam
from rnagan_tpu_torch.kernels.infusion import _MASK, philox4x32, philox_key
from rnagan_tpu_torch.models.betavae import BetaVAE, draw_eps, draw_keep
from rnagan_tpu_torch.optim.adam import bias_corrections
from rnagan_tpu_torch.train.gan_trainer import GANTrainer, given_batch
from rnagan_tpu_torch.train.vae_trainer import LOSS_KEYS, VAETrainer, given_rows

REPO = Path(__file__).resolve().parent.parent
F32 = np.float32
FEATURES, Z = 64, 16  # test_torch_port_vae.MODEL_KW's widths


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _quality_tool():
    spec = importlib.util.spec_from_file_location("quality_run_torch", REPO / "tools" / "quality_run_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _vae_tensors(state):
    return [*state.model.parameters(), *state.model.buffers(), *state.opt.rule.mu, *state.opt.rule.nu]


def _assert_same_vae(a, b):
    for x, y in zip(_vae_tensors(a), _vae_tensors(b), strict=True):
        assert torch.equal(x, y)
    assert (a.step, a.opt.count, a.opt.rule.count) == (b.step, b.opt.count, b.opt.rule.count)


# ------------------------------------------- the quality pre-train on the JAX protocol


@pytest.mark.parametrize("optimizer", ["adam", "radam"])
def test_run_resident_matches_the_jax_scanned_body(optimizer):
    """Three resident-matrix steps from a JAX state at count 5, on given row
    indices (``train_dev[idx]``, mask all ones) with given masks and eps:
    the mean total loss and the state after them as the JAX body's."""
    jc, tc = _cfgs(optimizer=optimizer)
    jtr = _jax_trainer(jc)
    js = _jax_state(jtr, jc, step=5)
    tr = VAETrainer(tc, device="cpu")
    ts = tr.state_from_jax(serialization.to_state_dict(js))
    rng = np.random.RandomState(8)
    steps, batch = 3, 6
    data = rng.randn(20, FEATURES).astype(F32)
    rows = rng.randint(0, len(data), (steps, batch))
    keep = rng.rand(steps, batch, FEATURES) < 0.5
    eps = rng.randn(steps, batch, Z).astype(F32)
    jstep = _jax_step_with_draws(jtr)
    ones = jnp.ones((batch,), jnp.float32)
    totals = []
    for i in range(steps):
        js, jl = jstep(js, jnp.asarray(data[rows[i]]), ones, jnp.asarray(keep[i]), jnp.asarray(eps[i]))
        totals.append(jl["total_loss"])
    tl = tr.run_resident(ts, torch.as_tensor(data), steps, batch, rows=rows, draws={"keep": keep, "eps": eps})
    assert tl.shape == () and tl.device.type == "cpu"
    np.testing.assert_allclose(float(tl), float(jnp.mean(jnp.stack(totals))), rtol=1e-5)
    assert ts.step == int(js.step) == 5 + steps
    _close_state(tr.state_to_jax(ts), serialization.to_state_dict(js))


def test_run_resident_draws_each_steps_rows_and_masks_from_its_seeds():
    """Without given rows and draws, step s takes ``randint(seed("train", s,
    2), rows)`` rows, the mask of stage 0 and the eps of stage 1: the same
    steps as with those handed in, bit for bit, in one chunk or in two."""
    _, tc = _cfgs()
    tr = VAETrainer(tc, device="cpu")
    s0 = tr.init_state()
    data = torch.randn(20, FEATURES, generator=torch.Generator().manual_seed(0))
    steps, batch = 3, 5
    drawn, chunked, given = copy.deepcopy(s0), copy.deepcopy(s0), copy.deepcopy(s0)
    tl = tr.run_resident(drawn, data, steps, batch)
    assert torch.equal(tl, tr.run_resident(chunked, data, steps, batch, capacity=2))
    seed = lambda s, stage: tr.seeds.seed("train", s, stage)  # noqa: E731
    rows = torch.stack([trng.randint(seed(s, 2), len(data), (batch,), "cpu") for s in range(steps)])
    assert rows.min() >= 0 and rows.max() < len(data)
    draws = {"keep": torch.stack([draw_keep(seed(s, 0), (batch, FEATURES), 0.5, "cpu") for s in range(steps)]),
             "eps": torch.stack([draw_eps(seed(s, 1), (batch, Z), "cpu") for s in range(steps)])}
    assert torch.equal(tl, tr.run_resident(given, data, steps, batch, rows=rows, draws=draws))
    _assert_same_vae(drawn, given)
    _assert_same_vae(drawn, chunked)


def test_val_recons_is_the_jax_tools_score(rng):
    """``mean((out - val)^2)`` of the eval-mode forward over the whole set
    (``tools/quality_run.py:113-116``), the JAX side handed the port's eps."""
    jc, tc = _cfgs()
    jtr = _jax_trainer(jc)
    js = _jax_state(jtr, jc)
    tr = VAETrainer(tc, device="cpu")
    ts = tr.state_from_jax(serialization.to_state_dict(js))
    val = rng.randn(7, FEATURES).astype(F32)
    seed = 1234
    eps = draw_eps(seed, (7, Z), "cpu").numpy()

    def score(state, v, e):
        with nn.intercept_methods(_interceptor(eps=e)):
            out, _, _ = jtr.model.apply({"params": state.params, "batch_stats": state.batch_stats}, v,
                                        train=False, rngs={"reparam": jax.random.key(0)})
        return jnp.mean(jnp.square(out.astype(jnp.float32) - v))

    ref = float(jax.jit(score)(js, jnp.asarray(val), jnp.asarray(eps)))
    got = tr.val_recons(ts, torch.as_tensor(val), seed)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)
    assert ts.step == 5  # validation moves nothing


def test_quality_train_vae_runs_the_jax_protocol(monkeypatch, capsys):
    """The quality tool's pre-train at ``--smoke`` size with 30 epochs: the
    JAX tool's split (6 slides: 1 held out, batch 5, 1 step an epoch), a
    chunk of 25 epochs and one of 5 through ``run_resident``, a
    ``val_recons`` and an ``[vae] epoch`` line after each, and the best
    chunk's variables returned."""
    q = _quality_tool()
    args = q.parse_args(["--smoke", "--device", "cpu"])
    args.vae_epochs = 30  # --smoke sets 3: one chunk
    expr_norm, _ = q.normalized_expression(q.build_corpus(args, "cpu"))
    calls, scores = [], []
    run, score = VAETrainer.run_resident, VAETrainer.val_recons

    def counting_run(self, state, data, steps, batch, **kw):
        calls.append((len(data), steps, batch))
        return run(self, state, data, steps, batch, **kw)

    def recording_score(self, state, data, seed):
        value = score(self, state, data, seed)
        scores.append((float(value), len(data), {k: v.clone() for k, v in state.model.state_dict().items()}))
        return value

    monkeypatch.setattr(VAETrainer, "run_resident", counting_run)
    monkeypatch.setattr(VAETrainer, "val_recons", recording_score)
    sd, cfg, seconds = q.train_vae(args, expr_norm, torch.device("cpu"))
    assert len(expr_norm) == 6 and cfg == q.vae_model_config(args)
    assert calls == [(5, 25, 5), (5, 5, 5)]
    assert [n for _, n, _ in scores] == [1, 1]
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[vae] epoch")]
    assert [line.split()[2] for line in lines] == ["25/30", "30/30"]
    best = min(range(len(scores)), key=lambda i: scores[i][0])
    for k, v in scores[best][2].items():
        assert torch.equal(sd[k], v), k
    assert seconds > 0


# ------------------------------------------------------- K3's rate in device memory


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_k3_rate_in_corr_matches_the_host_float(mu_dtype, wd):
    """K3 on the CPU (its plain version) with ``corr = (c1, c2, lr)``:
    bit-equal to the launch with the host floats, and to the plain version
    with the (2,) ``corr`` and the float rate."""
    g = torch.Generator().manual_seed(2)
    shapes = [(9, 4), (1,), (33,)]
    c1, c2 = bias_corrections(4, 0.9, 0.999)
    lr = float(np.float32(7.3e-4))
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=wd)

    def inputs():
        g.manual_seed(2)
        return ([torch.randn(s, generator=g) for s in shapes], [torch.randn(s, generator=g) for s in shapes],
                [(torch.randn(s, generator=g) * 1e-3).to(mu_dtype) for s in shapes],
                [torch.rand(s, generator=g) * 1e-2 for s in shapes])

    a, b, c = inputs(), inputs(), inputs()
    fused_adam(*a, corr=torch.tensor([c1, c2, lr], dtype=torch.float32), lr=None, **hp)
    fused_adam(*b, c1=c1, c2=c2, lr=lr, **hp)
    adam_update_plain(*c, None, None, lr, corr=torch.tensor([c1, c2], dtype=torch.float32), **hp)
    for xs, ys, zs in zip(a, b, c):
        for x, y, w in zip(xs, ys, zs):
            assert torch.equal(x, y) and torch.equal(x, w)


@pytest.mark.parametrize("corr,lr,match", [
    (torch.tensor([0.1, 0.2, 1e-3, 0.0]), None, "corr must be"),
    (torch.tensor([0.1, 0.2, 1e-3], dtype=torch.float64), None, "corr must be"),
    (torch.tensor([0.1, 0.2, 1e-3], device="meta"), None, "corr must be"),
    (torch.tensor([0.1, 0.0, 0.2, 0.0, 1e-3])[::2], None, "corr must be"),
    (torch.tensor([0.1, 0.2, 1e-3]), 1e-3, "beside lr"),
    (torch.tensor([0.1, 0.2]), None, "pass lr"),
])
def test_k3_refuses_a_wrong_corr(corr, lr, match):
    """A corr of another length, dtype or device, a strided one, a rate both
    in corr and as an argument, or none at all."""
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match=match):
        fused_adam(p, [torch.ones(3)], [torch.zeros(3)], [torch.ones(3)], corr=corr, lr=lr, b1=0.9, b2=0.999,
                   eps=1e-8)


# ---------------------------------------------------------- the optimizer's rows


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "radam"])
def test_plan_rows_are_the_host_values(optimizer):
    """Eight steps from count 0 (RAdam rectifies from t = 6): each
    row holds the float32 bias corrections, the schedule's rate at the count
    and RAdam's r (0 unrectified), the variants RAdam's choice; nothing
    advances."""
    _, tc = _cfgs(optimizer=optimizer, warmup_steps=3, cosine_steps=4)
    opt = VAETrainer(tc, device="cpu").init_state().opt
    rows, variants = opt.plan(8)
    assert rows.dtype == torch.float32 and rows.shape == (8, 4)
    for i in range(8):
        t = i + 1
        assert rows[i, 2].item() == float(np.float32(opt.schedule(i)))
        if optimizer == "sgd":
            assert variants[i] is None and rows[i, 3].item() == 0.0
            continue
        c1, c2 = bias_corrections(t, 0.9, 0.999)
        assert (rows[i, 0].item(), rows[i, 1].item()) == (c1, c2)
        if optimizer == "radam":
            r = opt.rule.rectification(t)
            assert variants[i] == (r is not None)
            assert rows[i, 3].item() == (0.0 if r is None else float(r))
        else:
            assert variants[i] is None
    if optimizer == "radam":
        assert variants == [False] * 5 + [True] * 3
    assert opt.count == opt.rule.count == 0


def test_product_by_a_rate_tensor_rounds_as_by_the_float():
    """``x * -float(lr)`` (the eager SGD and RAdam updates) and ``x * (-lr_t)``
    (a 0-dim float32 tensor of the same rate, read from the optimizer's row)
    give the same float32 bits on the CPU, for float32 and double rates."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=g) * torch.logspace(-6, 6, 4096)
    rates = [1e-3, 7.3e-4, 1.0 / 3.0, 5e-5 * 0.999, 2.0 ** -20 * 1.1]
    rates += torch.rand(64, generator=g, dtype=torch.float64).mul(1e-2).tolist()
    for lr in rates:
        t = torch.tensor(lr, dtype=torch.float32)
        assert torch.equal(x * -float(lr), x * (-t)), lr
        assert torch.equal(x * float(np.float32(lr)), x * t), lr


# ------------------------------------------------------------- the four-word draw


@pytest.mark.parametrize("seed", [0, 123457, 2**31 - 1])
def test_uniform4_takes_four_words_a_counter(seed):
    """Element ``4k + j`` is word ``j`` of counter ``k`` (key word 1 is 2),
    its top 24 bits over 2^24; any shape is the flat draw reshaped; a seed as
    an int64 scalar or an int32 (1,) tensor draws the int's bits."""
    n = 37
    k = torch.arange(10, dtype=torch.int64) & _MASK
    zero = torch.zeros((), dtype=torch.int64)
    words = torch.stack(philox4x32((k, zero, zero, zero), (philox_key(seed), 2)), dim=-1).reshape(-1)[:n]
    want = (words >> 8).to(torch.float32) / 2**24
    got = trng.uniform4(seed, (n,), "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(trng.uniform4(seed, (3, 4), "cpu"), got[:12].reshape(3, 4))
    for t in (torch.tensor(seed, dtype=torch.int64), torch.tensor([seed], dtype=torch.int32)):
        assert torch.equal(trng.uniform4(t, (n,), "cpu"), got)
        assert torch.equal(trng.randint(t, 7, (n,), "cpu"), words % 7)
    assert torch.equal(trng.randint(seed, 7, (n,), "cpu"), words % 7)
    assert not torch.equal(got, trng.uniform(seed, (n,), "cpu"))  # key word 1 keeps the streams apart


def test_uniform4_and_randint_are_uniform():
    u = trng.uniform4(5, (200, 200), "cpu")
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005 and abs(float(u.var()) - 1 / 12) < 0.002
    r = trng.randint(5, 5, (50000,), "cpu")
    counts = torch.bincount(r, minlength=5).float() / 50000
    assert r.dtype == torch.int64 and counts.numel() == 5 and float((counts - 0.2).abs().max()) < 0.01
    with pytest.raises(ValueError, match="high"):
        trng.randint(5, 0, (3,), "cpu")


def test_dropout_mask_from_a_seed():
    """``dropout(seed=)`` and the model's ``seeds=`` draw ``draw_keep``'s
    mask and ``draw_eps``'s eps; a generator still draws for its callers."""
    from rnagan_tpu_torch.models.betavae import dropout

    x = torch.ones(16, 40)
    keep = draw_keep(9, (16, 40), 0.5, "cpu")
    assert torch.equal(dropout(x, 0.5, seed=9), torch.where(keep, x * 2.0, torch.zeros(())))
    assert torch.equal(dropout(x, 0.5, seed=torch.tensor(9)), dropout(x, 0.5, seed=9))
    vae = BetaVAE(tcfg.VAEModelConfig(rna_features=40, z_dim=8, encoder_dims=(16, 8), decoder_dims=(16,))).train()
    a = vae(x, seeds=(9, 10))
    b = vae(x, keep=keep, eps=draw_eps(10, (16, 8), "cpu"))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert dropout(x, 0.5, generator=torch.Generator().manual_seed(1)).shape == x.shape


# ---------------------------------------------------- the graph bodies, run eagerly

#: name -> (VAEConfig fields, steps): RAdam from count 0 crosses its threshold
VAE_BODY_CASES = {"adam": ({}, 3), "adam_wd": ({"weight_decay": 1e-2}, 3), "sgd": ({"optimizer": "sgd"}, 3),
                  "sgd_wd": ({"optimizer": "sgd", "weight_decay": 1e-2}, 2),
                  "radam": ({"optimizer": "radam"}, 7)}


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("case", list(VAE_BODY_CASES))
def test_vae_graph_body_is_the_eager_step(case, given):
    """The train graph's body, called on the CPU with each step's table rows
    (its seeds and the optimizer's row as tensors, RAdam's variant), against
    ``train_step_eager`` from a copy of one state: the same parameters,
    statistics, moments, counts and losses, bit for bit. The eval body
    against ``eval_step_eager`` too."""
    cfg_kw, steps = VAE_BODY_CASES[case]
    _, tc = _cfgs(**cfg_kw)
    tr = VAETrainer(tc, device="cpu")
    s0 = tr.init_state()
    eager, body_state = copy.deepcopy(s0), copy.deepcopy(s0)
    rng = np.random.RandomState(4)
    x = torch.as_tensor(rng.randn(steps, 8, FEATURES).astype(F32))
    mask = torch.tensor([[1.0] * 6 + [0.0] * 2] * steps)
    draws = ({"keep": torch.as_tensor(rng.rand(steps, 8, FEATURES) < 0.5),
              "eps": torch.as_tensor(rng.randn(steps, 8, Z).astype(F32))} if given else {})
    want = [tr.train_step_eager(eager, x[i], mask[i], {k: v[i] for k, v in draws.items()} or None)[1]
            for i in range(steps)]
    seeds, opt_rows, variants, after = tr._plan(body_state, steps)
    tables = {"batch": x, "mask": mask, **draws, "seeds": seeds, "opt": opt_rows}
    body = tr._body("train", body_state, given_rows)
    got = [body(variants[i], {k: t[i] for k, t in tables.items()}) for i in range(steps)]
    body_state.step, body_state.opt.count, body_state.opt.rule.count = after
    _assert_same_vae(eager, body_state)
    for w, g in zip(want, got):
        assert torch.equal(torch.stack([w[k] for k in LOSS_KEYS]), g)
    if case == "radam":
        assert variants == [False] * 5 + [True] * 2

    evaluate = tr._body("eval", eager, given_rows)
    lo, out = evaluate(None, {"batch": x[0], "mask": mask[0], "seeds": torch.tensor([77])})
    want_lo, want_out = tr.eval_step_eager(eager, x[0], mask[0], seed=77)
    assert torch.equal(out, want_out) and torch.equal(lo, torch.stack([want_lo[k] for k in LOSS_KEYS]))


def test_vae_fit_and_evaluate_on_device_rows_match_host_rows(tmp_path):
    """``fit``'s tables hold row indices when the data is a tensor on the
    trainer's device and the batches when the host holds it: the same
    epochs, one batch builder a batch shape across epochs; ``evaluate``
    returns the valid rows' reconstructions."""
    _, tc = _cfgs(num_epochs=2, batch_size=16)
    rng = np.random.RandomState(5)
    train, val = rng.randn(40, FEATURES).astype(F32), rng.randn(12, FEATURES).astype(F32)
    tr = VAETrainer(tc, device="cpu")
    s0 = tr.init_state()
    host_best, host_res = tr.fit(train, val, state=copy.deepcopy(s0))
    dev_best, dev_res = tr.fit(torch.as_tensor(train), torch.as_tensor(val), state=copy.deepcopy(s0))
    assert host_res["history"] == dev_res["history"] and host_res["best_epoch"] == dev_res["best_epoch"]
    _assert_same_vae(host_best, dev_best)
    # one batch builder a batch shape, whatever the epoch: a graph keyed on it is found again
    assert sorted(k[1] for k in tr.step_graphs._prepares if k[0] == "host") == [12, 16]
    losses, preds = tr.evaluate(val, dev_best)
    assert preds.shape == val.shape and set(losses) == set(LOSS_KEYS)
    assert losses["total_loss"] == losses["reconstruction_loss"]


def _sn_config(arch, loss_type, remat, classes):
    enc = 16 if arch == "sagan" else 24
    model = tcfg.GANModelConfig(arch=arch, encoding_dims=enc, out_size=16, step_channels=4, attn_size=8,
                                num_classes=classes, embed_dim=6, remat=remat, compute_dtype="float32")
    vae = tcfg.VAEModelConfig(rna_features=20, z_dim=enc, encoder_dims=(24, enc), decoder_dims=(24,),
                              compute_dtype="float32")
    return tcfg.GANConfig(model=model, vae=vae, loss_type=loss_type, batch_size=4)


#: name -> (arch, loss_type, remat, classes, GANConfig fields)
SN_BODY_CASES = {"sagan": ("sagan", "wganvae", False, 0, {}),
                 "biggan": ("biggan", "wganvae", False, 2, {}),
                 "biggan_remat": ("biggan", "wganvae", True, 2, {}),
                 "biggan_unconditional_remat_wgan_compat_gp": ("biggan", "wgan", True, 0,
                                                               {"compat_reference_gp": True, "clip": None})}


@pytest.mark.parametrize("case", list(SN_BODY_CASES))
def test_sn_gan_graph_body_is_the_eager_step(case):
    """The GAN graph's body for SAGAN and BigGAN (remat off and on), called
    on the CPU with each step's table rows (the seeds and Adam bias
    corrections as tensors), against ``train_step_eager`` from a copy of one
    state: parameters, spectral-norm and BatchNorm state pairs, moments,
    counts and metrics bit for bit."""
    import dataclasses

    arch, loss_type, remat, classes, cfg_kw = SN_BODY_CASES[case]
    cfg = dataclasses.replace(_sn_config(arch, loss_type, remat, classes), **cfg_kw)
    vae_sd = BetaVAE(cfg.vae, seed=3).state_dict() if loss_type == "wganvae" else None
    tr = GANTrainer(cfg, vae_sd, device="cpu")
    s0 = tr.init_state()
    eager, body_state = copy.deepcopy(s0), copy.deepcopy(s0)
    rng = np.random.RandomState(6)
    steps = 2
    tables = {"image": torch.as_tensor((rng.rand(steps, 4, 16, 16, 3) * 255).astype(np.uint8))}
    if loss_type == "wganvae":
        tables["rna_data"] = torch.as_tensor(rng.randn(steps, 4, 20).astype(F32))
    if classes:
        tables["labels"] = torch.as_tensor(rng.randint(0, classes, (steps, 4)))
    want = [tr.train_step_eager(eager, {k: t[i] for k, t in tables.items()})[1] for i in range(steps)]
    runs, seeds, corr, after = tr._plan(body_state, steps)
    rows = {**tables, "seeds": seeds, "corr": corr}
    body = tr._body(body_state, given_batch)
    got = [body(runs[i], {k: t[i] for k, t in rows.items()}) for i in range(steps)]
    body_state.step, body_state.d_opt.count, body_state.g_opt.count = after
    for w, g in zip(want, got):
        assert torch.equal(torch.stack([w[k].float().reshape(()) for k in tr.metric_keys()]), g)
    def tensors(s):
        return [*s.generator.parameters(), *s.discriminator.parameters(),
                *(t for pair in s.g_stats + s.d_stats for t in pair), *s.g_opt.mu, *s.g_opt.nu, *s.d_opt.mu,
                *s.d_opt.nu]

    for x, y in zip(tensors(eager), tensors(body_state), strict=True):
        assert torch.equal(x, y)
    assert (eager.step, eager.d_opt.count, eager.g_opt.count) == (body_state.step, body_state.d_opt.count,
                                                                  body_state.g_opt.count)
