"""The ResNet family's steps as one program each, on the CPU.

* The graph bodies (``GraphSteps._body``: what ``StepGraph`` captures on the
  card) of the tile classifier, SimCLR and fusion, run eagerly from table
  rows (the step's inputs, given draws or a seed row, AdamW's ``corr`` row),
  against ``train_step_eager``, bit for bit, with given and with drawn
  draws; the eval bodies against ``eval_step``.
* The Philox draws (the classifier's flips, SimCLR's seven draws a view,
  the fusion dropout mask, ``fit_resident``'s permutation) from a device
  seed tensor against the same seed as a host int, and the eager step that
  draws them against the same step handed them.
* ``AdamW.plan``'s rows against ``bias_corrections``; K3's plain version
  with a (2,) ``corr`` and decay against the host floats.
* ``fit_resident`` through its table plan (drawn permutation and flips)
  against the given-permutation run; ``fit`` and the fusion passes in
  several chunks against one; SimCLR on a corpus held as a tensor (index
  tables) against the host corpus (batch tables).

The captured paths need a card: ``chip_smoke.py`` phase 17 holds them
against the eager steps there. The JAX parity of these trainers is
``tests/test_torch_port_resnet.py`` and ``test_torch_port_ssl_fusion.py``.
Within the port every comparison here is bit-equal.
"""

import copy
import functools

import numpy as np
import pytest
import torch

from rnagan_tpu_torch.core import rng as trng
from rnagan_tpu_torch.core.config import MLConfig
from rnagan_tpu_torch.core.metrics import epoch_means
from rnagan_tpu_torch.data.patches import BagData
from rnagan_tpu_torch.kernels.fused_adam import adam_update_plain
from rnagan_tpu_torch.models.betavae import draw_keep
from rnagan_tpu_torch.models.resnet import BasicBlock, ResNet
from rnagan_tpu_torch.optim.adam import AdamW, bias_corrections
from rnagan_tpu_torch.train import step_graph
from rnagan_tpu_torch.train import ml_experiment as tml
from rnagan_tpu_torch.train.fusion_trainer import FusionConfig, FusionTrainer, trainable_names
from rnagan_tpu_torch.train.ssl_trainer import VIEW_DRAWS, SimCLRTrainer, SSLConfig, draw_view, given_views

SIZE, N, GENES = 16, 8, 12
TINY = functools.partial(ResNet, BasicBlock, (1, 1, 1, 1), compute_dtype="float32")


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tensors(state):
    return [*state.model.parameters(), *state.model.buffers(), *state.opt.mu, *state.opt.nu]


def _assert_same(a, b):
    for x, y in zip(_tensors(a), _tensors(b), strict=True):
        assert torch.equal(x, y)
    assert a.opt.count == b.opt.count


def _warm(state, seed=0):
    """AdamW moments as after a few steps (the count 5): a first step from
    zero moments moves every parameter by its sign alone."""
    g = torch.Generator().manual_seed(seed)
    for mu, nu in zip(state.opt.mu, state.opt.nu):
        mu.copy_(torch.randn(mu.shape, generator=g) * 1e-3)
        nu.copy_((torch.rand(nu.shape, generator=g) + 0.5) * 1e-2)
    state.step = state.opt.count = 5
    return state


def _body_rows(tr, state, tables, given=None):
    """One step's rows as a graph reads them: the tables' row 0, the step's
    seeds as an int64 tensor, AdamW's ``(c1, c2)`` as a float32 tensor."""
    rows = {k: t[0] for k, t in tables.items()}
    rows["seeds"] = tr.seeds.table(tr.stream, state.step, 1, tr.stages)[0]
    rows["opt"] = state.opt.plan(1)[0]
    if given is not None:
        rows[tr.draw_table] = given
    return rows


def _run_body(tr, state, prepare, rows):
    """The train body on ``rows``, then the step and count as a chunk of one advances them."""
    count = state.opt.count
    vec = tr._body("train", state, prepare)(None, rows)
    state.step += 1
    state.opt.count = count + 1
    return dict(zip(tr.metric_keys, vec.unbind(0)))


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].float().reshape(()), want[k].float().reshape(())), k


# --------------------------------------------------------------- the classifier


def _ml(**kw):
    cfg = MLConfig(**{"num_epochs": 1, "batch_size": N, "folds": 2, "image_size": SIZE, **kw})
    return tml.TileClassifierTrainer(cfg, model=functools.partial(TINY, num_classes=2), device="cpu")


@pytest.fixture(scope="module")
def ml_data():
    rng = np.random.RandomState(5)
    images = rng.rand(24, SIZE, SIZE, 3).astype(np.float32)
    labels = (np.arange(24) % 2).astype(np.int64)
    images[labels == 1] *= 0.5
    return images, labels


@pytest.mark.parametrize("given", [True, False])
@pytest.mark.parametrize("source", ["host", "resident"])
def test_classifier_body_is_the_eager_step(ml_data, given, source):
    """The train body on a batch table (``fit``'s) or an index table into a
    uint8 set (``fit_resident``'s), given or drawn flips, against
    ``train_step_eager`` on the same batch: metrics and state bit-equal;
    then the eval body against ``eval_step``."""
    images, labels = ml_data
    tr = _ml()
    s0 = _warm(tr.init_state())
    idx = np.arange(N) + 3
    mask = np.r_[np.ones(N - 1), 0.0].astype(np.float32)
    rng = np.random.RandomState(1)
    draws = {"flip_h": rng.rand(N) < 0.5, "flip_v": rng.rand(N) < 0.5} if given else None
    u8 = torch.from_numpy((images * 255).astype(np.uint8))
    if source == "host":
        x01 = images[idx]
        tables = {"images": torch.from_numpy(x01)[None], "labels": torch.from_numpy(labels[idx])[None],
                  "mask": torch.from_numpy(mask)[None]}
        prepare = tr._host_prepare(N, shard=True)
    else:
        mask = np.ones(N, np.float32)  # a resident step's rows are all valid
        x01 = tml.unit_from_uint8(u8[idx])
        tables = {"idx": torch.from_numpy(idx)[None]}
        prepare = tr._resident_prepare(u8, torch.from_numpy(labels), N, shard=True)
    eager, body = copy.deepcopy(s0), copy.deepcopy(s0)
    _, m_eager = tr.train_step_eager(eager, x01, labels[idx], mask, draws)
    m_body = _run_body(tr, body, prepare, _body_rows(tr, body, tables, tml.given_flips(draws) if given else None))
    _assert_metrics(m_body, m_eager)
    _assert_same(body, eager)
    assert body.step == eager.step == 6

    eval_prepare = (tr._host_prepare(N, shard=False) if source == "host"
                    else tr._resident_prepare(u8, None, N, shard=False))
    eval_rows = {"images": torch.as_tensor(x01)} if source == "host" else {"idx": torch.from_numpy(idx)}
    pred, logp = tr._body("eval", body, eval_prepare)(None, eval_rows)
    want_pred, want_logp = tr.eval_step(eager, x01)
    assert torch.equal(pred, want_pred) and torch.equal(logp, want_logp)


def test_classifier_drawn_flips_are_the_seed_rows(ml_data):
    """The eager step's drawn flips are ``draw_flips(seed("ml", step))``:
    the step handed them is bit-equal; a device-seed tensor draws the same
    bits as the host int."""
    images, labels = ml_data
    tr = _ml()
    s0 = _warm(tr.init_state())
    seed = tr.seeds.seed("ml", s0.step)
    flips = tml.draw_flips(seed, N, "cpu")
    assert flips.shape == (2, N) and flips.dtype == torch.bool and 0 < int(flips.sum()) < 2 * N
    assert torch.equal(tml.draw_flips(torch.tensor([seed]), N, "cpu"), flips)
    drawn, given = copy.deepcopy(s0), copy.deepcopy(s0)
    ones = np.ones(N, np.float32)
    _, m_drawn = tr.train_step_eager(drawn, images[:N], labels[:N], ones)
    _, m_given = tr.train_step_eager(given, images[:N], labels[:N], ones,
                                     {"flip_h": flips[0].numpy(), "flip_v": flips[1].numpy()})
    _assert_metrics(m_drawn, m_given)
    _assert_same(drawn, given)


def test_fit_resident_through_its_plan_is_the_given_permutation_run(ml_data):
    """Two epochs of ``fit_resident`` with the permutation and flips drawn
    (the epoch's index table from ``permutation(seed("ml_epoch", e))``,
    each step's flips from its seed row) against the same epochs handed
    those draws: history and state bit-equal; one permutation a seed on
    any integer seed form."""
    images, labels = ml_data
    u8 = (images * 255).astype(np.uint8)
    tr = _ml(num_epochs=2)
    perms = [trng.permutation(tr.seeds.seed("ml_epoch", e), 16, "cpu") for e in range(2)]
    for p in perms:
        assert sorted(p.tolist()) == list(range(16))
    assert torch.equal(trng.permutation(torch.tensor(tr.seeds.seed("ml_epoch", 0)), 16, "cpu"), perms[0])
    assert not torch.equal(perms[0], perms[1])
    flips = [tml.draw_flips(tr.seeds.seed("ml", s), N, "cpu") for s in range(5, 9)]
    draws = {"perms": [p.numpy() for p in perms],
             "flips": [{"flip_h": f[0].numpy(), "flip_v": f[1].numpy()} for f in flips]}
    s0 = _warm(tr.init_state())
    drawn, res_d = tr.fit_resident(u8[:16], labels[:16], u8[16:], labels[16:], state=copy.deepcopy(s0))
    given, res_g = tr.fit_resident(u8[:16], labels[:16], u8[16:], labels[16:], state=copy.deepcopy(s0),
                                   draws=draws)
    assert res_d == res_g and len(res_d["history"]) == 2
    _assert_same(drawn, given)
    with pytest.raises(ValueError, match="whole epochs"):
        tr.fit_resident(u8[:16], labels[:16], u8[16:], labels[16:], state=copy.deepcopy(s0),
                        draws={"flips": draws["flips"][:1]})


def test_resident_epoch_returns_device_rows_and_predictions(ml_data):
    """``resident_epoch``'s outputs stay tensors (the one copy an epoch is
    the caller's): the steps' (loss, acc) rows and one prediction a
    validation tile, equal to ``predict_resident`` after the epoch."""
    images, labels = ml_data
    u8 = torch.from_numpy((images * 255).astype(np.uint8))
    tr = _ml()
    state = _warm(tr.init_state())
    rows, preds = tr.resident_epoch(state, u8[:16], torch.from_numpy(labels[:16]), u8[16:], epoch=0)
    assert rows.shape == (2, 2) and preds.shape == (8,) and preds.dtype == torch.int64
    assert state.step == 7 and state.opt.count == 7
    assert np.array_equal(preds.numpy(), tr.predict_resident(u8[16:], state))
    means, host = epoch_means(rows, tr.metric_keys, preds)
    assert means == {k: float(v) for k, v in zip(tr.metric_keys, rows.double().mean(0))}
    assert np.array_equal(host, preds.numpy())


def test_fit_in_chunks_is_fit_in_one(ml_data, monkeypatch):
    """``fit``'s tables split into chunks of one step (and the validation's)
    train and predict as one chunk does."""
    images, labels = ml_data
    tr = _ml(num_epochs=2, batch_size=5)  # a padded last batch
    s0 = _warm(tr.init_state())
    one, res_one = tr.fit(images[:16], labels[:16], images[16:], labels[16:], state=copy.deepcopy(s0))
    monkeypatch.setattr(step_graph, "CHUNK_BYTES", 1)
    many, res_many = tr.fit(images[:16], labels[:16], images[16:], labels[16:], state=copy.deepcopy(s0))
    assert res_one == res_many
    _assert_same(one, many)
    assert np.array_equal(tr.predict(images, one), tr.predict(images, many))


# ------------------------------------------------------------------- SimCLR


def _ssl():
    cfg = SSLConfig(batch_size=N, image_size=SIZE, projection_hidden=32, projection_dim=16, num_epochs=1)
    return SimCLRTrainer(cfg, backbone=TINY, device="cpu")


@pytest.mark.parametrize("given", [True, False])
def test_simclr_body_is_the_eager_step(given):
    images = np.random.RandomState(11).rand(N, SIZE, SIZE, 3).astype(np.float32)
    tr = _ssl()
    s0 = _warm(tr.init_state())
    draws = {v: draw_view(N, 0.6, 40 + i, "cpu") for i, v in enumerate("ab")} if given else None
    eager, body = copy.deepcopy(s0), copy.deepcopy(s0)
    _, m_eager = tr.train_step_eager(eager, images, draws)
    rows = _body_rows(tr, body, {"images": torch.from_numpy(images)[None]}, given_views(draws) if given else None)
    m_body = _run_body(tr, body, tr._host_prepare(N), rows)
    _assert_metrics(m_body, m_eager)
    _assert_same(body, eager)


def test_simclr_views_are_the_seed_rows():
    """A view's seven draws from a seed: the uniforms' rows spread over
    each draw's range; a device-seed tensor draws the same bits; the eager
    step's drawn views (stage 0 view A, stage 1 view B) are those seeds'."""
    seed = 1234
    view = draw_view(N, 0.6, seed, "cpu")
    u = trng.uniform(seed, (len(VIEW_DRAWS), N), "cpu")
    assert torch.equal(view["scale"], 0.6 + (1.0 - 0.6) * u[0]) and torch.equal(view["off_y"], u[2])
    assert torch.equal(view["flip_v"], u[4] < 0.5) and torch.equal(view["contrast"], 0.8 + 0.4 * u[6])
    assert view["scale"].min() >= 0.6 and view["brightness"].abs().max() <= 0.2
    again = draw_view(N, 0.6, torch.tensor(seed), "cpu")
    assert all(torch.equal(again[k], view[k]) for k in VIEW_DRAWS)
    images = np.random.RandomState(2).rand(N, SIZE, SIZE, 3).astype(np.float32)
    tr = _ssl()
    s0 = _warm(tr.init_state())
    views = {v: draw_view(N, tr.cfg.crop_scale_min, tr.seeds.seed("ssl", s0.step, i), "cpu")
             for i, v in enumerate("ab")}
    drawn, given = copy.deepcopy(s0), copy.deepcopy(s0)
    _assert_metrics(tr.train_step_eager(drawn, images)[1], tr.train_step_eager(given, images, views)[1])
    _assert_same(drawn, given)


def test_simclr_fit_on_a_tensor_corpus_is_the_host_corpus():
    """``fit`` on a corpus held as a tensor on the trainer's device (index
    tables) against the numpy corpus (batch tables, one step a chunk)."""
    images = np.random.RandomState(3).rand(20, SIZE, SIZE, 3).astype(np.float32)
    tr = _ssl()
    s0 = _warm(tr.init_state())
    host, res_host = tr.fit(images, num_epochs=2, state=copy.deepcopy(s0))
    dev, res_dev = tr.fit(torch.from_numpy(images), num_epochs=2, state=copy.deepcopy(s0))
    assert res_host == res_dev and len(res_host["history"]) == 2
    _assert_same(host, dev)
    assert host.step == 5 + 2 * 2  # 20 tiles: 2 full batches of 8 an epoch


# ------------------------------------------------------------------- fusion


def _fusion():
    return FusionTrainer(FusionConfig(batch_size=4, rna_hidden_dims=(16, 8)), backbone=TINY, device="cpu")


def _bags(seed=13, n=N):
    rng = np.random.RandomState(seed)
    bags = rng.randint(0, 255, (n, 2, SIZE, SIZE, 3), dtype=np.uint8)
    labels = (np.arange(n) % 2).astype(np.int64)
    slide_idx = (np.arange(n) % 4).astype(np.int32)
    return BagData(bags, labels, slide_idx, ["a", "b", "c", "d"], rng.randn(4, GENES).astype(np.float32))


@pytest.mark.parametrize("given", [True, False])
def test_fusion_body_is_the_eager_step(given):
    """The fusion train body against ``train_step_eager``: metrics, every
    state tensor and the moments of the trainable tensors bit-equal, the
    frozen parameters bit-unchanged; the eval body against ``eval_step``."""
    data = _bags()
    tr = _fusion()
    s0 = _warm(tr.init_state(data.bags.shape[1:], GENES))
    idx = np.array([1, 4, 6, 7])
    mask = np.array([1, 1, 1, 0], np.float32)
    bags, rna, labels = data.bags[idx], data.rna[data.slide_idx[idx]], data.labels[idx]
    keep = np.random.RandomState(3).rand(4, GENES) < 0.5
    eager, body = copy.deepcopy(s0), copy.deepcopy(s0)
    frozen = {n: p.detach().clone() for n, p in s0.model.named_parameters() if not p.requires_grad}
    _, m_eager = tr.train_step_eager(eager, bags, rna, labels, mask, {"keep": keep} if given else None)
    tables = {"bags": torch.from_numpy(bags)[None], "rna": torch.from_numpy(rna)[None],
              "labels": torch.from_numpy(labels)[None], "mask": torch.from_numpy(mask)[None]}
    rows = _body_rows(tr, body, tables, torch.from_numpy(keep) if given else None)
    m_body = _run_body(tr, body, tr._host_prepare(4, shard=True), rows)
    _assert_metrics(m_body, m_eager)
    _assert_same(body, eager)
    assert len(body.opt.mu) == len(trainable_names(body.model, True)) and len(frozen) == 18
    for n, p in body.model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    (pred,) = tr._body("eval", body, tr._host_prepare(4, shard=False))(
        None, {"bags": torch.from_numpy(bags), "rna": torch.from_numpy(rna)})
    assert torch.equal(pred, tr.eval_step(eager, bags, rna))


def test_fusion_drawn_mask_is_the_seed_rows():
    """The eager step's dropout mask is ``draw_keep(seed("fusion", step))``
    over the batch's (bags, genes); the model draws the same mask from the
    seed, as an int or as a device tensor."""
    data = _bags()
    tr = _fusion()
    s0 = _warm(tr.init_state(data.bags.shape[1:], GENES))
    seed = tr.seeds.seed("fusion", s0.step)
    rate = s0.model.rna_encoder.encoder[0].rate
    assert rate > 0
    keep = draw_keep(seed, (4, GENES), rate, "cpu")
    assert torch.equal(keep, draw_keep(torch.tensor([seed]), (4, GENES), rate, "cpu"))
    idx = np.arange(4)
    args = (data.bags[idx], data.rna[data.slide_idx[idx]], data.labels[idx], np.ones(4, np.float32))
    drawn, given = copy.deepcopy(s0), copy.deepcopy(s0)
    _assert_metrics(tr.train_step_eager(drawn, *args)[1], tr.train_step_eager(given, *args, {"keep": keep})[1])
    _assert_same(drawn, given)
    x, r = tr._inputs(args[0], args[1])
    model = copy.deepcopy(s0.model).train()
    with torch.no_grad():
        by_keep = copy.deepcopy(model)(x, r, keep)
        assert torch.equal(copy.deepcopy(model)(x, r, seed=seed), by_keep)
        assert torch.equal(copy.deepcopy(model)(x, r, seed=torch.tensor(seed)), by_keep)


def test_fusion_fit_and_predict_in_chunks_are_one_chunk(monkeypatch):
    data = _bags(n=10)  # 3 batches of 4, the last padded
    tr = _fusion()
    s0 = _warm(tr.init_state(data.bags.shape[1:], GENES))
    one, res_one = tr.fit(data, num_epochs=2, state=copy.deepcopy(s0))
    pred_one = tr.predict(data, one)
    monkeypatch.setattr(step_graph, "CHUNK_BYTES", 1)
    many, res_many = tr.fit(data, num_epochs=2, state=copy.deepcopy(s0))
    assert res_one == res_many and many.step == 5 + 2 * 3
    _assert_same(one, many)
    assert pred_one.shape == (10,) and np.array_equal(pred_one, tr.predict(data, many))


# ---------------------------------------------------------------- AdamW's table


def test_adamw_plan_rows_are_the_host_corrections():
    opt = AdamW([torch.zeros(3)], lr=3e-5, weight_decay=0.01)
    opt.count = 4
    rows = opt.plan(6)
    assert rows.dtype == torch.float32 and rows.shape == (6, 2) and opt.count == 4
    for i in range(6):
        c1, c2 = bias_corrections(5 + i, 0.9, 0.999)
        assert rows[i, 0].item() == c1 and rows[i, 1].item() == c2


def test_k3_plain_with_a_corr_tensor_and_decay_is_the_host_floats():
    g = torch.Generator().manual_seed(0)
    shapes = [(64, 3, 3, 3), (64,), (2, 512), (2,)]
    make = lambda: [[torch.randn(s, generator=g) * 1e-2 for s in shapes] for _ in range(2)]  # noqa: E731
    params, grads = make()
    mus = [torch.randn(s, generator=g) * 1e-3 for s in shapes]
    nus = [torch.rand(s, generator=g) * 1e-2 for s in shapes]
    a = [[t.clone() for t in ts] for ts in (params, grads, mus, nus)]
    b = [[t.clone() for t in ts] for ts in (params, grads, mus, nus)]
    c1, c2 = bias_corrections(6, 0.9, 0.999)
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    adam_update_plain(*a, None, None, 3e-5, corr=torch.tensor([c1, c2], dtype=torch.float32), **hp)
    adam_update_plain(*b, c1, c2, 3e-5, **hp)
    for xs, ys in zip(a, b):
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)
    assert not torch.equal(a[0][0], params[0])
