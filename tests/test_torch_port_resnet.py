"""The port's ResNet family and downstream ML experiment against the JAX package on the CPU.

Both packages get the same weights (flax trees moved by
``rnagan_tpu_torch.convert``), the same inputs (numpy, seeded) and the same
random draws: the flips and ``fit_resident``'s permutation are recomputed
here from the JAX trainer's own keys (``step_key(base_key, step)`` and the
``jax.random`` calls of ``_augment``; ``fold_in(base_key, 10_000 + epoch)``)
and handed to the port as ``draws``. Training parity starts from a JAX state
advanced 5 AdamW steps (Adam's first step is sign(g)*lr and amplifies ulps),
at float32 on a one-device mesh.

Tolerances: eval forwards within 1e-5 of the reference's largest value plus
1e-6; train-mode forwards 2e-5 of it plus 1e-6 (each BatchNorm divides by
the standard deviation of 8 values at the last stage's 1x1 map: at the
Bottleneck case the JAX package's own float32 logits lie 1.2e-5 of their
largest value from a float64 forward of the same weights, the port's 3e-6);
a step's loss 1e-5 relative; parameters and BatchNorm statistics 1e-5
relative plus 1e-6 of each tensor's largest value, AdamW moments 1e-5 plus
1e-5 (the existing Adam and VAE tests' tolerances: XLA and PyTorch sum the
gradients in other orders); folds, F1, predictions and counts exactly.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rnagan_tpu.cli import ml_experiment as jcli
from rnagan_tpu.core.config import MeshConfig
from rnagan_tpu.core.rng import step_key
from rnagan_tpu.models import resnet as jresnet
from rnagan_tpu.parallel.mesh import make_mesh
from rnagan_tpu.train import ml_experiment as jml
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.cli import main as tmain
from rnagan_tpu_torch.core.config import MLConfig
from rnagan_tpu_torch.models import resnet as tresnet
from rnagan_tpu_torch.train import ml_experiment as tml

SIZE, N = 16, 8
BLOCKS = {"basic": (jresnet.BasicBlock, tresnet.BasicBlock), "bottleneck": (jresnet.Bottleneck, tresnet.Bottleneck)}
#: MLConfig's own AdamW rate and decay (3e-5, 0.01)
ML_KW = dict(num_epochs=1, batch_size=N, folds=2, image_size=SIZE)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, ref, rtol=1e-5, scaled=1e-6, atol=0.0, msg=""):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, msg
    bound = atol + (scaled * float(np.abs(ref).max()) if ref.size else 0.0)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=bound, err_msg=msg)


def _forward_close(got, ref, msg="", scaled=1e-5):
    """Within ``scaled`` of the reference's largest value plus 1e-6."""
    _close(got, ref, rtol=0.0, scaled=scaled, atol=1e-6, msg=msg)


def _models(block="basic", **kw):
    jb, tb = BLOCKS[block]
    kw = {"num_classes": 2, "compute_dtype": "float32", **kw}
    return jresnet.ResNet(jb, (1, 1, 1, 1), **kw), functools.partial(tresnet.ResNet, tb, (1, 1, 1, 1), **kw)


def _randomize(variables, rng):
    """BatchNorm scales, biases and running statistics drawn away from 1/0/0/1."""
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name or "'var'" in name:
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        if "'bias'" in name or "'mean'" in name:
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(draw, variables)


def _port(tmodel, variables):
    m = tmodel(device="cpu")
    m.load_state_dict(convert.resnet_state_dict_from_jax(m, variables))
    return m


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("block,channels,project", [("basic", 3, 0), ("basic", 1, 0), ("basic", 4, 0),
                                                    ("bottleneck", 3, 0), ("basic", 3, 8)])
def test_forward_train_eval_extract_match_flax(rng, block, channels, project):
    """Eval logits and features, train logits and the new BatchNorm
    statistics, for BasicBlock/Bottleneck, 1/3/4 input channels and a
    projection head."""
    jm, tm = _models(block, in_channels=channels, project_dim=project)
    variables = _randomize(jresnet.init_resnet(jm, jax.random.key(0), SIZE), rng)
    x = rng.rand(N, SIZE, SIZE, channels).astype(np.float32)
    port = _port(tm, variables).eval()
    with torch.no_grad():
        _forward_close(_np(port(_nchw(x))), jm.apply(variables, x, train=False), "eval logits")
        feats = port(_nchw(x), extract=True)
    assert feats.dtype == torch.float32 and feats.shape == (N, port.out_features)
    assert port.out_features == project or (512 if block == "basic" else 2048)
    _forward_close(_np(feats), jm.apply(variables, x, train=False, extract=True), "features")
    ref, upd = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port.train()(_nchw(x))
    _forward_close(_np(got), ref, "train logits", scaled=2e-5)
    moved = convert.resnet_state_dict_from_jax(port, {**variables, "batch_stats": upd["batch_stats"]})
    for k, v in port.state_dict().items():
        if "running_" in k:
            _close(_np(v), _np(moved[k]), msg=k)


def test_bfloat16_forward_tracks_float32(rng):
    """bfloat16 compute (the default) returns float32 logits near the float32 ones."""
    jm, tm = _models()
    variables = jresnet.init_resnet(jm, jax.random.key(1), SIZE)
    x = _nchw(rng.rand(4, SIZE, SIZE, 3).astype(np.float32))
    f32 = _port(tm, variables).eval()
    bf16 = _port(functools.partial(tm, compute_dtype="bfloat16"), variables).eval()
    with torch.no_grad():
        a, b = f32(x), bf16(x)
    assert b.dtype == torch.float32
    _close(_np(b), _np(a), rtol=0.0, scaled=5e-2)


def test_resnet50_keys_map_onto_the_flax_tree():
    """Every state_dict key of the port's ResNet50 (torchvision's names) maps
    onto one leaf of the JAX ResNet50's tree, of the right shape, and every
    leaf is reached; 161 parameter tensors, 23,512,130 parameters at 2 classes."""
    tm = tresnet.resnet50(num_classes=2, device="meta")
    shapes = jax.eval_shape(lambda: jresnet.init_resnet(jresnet.resnet50(num_classes=2), jax.random.key(0), 32))
    reached = set()
    for key, t in tm.state_dict().items():
        leaf = convert.resnet_flax_leaf(key)
        if leaf is None:
            assert key.endswith("num_batches_tracked")
            continue
        col, path, kind = leaf
        ref = shapes[col]
        for p in path:
            ref = ref[p]
        want = {"conv": lambda s: (s[3], s[2], s[0], s[1]), "dense": lambda s: s[::-1]}.get(kind, lambda s: s)
        assert tuple(t.shape) == tuple(want(ref.shape)), key
        reached.add((col, path))
    assert len(reached) == len(jax.tree_util.tree_leaves(shapes))
    params = list(tm.parameters())
    assert len(params) == 161 and sum(p.numel() for p in params) == 23_512_130
    for key in ("layer1.0.downsample.0.weight", "layer4.2.bn3.running_var", "fc.bias", "bn1.num_batches_tracked"):
        assert key in tm.state_dict()


@pytest.mark.parametrize("channels,classes", [(3, 5), (1, 5), (4, 5), (3, 2)])
def test_torchvision_state_dict_matches_params_from_torch_state_dict(rng, channels, classes):
    """A torchvision-layout ResNet18 state_dict (5 classes) through the port's
    ``state_dict_from_torchvision`` and the JAX ``params_from_torch_state_dict``:
    the same input-channel surgery, ``fc`` kept only at 5 classes, the same
    eval forward."""
    src = tresnet.resnet18(num_classes=5, compute_dtype="float32", seed=3)
    with torch.no_grad():
        for k, v in src.state_dict().items():
            if "running_var" in k:
                v.uniform_(0.5, 1.5)
            elif "running_mean" in k:
                v.normal_(0.0, 0.1)
    sd = src.state_dict()
    jm = jresnet.resnet18(num_classes=classes, in_channels=channels, compute_dtype="float32")
    jvars = jresnet.params_from_torch_state_dict(jm, {k: v.numpy() for k, v in sd.items()})
    tm = tresnet.resnet18(num_classes=classes, in_channels=channels, compute_dtype="float32")
    moved = tresnet.state_dict_from_torchvision(tm, sd)
    assert ("fc.weight" in moved) == (classes == 5) == ("fc" in jvars["params"])
    np.testing.assert_allclose(_np(moved["conv1.weight"]),
                               jvars["params"]["conv1"]["kernel"].transpose(3, 2, 0, 1), rtol=1e-7)
    if classes != 5:  # the JAX overlay leaves the initialized head: give both the same one
        jvars["params"]["fc"] = {"kernel": rng.randn(512, classes).astype(np.float32) * 0.05,
                                 "bias": np.zeros(classes, np.float32)}
        moved["fc.weight"] = torch.from_numpy(jvars["params"]["fc"]["kernel"].T.copy())
        moved["fc.bias"] = torch.zeros(classes)
    tm.load_state_dict(moved, strict=True)
    x = rng.rand(2, 32, 32, channels).astype(np.float32)
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    _forward_close(_np(got), jm.apply(jvars, x, train=False))


# ------------------------------------------------------------ folds and F1


@pytest.mark.parametrize("seed,n_folds", [(0, 5), (99, 2), (7, 3)])
def test_stratified_folds_and_weighted_f1_equal_jax(rng, seed, n_folds):
    labels = rng.randint(0, 3, 61)
    for (ta, va), (tb, vb) in zip(tml.stratified_folds(labels, n_folds, seed),
                                  jml.stratified_folds(labels, n_folds, seed), strict=True):
        assert np.array_equal(ta, tb) and np.array_equal(va, vb)
    pred = rng.randint(0, 3, 61)
    assert tml.weighted_f1(labels, pred, 3) == jml.weighted_f1(labels, pred, 3)
    assert tml.weighted_f1(labels, np.zeros(61, int), 3) == jml.weighted_f1(labels, np.zeros(61, int), 3)


# ------------------------------------------------------------ the trainer


def _jax_trainer(**kw):
    jm, _ = _models()
    cfg = jml.MLConfig(**{**ML_KW, **kw}, mesh=MeshConfig(data=1, model=1))
    return jml.TileClassifierTrainer(cfg, model=jm, mesh=make_mesh(cfg.mesh, devices=jax.devices()[:1]))


def _port_trainer(**kw):
    _, tm = _models()
    return tml.TileClassifierTrainer(MLConfig(**{**ML_KW, **kw}), model=tm, device="cpu")


def _copy(state):
    return jax.tree_util.tree_map(np.array, state)


def _flips(base_key, step, n=N):
    kh, kv = jax.random.split(step_key(base_key, step))
    return {"flip_h": np.asarray(jax.random.bernoulli(kh, 0.5, (n, 1, 1, 1))).reshape(n),
            "flip_v": np.asarray(jax.random.bernoulli(kv, 0.5, (n, 1, 1, 1))).reshape(n)}


@pytest.fixture(scope="module")
def ml_data():
    rng = np.random.RandomState(5)
    images = rng.rand(24, SIZE, SIZE, 3).astype(np.float32)
    labels = (np.arange(24) % 2).astype(np.int64)
    images[labels == 1] *= 0.5
    return images, labels


@pytest.fixture(scope="module")
def ml_state5(ml_data):
    """The JAX trainer's state after 5 steps on the data's first 8 tiles
    (numpy leaves)."""
    images, labels = ml_data
    jt = _jax_trainer()
    state = jt.init_state()
    mask = np.ones(N, np.float32)
    for k in range(5):
        idx = (np.arange(N) + 3 * k) % 24
        state, _ = jt._train_step(state, jnp.asarray(images[idx]), jnp.asarray(labels[idx], jnp.int32),
                                  jnp.asarray(mask))
    return _copy(state)


def _assert_state_close(tt, pstate, jstate):
    assert pstate.step == int(jstate.step) and pstate.opt.count == int(jstate.opt_state[0].count)
    ref = convert.resnet_state_dict_from_jax(pstate.model, {"params": jstate.params,
                                                            "batch_stats": jstate.batch_stats})
    for k, v in pstate.model.state_dict().items():
        _close(_np(v), _np(ref[k]), msg=k)
    names = [n for n, _ in pstate.model.named_parameters()]
    moments = convert.adamw_state_from_jax(names, jstate.opt_state)
    for name, got, want in zip(names * 2, [*pstate.opt.mu, *pstate.opt.nu], [*moments["mu"], *moments["nu"]]):
        _close(_np(got), _np(want), scaled=1e-5, msg=name)


def test_train_step_from_step_5_matches_jax(ml_data, ml_state5):
    """One AdamW step with given flips and a padded (masked) row: loss,
    accuracy, parameters, BatchNorm statistics, moments and counts."""
    images, labels = ml_data
    jt, tt = _jax_trainer(), _port_trainer()
    idx = np.arange(N) + 9
    mask = np.r_[np.ones(N - 1), 0.0].astype(np.float32)
    draws = _flips(jt._base_key, 5)
    pstate = tt.state_from_jax(ml_state5)
    jstate, jm = jt._train_step(jax.device_put(_copy(ml_state5)), jnp.asarray(images[idx]),
                                jnp.asarray(labels[idx], jnp.int32), jnp.asarray(mask))
    pstate, pm = tt.train_step(pstate, images[idx], labels[idx], mask, draws=draws)
    _close(float(pm["loss"]), float(jm["loss"]))
    assert float(pm["acc"]) == float(jm["acc"])
    _assert_state_close(tt, pstate, _copy(jstate))


def test_predict_and_evaluate_equal_jax(ml_data, ml_state5):
    images, labels = ml_data
    jt, tt = _jax_trainer(batch_size=5), _port_trainer(batch_size=5)  # a padded last batch
    pstate = tt.state_from_jax(ml_state5)
    jstate = jax.device_put(_copy(ml_state5))
    assert np.array_equal(tt.predict(images, pstate), jt.predict(images, jstate))
    assert tt.evaluate(images, labels, pstate) == jt.evaluate(images, labels, jstate)
    u8 = (images * 255).astype(np.uint8)
    assert np.array_equal(tt.predict_resident(u8, pstate), jt.predict_resident(jnp.asarray(u8), jstate))


def test_fit_resident_with_given_permutation_matches_jax(ml_data, ml_state5):
    """One epoch of ``fit_resident`` over 16 uint8 tiles (2 steps) from the
    step-5 state, the JAX epoch's permutation and flips handed in: the
    epoch's state, its loss and accuracy, and the validation accuracy."""
    images, labels = ml_data
    u8 = (images * 255).astype(np.uint8)
    jt, tt = _jax_trainer(), _port_trainer()
    perm = np.asarray(jax.random.permutation(jax.random.fold_in(jt._base_key, 10_000), 16))
    draws = {"perms": [perm], "flips": [_flips(jt._base_key, 5), _flips(jt._base_key, 6)]}
    jstate, jres = jt.fit_resident(u8[:16], labels[:16], u8[16:], labels[16:],
                                   state=jax.device_put(_copy(ml_state5)))
    pstate, pres = tt.fit_resident(u8[:16], labels[:16], u8[16:], labels[16:],
                                   state=tt.state_from_jax(ml_state5), draws=draws)
    (jh,), (ph,) = jres["history"], pres["history"]
    _close(ph["loss"], jh["loss"])
    assert ph["acc"] == jh["acc"] and ph["val_acc"] == jh["val_acc"]
    _assert_state_close(tt, pstate, _copy(jstate))


def test_fit_keeps_a_copy_of_the_best_state(ml_data):
    """``fit`` returns the best-on-val state as a copy the next epoch does
    not touch, its history as the JAX loop logs it."""
    images, labels = ml_data
    tt = _port_trainer(num_epochs=2)
    best, res = tt.fit(images[:16], labels[:16], images[16:], labels[16:])
    assert [sorted(h) for h in res["history"]] == [["acc", "loss", "val_acc"]] * 2
    assert res["best_val_acc"] == max(h["val_acc"] for h in res["history"])
    assert best.step in (2, 4)


# ------------------------------------------------------------------ the CLI


def _jpeg_corpus(root, rng):
    rows = ["wsi_file_name,label"]
    for i in range(8):
        cls = "GBM" if i % 2 else "LUAD"
        base = 200 if cls == "GBM" else 40
        tile = np.clip(base + rng.randn(24, 24, 3) * 20, 0, 255).astype(np.uint8)
        path = os.path.join(root, f"t{i}.jpeg")
        Image.fromarray(tile).save(path, quality=95)
        rows.append(f"{path},{cls}")
    csv = os.path.join(root, "tiles.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv


def _separating_weights(csv):
    """A ResNet50 (2 classes, seeded) whose ``fc`` separates the corpus's two
    classes by a wide margin in bfloat16, so both packages' predictions are
    far from a tie."""
    images, labels, _ = jcli._load_tiles_csv(csv, "wsi_file_name", "label", SIZE, None, 99)
    model = tresnet.resnet50(num_classes=2, seed=11)
    x = (torch.from_numpy(images) - torch.from_numpy(tml.IMAGENET_MEAN)) / torch.from_numpy(tml.IMAGENET_STD)
    with torch.no_grad():
        f = model.eval()(x.permute(0, 3, 1, 2), extract=True).double()
    d = f[labels == 0].mean(0) - f[labels == 1].mean(0)
    proj = f @ d
    lo, hi = float(proj[labels == 0].min()), float(proj[labels == 1].max())
    assert lo > hi, "the corpus's classes do not separate on the seeded features"
    scale = 20.0 / (lo - hi)
    w = (d * scale / 2).float()
    with torch.no_grad():
        model.fc.weight.copy_(torch.stack([w, -w]))
        model.fc.bias.copy_(torch.tensor([-1.0, 1.0]) * float((lo + hi) / 2 * scale / 2))
    return model.state_dict()


def test_cli_matches_jax_cli(tmp_path, monkeypatch):
    """``main ml-experiment`` (no longer exit code 2) against the JAX CLI on a
    tiny JPEG corpus, ``--num_epochs 0`` from the same ``--backbone_weights``:
    every fold's accuracy and F1 equal, the same pickle keys and classes."""
    csv = _jpeg_corpus(str(tmp_path), np.random.RandomState(2))
    weights = str(tmp_path / "w.pt")
    torch.save(_separating_weights(csv), weights)
    common = ["--csv", csv, "--num_epochs", "0", "--folds", "2", "--batch_size", "4", "--image_size",
              str(SIZE), "--backbone_weights", weights]
    monkeypatch.chdir(tmp_path)  # the JAX CLI points its compilation cache at the working directory
    jcli.main([*common, "--save_path", str(tmp_path / "jax.pkl"), "--platform", "cpu"])
    assert tmain.main(["ml-experiment", *common, "--save_path", str(tmp_path / "port.pkl"),
                       "--device", "cpu"]) == 0
    with open(tmp_path / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(ref) and got["classes"] == list(ref["classes"]) == ["LUAD", "GBM"]
    assert got["folds"] == ref["folds"]
    assert got["mean_accuracy"] == ref["mean_accuracy"] and got["mean_weighted_f1"] == ref["mean_weighted_f1"]
    assert tmain.COMMANDS["ml-experiment"][0] == "rnagan_tpu_torch.cli.ml_experiment"


@pytest.mark.parametrize("max_tiles", [3, 5])
def test_cli_keeps_the_rows_pandas_samples(tmp_path, max_tiles):
    """``--max_tiles`` keeps the rows (and their order) of
    ``df.sample(k, random_state=seed)``, labelled as ``pd.factorize`` labels them."""
    from rnagan_tpu_torch.cli import ml_experiment as tcli

    csv = _jpeg_corpus(str(tmp_path), np.random.RandomState(4))
    a = tcli._load_tiles_csv(csv, "wsi_file_name", "label", 8, max_tiles, 99)
    b = jcli._load_tiles_csv(csv, "wsi_file_name", "label", 8, max_tiles, 99)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == list(b[2])
