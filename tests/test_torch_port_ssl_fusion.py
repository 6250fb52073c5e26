"""The port's SimCLR pre-training, bag fusion and bag readers against the JAX package on the CPU.

Weights move by ``rnagan_tpu_torch.convert``; inputs are numpy, seeded. The
draws are handed in: SimCLR's seven draws a view are recomputed from the JAX
step's key (``step_key(base_key, step)``, then ``augment_views``' own
``jax.random.split`` calls) and passed to the port; the fusion step's
dropout mask replaces flax's through ``flax.linen.intercept_methods`` inside
a ``jax.jit`` that takes it as an argument (the JAX package is not touched).
Training parity starts from a JAX state advanced 5 AdamW steps, at float32
on a one-device mesh, at each trainer's own rate and decay.

Tolerances: augmentation within 1e-6 (values in [0, 1]); NT-Xent 1e-6
relative; a step's loss 1e-5 relative; parameters and BatchNorm statistics
1e-5 relative plus 1e-6 of each tensor's largest value, AdamW moments 1e-5
plus 1e-5 (the existing Adam and VAE tests' tolerances); frozen parameters,
masks and bags exactly. The RNA encoder's Dense biases feed a train-mode
BatchNorm, which subtracts the batch mean: their gradient is 0 but for
rounding noise of the sums behind the Dense kernel's gradient, so the bias
and its moments are held to the kernel's scale (``_scale_of`` over the
model's ``pre_norm_biases()``, as ``test_torch_port_train_archs.py::_grad_scale``
holds ``dcgan_up``'s).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from flax import linen as nn
from PIL import Image

from rnagan_tpu.core.config import MeshConfig
from rnagan_tpu.core.rng import step_key
from rnagan_tpu.data import patches as jpatches
from rnagan_tpu.data.tiles import tiles_to_float
from rnagan_tpu.models import fusion as jfusion_models
from rnagan_tpu.models import resnet as jresnet
from rnagan_tpu.parallel.mesh import make_mesh
from rnagan_tpu.train import fusion_trainer as jfusion
from rnagan_tpu.train import ml_experiment as jml
from rnagan_tpu.train import ssl_trainer as jssl
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core.config import MLConfig
from rnagan_tpu_torch.data import patches as tpatches
from rnagan_tpu_torch.data.rna import RNATable
from rnagan_tpu_torch.data.store import LMDBTileWriter
from rnagan_tpu_torch.models import fusion as tfusion_models
from rnagan_tpu_torch.models import resnet as tresnet
from rnagan_tpu_torch.train import fusion_trainer as tfusion
from rnagan_tpu_torch.train import ml_experiment as tml
from rnagan_tpu_torch.train import ssl_trainer as tssl

SIZE, N, GENES = 16, 8, 12
MESH = MeshConfig(data=1, model=1)
JBB = jresnet.ResNet(jresnet.BasicBlock, (1, 1, 1, 1), compute_dtype="float32")
TBB = functools.partial(tresnet.ResNet, tresnet.BasicBlock, (1, 1, 1, 1), compute_dtype="float32")
SSL_KW = dict(batch_size=N, image_size=SIZE, projection_hidden=32, projection_dim=16)
FUSION_KW = dict(batch_size=4, rna_hidden_dims=(16, 8))


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


def _copy(state):
    return jax.tree_util.tree_map(np.array, state)


def _mesh():
    return make_mesh(MESH, devices=jax.devices()[:1])


def _scale_of(name, tensors, kernels):
    """The largest value a tensor's rounding acts on: its own, or for a Dense
    bias ahead of a train-mode BatchNorm (a key of ``kernels``, the model's
    ``pre_norm_biases()``) its kernel's."""
    return float(tensors[kernels.get(name, name)].abs().max())


def _assert_state_close(pstate, jstate, names, kernels=None):
    """Parameters and statistics of the whole model; the moments of ``names``."""
    kernels = kernels or {}
    assert pstate.step == int(jstate.step)
    ref = convert.resnet_state_dict_from_jax(pstate.model, {"params": jstate.params,
                                                            "batch_stats": jstate.batch_stats})
    for k, v in pstate.model.state_dict().items():
        _close(_np(v), _np(ref[k]), scaled=0.0, atol=1e-6 * _scale_of(k, ref, kernels), msg=k)
    moments = convert.adamw_state_from_jax(names, jstate.opt_state)
    assert pstate.opt.count == moments["count"]
    for got_list, want_list in ((pstate.opt.mu, moments["mu"]), (pstate.opt.nu, moments["nu"])):
        want = dict(zip(names, want_list))
        for name, got in zip(names, got_list):
            _close(_np(got), _np(want[name]), scaled=0.0, atol=1e-5 * _scale_of(name, want, kernels), msg=name)


# ------------------------------------------------------------ the forwards


def _randomize(variables, rng):
    """BatchNorm statistics and every bias drawn away from 0/1, so eval mode
    and the heads' biases are exercised."""
    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name or "'scale'" in name:
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        if "'bias'" in name or "'mean'" in name:
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("model", ["aggregation", "fusion", "simclr"])
def test_bag_and_simclr_forwards_match_flax(rng, model):
    """Eval forwards of ``AggregationModel``, ``FusionModel`` (bag mean, the
    RNA encoder, ``fuse`` + ReLU, ``head``) and SimCLR's backbone + projection,
    within 1e-5 of the reference's largest value plus 1e-6."""
    bags = rng.rand(3, 2, SIZE, SIZE, 3).astype(np.float32)
    rna = rng.randn(3, GENES).astype(np.float32)
    if model == "aggregation":
        jm = jfusion_models.AggregationModel(JBB, num_classes=3)
        args = (bags,)
        port = tfusion_models.AggregationModel(TBB(num_classes=0), num_classes=3)
    elif model == "fusion":
        jm = jfusion_models.FusionModel(JBB, rna_hidden_dims=(16, 8), num_classes=2)
        args = (bags, rna)
        port = tfusion_models.FusionModel(TBB(num_classes=0), GENES, (16, 8), 2)
    else:
        jm = jssl.SimCLRTrainer(jssl.SSLConfig(**SSL_KW, mesh=MESH), backbone=JBB, mesh=_mesh()).model
        args = (bags[:, 0],)
        port = tssl.SimCLRModel(TBB(num_classes=0), 32, 16)
    variables = _randomize(jm.init(jax.random.key(0), *args, train=False), rng)
    port.load_state_dict(convert.resnet_state_dict_from_jax(port, variables))
    ref = jm.apply(variables, *args, train=False)
    targs = [torch.from_numpy(a) for a in args]
    if model == "simclr":
        targs = [targs[0].permute(0, 3, 1, 2)]
    with torch.no_grad():
        got = port.eval()(*targs)
    assert got.dtype == torch.float32
    _close(_np(got), ref, rtol=0.0, scaled=1e-5, atol=1e-6)


# ------------------------------------------------------------------ SimCLR


def _view_draws(key, n, scale_min):
    """The values ``augment_views(key, ...)`` draws, as the port takes them."""
    kc, kh, kv, kb, kk = jax.random.split(key, 5)
    ks, kx, ky = jax.random.split(kc, 3)
    shape3, shape4 = (n, 1, 1), (n, 1, 1, 1)
    draws = {"scale": jax.random.uniform(ks, shape3, minval=scale_min, maxval=1.0),
             "off_x": jax.random.uniform(kx, shape3), "off_y": jax.random.uniform(ky, shape3),
             "flip_h": jax.random.bernoulli(kh, 0.5, shape4), "flip_v": jax.random.bernoulli(kv, 0.5, shape4),
             "brightness": jax.random.uniform(kb, shape4, minval=-0.2, maxval=0.2),
             "contrast": jax.random.uniform(kk, shape4, minval=0.8, maxval=1.2)}
    return {k: np.asarray(v).reshape(n) for k, v in draws.items()}


@pytest.mark.parametrize("n,temperature", [(8, 0.5), (6, 0.1)])
def test_nt_xent_matches_jax(rng, n, temperature):
    z = rng.randn(n, 16).astype(np.float32)
    z[n // 2:] = z[: n // 2] + rng.randn(n // 2, 16).astype(np.float32) * 0.3  # positives near their pairs
    loss, acc = tssl.nt_xent_loss(torch.from_numpy(z), temperature)
    jloss, jacc = jssl.nt_xent_loss(jnp.asarray(z), temperature)
    _close(float(loss), float(jloss), rtol=1e-6)
    assert float(acc) == float(jacc)


@pytest.mark.parametrize("size", [16, 23])
def test_random_resized_crop_matches_jax(rng, size):
    images = rng.rand(5, size, size, 3).astype(np.float32)
    key = jax.random.key(7)
    ref = jssl._random_resized_crop(key, jnp.asarray(images), 0.6)
    ks, kx, ky = jax.random.split(key, 3)
    scale = np.asarray(jax.random.uniform(ks, (5, 1, 1), minval=0.6, maxval=1.0)).reshape(5)
    ox, oy = (np.asarray(jax.random.uniform(k, (5, 1, 1))).reshape(5) for k in (kx, ky))
    got = tssl._random_resized_crop(torch.from_numpy(images), torch.from_numpy(scale), torch.from_numpy(ox),
                                    torch.from_numpy(oy))
    _close(_np(got), ref, rtol=0.0, atol=1e-6)
    assert np.array_equal(_np(tssl.unit_linspace(size, "cpu")), np.asarray(jnp.linspace(0.0, 1.0, size)))


def test_augment_views_match_jax(rng):
    images = rng.rand(N, SIZE, SIZE, 3).astype(np.float32)
    key = jax.random.key(3)
    ref = jssl.augment_views(key, jnp.asarray(images), 0.6)
    got = tssl.augment_views(torch.from_numpy(images), _view_draws(key, N, 0.6))
    _close(_np(got), ref, rtol=0.0, atol=1e-6)


def _ssl_trainers():
    jt = jssl.SimCLRTrainer(jssl.SSLConfig(**SSL_KW, mesh=MESH), backbone=JBB, mesh=_mesh())
    return jt, tssl.SimCLRTrainer(tssl.SSLConfig(**SSL_KW), backbone=TBB, device="cpu")


@pytest.fixture(scope="module")
def ssl_data():
    return np.random.RandomState(11).rand(N, SIZE, SIZE, 3).astype(np.float32)


@pytest.fixture(scope="module")
def ssl_state5(ssl_data):
    jt, _ = _ssl_trainers()
    state = jt.init_state()
    for k in range(5):
        state, _ = jt._train_step(state, jnp.asarray(np.roll(ssl_data, k, axis=0)))
    return _copy(state)


def test_simclr_step_from_step_5_matches_jax(ssl_data, ssl_state5):
    """One SimCLR step (views A and B with the JAX step's draws, BatchNorm
    over the 2N views, NT-Xent, AdamW at SSLConfig's 1e-3 and 1e-6)."""
    jt, tt = _ssl_trainers()
    ka, kb = jax.random.split(step_key(jt._base_key, 5))
    draws = {"a": _view_draws(ka, N, 0.6), "b": _view_draws(kb, N, 0.6)}
    pstate = tt.state_from_jax(ssl_state5)
    jstate, jm = jt._train_step(jax.device_put(_copy(ssl_state5)), jnp.asarray(ssl_data))
    pstate, pm = tt.train_step(pstate, ssl_data, draws=draws)
    _close(float(pm["loss"]), float(jm["loss"]))
    assert float(pm["contrastive_acc"]) == float(jm["contrastive_acc"])
    _assert_state_close(pstate, _copy(jstate), [n for n, _ in pstate.model.named_parameters()])


def test_backbone_handoff_matches_jax(ssl_data, ssl_state5):
    """SimCLR's backbone overlaid on a fresh classifier: every backbone entry
    as the JAX handoff leaves it (the heads are each package's own init),
    and the classifier steps."""
    jt, tt = _ssl_trainers()
    jm = jresnet.ResNet(jresnet.BasicBlock, (1, 1, 1, 1), num_classes=2, compute_dtype="float32")
    jcls = jml.TileClassifierTrainer(jml.MLConfig(batch_size=N, image_size=SIZE, mesh=MESH), model=jm,
                                     backbone_variables=jt.backbone_variables(jax.device_put(ssl_state5)),
                                     mesh=_mesh())
    jstate = _copy(jcls.init_state())
    bv = tt.backbone_variables(tt.state_from_jax(ssl_state5))
    assert "fc.weight" not in bv and "conv1.weight" in bv
    tcls = tml.TileClassifierTrainer(MLConfig(batch_size=N, image_size=SIZE),
                                     model=functools.partial(TBB, num_classes=2), backbone_variables=bv,
                                     device="cpu")
    pstate = tcls.init_state()
    ref = convert.resnet_state_dict_from_jax(pstate.model, {"params": jstate.params,
                                                            "batch_stats": jstate.batch_stats})
    for k, v in pstate.model.state_dict().items():
        if not k.startswith("fc."):
            assert torch.equal(v, ref[k]), k
    _, metrics = tcls.train_step(pstate, ssl_data, np.arange(N) % 2, np.ones(N))
    assert np.isfinite(float(metrics["loss"]))


# ------------------------------------------------------------------ fusion


def test_trainable_mask_matches_jax():
    """The frozen set over every backbone parameter, freezing on and off."""
    variables = jax.eval_shape(lambda: jresnet.init_resnet(JBB, jax.random.key(0), SIZE))
    names = [n for n, _ in TBB(num_classes=0).named_parameters()]
    for freeze in (True, False):
        ref = jfusion._trainable_mask(variables["params"], freeze)
        got = tfusion._trainable_mask(names, freeze)
        for name in names:
            _, path, _ = convert.resnet_flax_leaf(name)
            leaf = ref
            for p in path:
                leaf = leaf[p]
            assert got[name] == leaf, name
        assert sum(got.values()) == (len(names) if not freeze else 18)  # layer3 and layer4: 9 tensors each


def test_pre_norm_biases_are_the_dense_biases_ahead_of_batchnorm():
    """``FusionModel.pre_norm_biases`` names exactly the Linear biases that a
    BatchNorm follows, each with its Linear's kernel, and ``convert`` puts
    each pair in one flax Dense (``RNAEncoder_0/dense_i``)."""
    model = tfusion_models.FusionModel(TBB(num_classes=0), GENES, (16, 8, 4))
    want = {}
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential) and len(mod) > 1 and isinstance(mod[0], torch.nn.Linear) \
                and isinstance(mod[1], torch.nn.BatchNorm1d):
            want[f"{name}.0.bias"] = f"{name}.0.weight"
    got = model.pre_norm_biases()
    assert got == want and len(got) == 3
    for bias, kernel in got.items():
        _, bias_path, _ = convert.resnet_flax_leaf(bias)
        _, kernel_path, _ = convert.resnet_flax_leaf(kernel)
        assert bias_path[:-1] == kernel_path[:-1] and bias_path[-2].startswith("dense_"), (bias_path, kernel_path)


def _bags(rng, n=N, bag=2):
    bags = rng.randint(0, 255, (n, bag, SIZE, SIZE, 3), dtype=np.uint8)
    labels = (np.arange(n) % 2).astype(np.int32)
    bags[labels == 1] //= 4
    slide_idx = np.arange(n, dtype=np.int32) % 4
    rna = rng.randn(4, GENES).astype(np.float32)
    return bags, labels, slide_idx, rna


def _fusion_trainers():
    jt = jfusion.FusionTrainer(jfusion.FusionConfig(**FUSION_KW, mesh=MESH), backbone=JBB, mesh=_mesh())
    return jt, tfusion.FusionTrainer(tfusion.FusionConfig(**FUSION_KW), backbone=TBB, device="cpu")


def _dropout_interceptor(keep):
    def icpt(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout):
            x = args[0]
            return jax.lax.select(keep, x / (1.0 - context.module.rate), jnp.zeros_like(x))
        return next_fun(*args, **kwargs)
    return icpt


@pytest.fixture(scope="module")
def fusion_setup():
    """Bags, and the JAX fusion trainer's state after 5 steps (numpy leaves)."""
    data = _bags(np.random.RandomState(13))
    bags, labels, slide_idx, rna = data
    jt, _ = _fusion_trainers()
    state = jt.init_state(bags.shape[1:], GENES)
    for k in range(5):
        idx = (np.arange(4) + 2 * k) % N
        state, _ = jt._train_step(state, jnp.asarray(tiles_to_float(bags[idx]) * 0.5 + 0.5),
                                  jnp.asarray(rna[slide_idx[idx]]), jnp.asarray(labels[idx]),
                                  jnp.ones(4, jnp.float32))
    return data, _copy(state)


def test_fusion_step_from_step_5_matches_jax(fusion_setup):
    """One fusion step with a given dropout mask and a masked row: the
    trainable tensors, every BatchNorm statistic (frozen stages' too) and
    the moments of the trainable tensors as JAX has them; the frozen
    parameters bit-unchanged."""
    (bags, labels, slide_idx, rna), state5 = fusion_setup
    jt, tt = _fusion_trainers()
    idx = np.array([1, 4, 6, 7])
    mask = np.array([1, 1, 1, 0], np.float32)
    keep = np.random.RandomState(3).rand(4, GENES) < 0.5
    x = jnp.asarray(tiles_to_float(bags[idx]) * 0.5 + 0.5)
    r = jnp.asarray(rna[slide_idx[idx]])

    @jax.jit
    def jstep(st, keep):
        with nn.intercept_methods(_dropout_interceptor(keep)):
            return jt._train_step_impl(st, x, r, jnp.asarray(labels[idx]), jnp.asarray(mask))

    jt._build_tx(state5.params)
    jstate, jm = jstep(jax.device_put(_copy(state5)), jnp.asarray(keep))
    pstate = tt.state_from_jax(state5, bags.shape[1:], GENES)
    frozen = {n: p.detach().clone() for n, p in pstate.model.named_parameters() if not p.requires_grad}
    stats = {k: v.clone() for k, v in pstate.model.state_dict().items() if "backbone.layer1" in k and "running" in k}
    pstate, pm = tt.train_step(pstate, bags[idx], rna[slide_idx[idx]], labels[idx], mask, draws={"keep": keep})
    _close(float(pm["loss"]), float(jm["loss"]))
    assert float(pm["acc"]) == float(jm["acc"])
    names = tfusion.trainable_names(pstate.model, True)
    # conv1, bn1 (2), layer1.0 (6) and layer2.0 with its downsample (9)
    assert len(frozen) == 18 and len(names) == len(pstate.opt.mu) == len(list(pstate.model.parameters())) - 18
    _assert_state_close(pstate, _copy(jstate), names, pstate.model.pre_norm_biases())
    for n, p in pstate.model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    assert all(not torch.equal(pstate.model.state_dict()[k], v) for k, v in stats.items())


def test_fusion_predict_matches_jax(fusion_setup):
    (bags, labels, slide_idx, rna), state5 = fusion_setup
    jt, tt = _fusion_trainers()
    jb = jpatches.BagData(bags, labels, slide_idx, ["a", "b", "c", "d"], rna)
    tb = tpatches.BagData(bags, labels, slide_idx, ["a", "b", "c", "d"], rna)
    jt._build_tx(state5.params)
    got = tt.predict(tb, tt.state_from_jax(state5, bags.shape[1:], GENES))
    assert np.array_equal(got, jt.predict(jb, jax.device_put(_copy(state5))))


# -------------------------------------------------------------------- bags


def _patch_data(pkg, rng):
    images = rng.randint(0, 255, (23, 4, 4, 3), dtype=np.uint8)
    slide_idx = np.array([0] * 9 + [1] * 3 + [2] * 11, np.int32)
    labels = slide_idx % 2
    rna = rng.rand(3, 5).astype(np.float32)
    return pkg.PatchData(images, labels.astype(np.int32), slide_idx, ["s0", "s1", "s2"], rna)


def _bags_equal(a, b):
    assert a.bags.shape == b.bags.shape and np.array_equal(a.bags, b.bags)
    assert np.array_equal(a.labels, b.labels) and a.labels.dtype == b.labels.dtype
    assert np.array_equal(a.slide_idx, b.slide_idx) and list(a.slides) == list(b.slides)
    assert (a.rna is None) == (b.rna is None)
    if a.rna is not None:
        assert np.array_equal(a.rna, b.rna)


@pytest.mark.parametrize("bag_size,seed,drop_last", [(4, 0, True), (4, 3, False), (5, 1, False), (20, 0, True)])
def test_make_bags_equals_jax(bag_size, seed, drop_last):
    jd = _patch_data(jpatches, np.random.RandomState(1))
    td = _patch_data(tpatches, np.random.RandomState(1))
    _bags_equal(tpatches.make_bags(td, bag_size, seed, drop_last), jpatches.make_bags(jd, bag_size, seed, drop_last))


def _tables(names):
    """The same slides as a JAX frame and a port ``SlideTable``."""
    rows = [{"wsi_file_name": s, "Labels": i, "rna_a": float(i), "rna_b": 2.0} for i, s in enumerate(names)]
    table = tpatches.SlideTable(RNATable(("rna_a", "rna_b"), np.array([[r["rna_a"], r["rna_b"]] for r in rows]),
                                         np.array(names, dtype=object)),
                                np.array(["unused"] * len(names), dtype=object), np.arange(len(names)))
    return pd.DataFrame(rows), table


@pytest.mark.parametrize("kw", [{}, {"img_size": 8}, {"quick": ["GTEX-J2.svs", "MISSING.svs"]},
                                {"max_patch_per_wsi": None, "bag_size": 3}])
def test_load_bag_folder_equals_jax(tmp_path, kw):
    """The JPEG layout (``loc.txt`` count - 2, the first patches, consecutive
    bags, resize, ``quick``, a slide without a folder) byte for byte."""
    root = str(tmp_path / "jpegs")
    rng = np.random.RandomState(5)
    for s, n_tiles in [("GTEX-J1.svs", 7), ("GTEX-J2.svs", 4)]:
        d = os.path.join(root, s)
        os.makedirs(d)
        for i in range(n_tiles):
            Image.fromarray(rng.randint(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                os.path.join(d, f"{s}_patch_{i}.jpeg"), quality=90)
        with open(os.path.join(d, "loc.txt"), "w") as f:
            f.write("header\nheader2\n" + "".join(f"{i},0,0\n" for i in range(n_tiles)))
    df, table = _tables(["GTEX-J1.svs", "MISSING.svs", "GTEX-J2.svs"])
    kw = {"bag_size": 2, "max_patch_per_wsi": 6, **kw}
    _bags_equal(tpatches.load_bag_folder(table, root, **kw), jpatches.load_bag_folder(df, root, **kw))


def test_hdf5_conversion_and_bags_equal_jax(tmp_path):
    """``convert_slide_to_hdf5`` from LMDB tile databases (streamed in chunks
    of 5) writes the JAX converter's tiles in its order; ``load_bag_hdf5``
    reads the same bags (plain, resized, ``quick``)."""
    pytest.importorskip("h5py")
    import h5py

    rng = np.random.RandomState(6)
    names = ["GTEX-H1.svs", "GTEX-H2.svs"]
    src = str(tmp_path / "lmdb")
    for s, n_tiles in zip(names, (12, 5)):
        path = tpatches.slide_db_path(src, s)
        os.makedirs(os.path.dirname(path))
        with LMDBTileWriter(path) as w:
            for i in range(n_tiles):
                w.put_tile(f"{s}_{i}", rng.randint(0, 255, (16, 16, 3), dtype=np.uint8))
    out_j, out_t = str(tmp_path / "h5_jax"), str(tmp_path / "h5_port")
    for s in names:
        pj = jpatches.convert_slide_to_hdf5(src, s, out_j, chunk_tiles=5)
        pt = tpatches.convert_slide_to_hdf5(src, s, out_t, chunk_tiles=5)
        assert os.path.basename(pj) == os.path.basename(pt) == os.path.basename(tpatches.slide_hdf5_path(out_t, s))
        with h5py.File(pj, "r") as a, h5py.File(pt, "r") as b:
            assert np.array_equal(a["patches"][()], b["patches"][()])
            assert a["patches"].chunks == b["patches"].chunks and a["patches"].compression == b["patches"].compression
    df, table = _tables([names[0], "MISSING.svs", names[1]])
    for kw in ({}, {"img_size": 8}, {"quick": [names[1]]}, {"max_patch_per_wsi": 4, "bag_size": 3}):
        kw = {"bag_size": 2, **kw}
        _bags_equal(tpatches.load_bag_hdf5(table, out_t, **kw), jpatches.load_bag_hdf5(df, out_j, **kw))
