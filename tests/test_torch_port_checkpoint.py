"""The port reads and writes the JAX package's msgpack checkpoints.

``rnagan_tpu_torch/core/msgpack.py`` against ``flax.serialization`` (values,
dtypes and bytes, chunked arrays included), the port's ``save_bundle`` read by
the JAX ``load_bundle``, a JAX ``VAETrainer.fit``'s ``model_best.ckpt``
driving the port's ``GANTrainer`` bit-equal to the ``.pt`` route, and a JAX
``GANTrainer.save_model`` bundle resumed bit-equal to the in-memory state
moved by the converters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from test_torch_port_parity import jax_vae_variables
from test_torch_port_train import _cfgs, _jax_state, _port_state

from rnagan_tpu.core import checkpoint as jckpt
from rnagan_tpu.core import config as jcfg
from rnagan_tpu.models.betavae import params_to_torch_state_dict
from rnagan_tpu.parallel.mesh import make_mesh
from rnagan_tpu.train.gan_trainer import GANTrainer as JaxGANTrainer
from rnagan_tpu.train.vae_trainer import VAETrainer as JaxVAETrainer
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core import checkpoint as tckpt
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.core import msgpack
from rnagan_tpu_torch.losses.rna_infusion import encode_z_mean
from rnagan_tpu_torch.train.gan_trainer import GANTrainer, load_frozen_vae

F32 = np.float32
VAE_SMALL = dict(rna_features=24, z_dim=8, encoder_dims=(16, 8), decoder_dims=(16,))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once, and a full
    thread pool in each makes the CPU convolutions crawl."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bits(leaf):
    """A leaf as (type tag, dtype name, shape, raw bits) for exact comparison:
    flax's bfloat16 numpy arrays and the port's bfloat16 tensors compare by
    their 16-bit patterns."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16
        return ("array", "bfloat16", tuple(leaf.shape), leaf.view(torch.int16).numpy().tobytes())
    if isinstance(leaf, (np.ndarray, np.generic)):
        arr = np.asarray(leaf)
        kind = "array" if isinstance(leaf, np.ndarray) or arr.dtype.name == "bfloat16" else "scalar"
        if arr.dtype.name == "bfloat16":
            arr = arr.view(np.uint16)
        return (kind, np.asarray(leaf).dtype.name, arr.shape, arr.tobytes())
    return (type(leaf).__name__, leaf)


def _assert_same(got, ref, path="root"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{path}/{i}")
    else:
        assert _bits(got) == _bits(ref), path


def _vae_tree(seed=0):
    m = jcfg.VAEModelConfig(**VAE_SMALL)
    variables = jax_vae_variables(m, seed=seed)
    scaler = {"kind_id": np.int32(0), "offset": np.random.RandomState(seed).rand(24),
              "scale": np.ones(24)}
    return {**variables, "scaler": scaler}


def _gan_state_tree(mu_dtype=None, ema=True):
    jc, _ = _cfgs({"adam_mu_dtype": mu_dtype, "g_ema_decay": 0.9 if ema else None}, {})
    jtr = JaxGANTrainer(jc, vae_variables=jax_vae_variables(jc.vae, seed=11),
                        mesh=make_mesh(devices=jax.devices()[:1]))
    return jtr, jc, _jax_state(jtr, jc)


def _flax_bytes(name, tmp_path):
    """Bytes the JAX package writes: a VAE bundle, a GAN training bundle, a
    tree of bfloat16 leaves, and strings (the ``\\xffSTR`` encoding)."""
    path = str(tmp_path / f"{name}.ckpt")
    if name == "vae":
        jckpt.save_bundle(path, _vae_tree(), {"config": "betavae", "epoch": 3, "val_loss": 0.25})
    elif name == "gan":
        jtr, _, js = _gan_state_tree("bfloat16")
        jtr.z_pop = (np.arange(32, dtype=F32), np.ones(32, F32))
        jtr.save_model(js, path, {"epoch": 2})
    elif name == "bfloat16":
        rng = np.random.RandomState(1)
        jckpt.save_pytree(path, {"mu": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
                                 "scalar": jnp.bfloat16(1.5), "count": jnp.asarray(7, jnp.int32),
                                 "flag": np.bool_(True), "empty": np.zeros((0, 2), F32)})
    else:
        jckpt.save_pytree(path, {"name": "slide GTEX-1117F ÄÖ", "raw": b"\x00\x01",
                                 "nested": {"tag": "x" * 300}, "n": 5, "f": 0.1})
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["vae", "gan", "bfloat16", "strings"])
def test_codec_matches_flax(name, tmp_path):
    data = _flax_bytes(name, tmp_path)
    got = msgpack.unpackb(data)
    _assert_same(got, serialization.msgpack_restore(data))
    assert msgpack.packb(got) == data  # and the writer gives flax's bytes back


def test_chunked_arrays_match_flax(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 256)
    rng = np.random.RandomState(2)
    tree = {"big": rng.randn(10, 7).astype(F32), "small": rng.randn(3).astype(F32),
            "bf16": {"m": jnp.asarray(rng.randn(300), jnp.bfloat16)},
            "scalars": {"f64": np.float64(1.5), "i64": np.int64(-3), "flag": np.bool_(True)}}
    data = serialization.msgpack_serialize(tree)
    got = msgpack.unpackb(data)
    _assert_same(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])
    assert msgpack.packb(got) == data


@pytest.mark.parametrize("data", [b"\x93\x01\x02", b"\x01\x02", b"\xc7\x01\x09\x00", b"\xc1"])
def test_codec_refuses_malformed_input(data):
    with pytest.raises(ValueError):
        msgpack.unpackb(data)


def test_port_writer_reads_in_jax(tmp_path):
    tree = _vae_tree(seed=3)
    extra = {"name": "betavae", "steps": [1, 2, 3], "bf16": torch.arange(6, dtype=torch.bfloat16),
             "t": torch.arange(4, dtype=torch.float32).reshape(2, 2)}
    path = str(tmp_path / "port.ckpt")
    tckpt.save_bundle(path, {**tree, **extra}, {"config": "betavae", "epoch": 1})
    trees, meta = jckpt.load_bundle(path)
    assert meta == {"config": "betavae", "epoch": 1}
    assert trees["name"] == "betavae"
    assert {k: int(v) for k, v in trees["steps"].items()} == {"0": 1, "1": 2, "2": 3}
    np.testing.assert_array_equal(np.asarray(trees["bf16"], F32), np.arange(6, dtype=F32))
    np.testing.assert_array_equal(trees["t"], extra["t"].numpy())
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           {k: trees[k] for k in tree}, jax.tree_util.tree_map(np.asarray, tree))
    # and the port reads its own file as the JAX loader does
    port_trees, port_meta = tckpt.load_bundle(path)
    assert port_meta == meta and port_trees["name"] == "betavae"


@pytest.fixture(scope="module")
def jax_vae_run(tmp_path_factory):
    """A JAX ``VAETrainer.fit`` of one epoch into a directory: its
    ``model_best.ckpt`` (msgpack), and the same weights as a ``.pt``."""
    save_dir = str(tmp_path_factory.mktemp("jax_vae"))
    m = jcfg.VAEModelConfig(**VAE_SMALL)
    jc = jcfg.VAEConfig(model=m, lr=1e-3, batch_size=8, num_epochs=1, warmup_steps=2, cosine_steps=2,
                        mesh=jcfg.MeshConfig(data=1, model=1))
    rng = np.random.RandomState(5)
    train, val = rng.randn(32, 24).astype(F32), rng.randn(16, 24).astype(F32)
    jtr = JaxVAETrainer(jc, mesh=make_mesh(jc.mesh, devices=jax.devices()[:1]))
    jtr.fit(train, val, save_dir=save_dir)
    best = os.path.join(save_dir, "model_best.ckpt")
    trees, _ = jckpt.load_bundle(best)
    pt = os.path.join(save_dir, "model_dict_best.pt")
    sd = params_to_torch_state_dict(m, {"params": trees["params"], "batch_stats": trees["batch_stats"]})
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, pt)
    return best, pt, rng.randn(6, 24).astype(F32)


def test_jax_vae_checkpoint_drives_port_gan_trainer(jax_vae_run):
    """The JAX ``model_best.ckpt`` as ``GANConfig(vae_checkpoint=...)``: the
    frozen VAE and its z_mean are bit-equal to the ``.pt`` route's."""
    best, pt, genes = jax_vae_run
    m = tcfg.VAEModelConfig(**VAE_SMALL)
    gan_model = tcfg.GANModelConfig(out_size=16, encoding_dims=8, step_channels=4, compute_dtype="float32")
    z = {}
    for name, path in (("ckpt", best), ("pt", pt)):
        tr = GANTrainer(tcfg.GANConfig(model=gan_model, vae=m, vae_checkpoint=path), device="cpu")
        z[name] = encode_z_mean(tr.vae, torch.from_numpy(genes))
        if name == "ckpt":
            sd_ckpt = tr.vae.state_dict()
    assert torch.equal(z["ckpt"], z["pt"])
    sd_pt = load_frozen_vae(pt, m)
    assert set(sd_ckpt) == set(sd_pt)
    for k, v in sd_pt.items():
        assert torch.equal(sd_ckpt[k], v), k
    assert set(load_frozen_vae(best, m)) == set(sd_pt)


@pytest.mark.parametrize("mu_dtype,bundle_ema,trainer_ema", [
    ("bfloat16", True, True), (None, False, True), (None, True, False)])
def test_jax_gan_bundle_resumes_bit_equal(tmp_path, mu_dtype, bundle_ema, trainer_ema):
    """``GANTrainer.load_model`` on a JAX ``save_model`` bundle (msgpack,
    sniffed by its magic) equals the in-memory JAX state moved by the
    converters: parameters, BN statistics, Adam moments and counts, step,
    the EMA (seeded from the weights when the bundle has none) and z_pop."""
    jtr, jc, js = _gan_state_tree(mu_dtype, ema=bundle_ema)
    z_pop = (np.linspace(-1, 1, 32).astype(F32), np.linspace(0.5, 2, 32).astype(F32))
    jtr.z_pop = z_pop
    path = str(tmp_path / "gan_last.model")
    jtr.save_model(js, path, {"epoch": 0})
    _, tc = _cfgs({"adam_mu_dtype": mu_dtype, "g_ema_decay": 0.9 if trainer_ema else None}, {})
    vae_sd = convert.betavae_state_dict_from_jax(tc.vae, jax_vae_variables(jc.vae, seed=11))
    tr = GANTrainer(tc, vae_sd, device="cpu")
    got = tr.load_model(path)
    ref = _port_state(GANTrainer(tc, vae_sd, device="cpu"), tc,
                      js.replace(g_ema=js.g_ema if trainer_ema else None))
    assert got.step == ref.step == 5
    for a, b in ((got.generator, ref.generator), (got.discriminator, ref.discriminator)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    for a, b in ((got.g_stats, ref.g_stats), (got.d_stats, ref.d_stats)):
        assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    for a, b in ((got.g_opt, ref.g_opt), (got.d_opt, ref.d_opt)):
        assert a.count == b.count and a.mu[0].dtype == b.mu[0].dtype
        assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))
    if trainer_ema:
        want = ref.g_ema if bundle_ema else list(ref.generator.parameters())
        assert all(torch.equal(x, y) for x, y in zip(got.g_ema, want))
    else:
        assert got.g_ema is None
    for t, want in zip(tr.z_pop, z_pop):
        np.testing.assert_array_equal(t.numpy(), want)
