"""The GAN training state's way back to flax, and the port's ``export_torch``.

* ``GANTrainer.state_to_jax`` is the inverse of ``state_from_jax``: a JAX
  ``GANTrainer`` trained 2 steps and saved, read by the port's
  ``load_model``, written back with ``state_to_jax`` + ``save_bundle`` and
  read by the JAX ``load_model``, gives every leaf bit for bit (dtype too),
  for each arch ``state_from_jax`` takes, with the EMA, ``z_pop`` and a
  bfloat16 Adam ``mu`` each on in one case.
* ``export_torch`` in both directions as the JAX CLI: a JAX bundle to a
  torchgan ``.model`` that the JAX importer reads as it reads the JAX
  package's own export of that bundle; a port-written ``.model`` to a native
  bundle whose generator, in the JAX package, gives the port's output on
  fixed noise within 1e-5; ``dcgan`` only for the torchgan direction, with
  the JAX package's ValueError otherwise; ``cli.main export-torch`` runs it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnagan_tpu.core import config as jcfg
from rnagan_tpu.models.dcgan_torch import _gen_layout, export_torchgan_bundle, import_torchgan_bundle
from rnagan_tpu.parallel.mesh import make_mesh
from rnagan_tpu.train.gan_trainer import GANTrainer as JaxGANTrainer
from rnagan_tpu_torch.cli import export_torch
from rnagan_tpu_torch.cli import main as tmain
from rnagan_tpu_torch.core import checkpoint as tckpt
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.train.gan_trainer import GANTrainer

N = 4
F32 = np.float32
SMALL = dict(out_size=16, encoding_dims=8, step_channels=4, compute_dtype="float32")
MODELS = {
    "dcgan": SMALL,
    "dcgan_up": {**SMALL, "arch": "dcgan_up"},
    "condgan": {**SMALL, "arch": "condgan", "num_classes": 2},
    "sagan": {**SMALL, "arch": "sagan", "encoding_dims": 16, "attn_size": 8},
    "biggan": {**SMALL, "arch": "biggan", "encoding_dims": 24, "num_classes": 2, "attn_size": 8, "embed_dim": 6},
}
#: arch -> GANConfig fields: the EMA, a bfloat16 mu and z_pop each in one case
CASES = {"dcgan": {"g_ema_decay": 0.9}, "dcgan_up": {}, "condgan": {"adam_mu_dtype": "bfloat16"},
         "sagan": {}, "biggan": {}}
Z_POP_CASE = "dcgan_up"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, **cfg_kw):
    m = MODELS[arch]
    return (jcfg.GANConfig(model=jcfg.GANModelConfig(**m), loss_type="wgan", batch_size=N, **cfg_kw),
            tcfg.GANConfig(model=tcfg.GANModelConfig(**m), loss_type="wgan", batch_size=N, **cfg_kw))


def _jax_trainer(jc):
    return JaxGANTrainer(jc, mesh=make_mesh(devices=jax.devices()[:1]))


def _batch(rng, m):
    batch = {"image": (rng.rand(N, m.out_size, m.out_size, 3) * 2 - 1).astype(F32)}
    if m.num_classes:
        batch["labels"] = rng.randint(0, m.num_classes, N).astype(np.int32)
    return batch


def _trained_jax_state(jtr, jc, steps=2, seed=0):
    rng = np.random.RandomState(seed)
    js = jtr.init_state()
    for _ in range(steps):
        js, _ = jtr._train_step(js, _batch(rng, jc.model), jtr.vae_variables)
    return jax.device_get(js)


def _leaf_bits(x):
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _assert_same_state(got, ref):
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(got_leaves, ref_leaves):
        assert _leaf_bits(a) == _leaf_bits(b), jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", list(CASES))
def test_state_to_jax_round_trips_through_jax_load_model(tmp_path, arch):
    jc, tc = _cfgs(arch, **CASES[arch])
    jtr = _jax_trainer(jc)
    js = _trained_jax_state(jtr, jc)
    assert int(js.step) == 2 and (js.g_ema is not None) == (arch == "dcgan")
    z_pop = (np.linspace(-1, 1, jc.model.encoding_dims).astype(F32),
             np.linspace(0.5, 2, jc.model.encoding_dims).astype(F32))
    if arch == Z_POP_CASE:
        jtr.z_pop = z_pop
    src = str(tmp_path / "jax.model")
    jtr.save_model(js, src, {"epoch": 0})

    tr = GANTrainer(tc, device="cpu")
    trees = tr.state_to_jax(tr.load_model(src))
    assert ("z_pop" in trees) == (arch == Z_POP_CASE) and ("g_ema" in trees) == (arch == "dcgan")
    back_path = str(tmp_path / "port.model")
    tckpt.save_bundle(back_path, trees, {"epoch": 0})

    back_tr = _jax_trainer(jc)
    back = jax.device_get(back_tr.load_model(back_path))
    _assert_same_state(back, js)
    if arch == "condgan":
        assert np.asarray(back.g_opt[0].mu["ConvTranspose_0"]["kernel"]).dtype == jnp.bfloat16
    if arch == Z_POP_CASE:
        for a, b in zip(back_tr.z_pop, z_pop):
            np.testing.assert_array_equal(a, b)
    # and the JAX package's own bundle of the state holds the same trees
    raw, _ = tckpt.load_bundle(src)
    again, _ = tckpt.load_bundle(back_path)
    assert sorted(raw) == sorted(again)


def _config_json(tmp_path, arch):
    m = MODELS[arch]
    path = tmp_path / f"{arch}.json"
    path.write_text(json.dumps({"gan_type": arch, "img_size": m["out_size"], "encoding_dims": m["encoding_dims"],
                                "step_channels": m["step_channels"], "compute_dtype": "float32",
                                "attn_size": m.get("attn_size", 32), "path_csv": ["a.csv", "b.csv"]}))
    return str(path)


def test_export_to_torchgan_matches_jax_export(tmp_path):
    """JAX bundle -> the port's ``export_torch`` -> ``.model``: the JAX
    importer reads the trees it reads from the JAX package's own export."""
    jc, _ = _cfgs("dcgan")
    jtr = _jax_trainer(jc)
    js = _trained_jax_state(jtr, jc, seed=3)
    src = str(tmp_path / "gan_last.model")
    jtr.save_model(js, src, {"epoch": 2})
    out = str(tmp_path / "port_export.model")
    assert export_torch.main(["--config", _config_json(tmp_path, "dcgan"), "--checkpoint", src, "--out", out,
                              "--epoch", "3", "--device", "cpu"]) == out
    ref = str(tmp_path / "jax_export.model")
    export_torchgan_bundle(ref, jc, js, epoch=3)
    template = jax.device_get(jtr.init_state())
    got_state, got_epoch = import_torchgan_bundle(out, jc, template)
    ref_state, ref_epoch = import_torchgan_bundle(ref, jc, template)
    assert got_epoch == ref_epoch == 3
    _assert_same_state(got_state, ref_state)


@pytest.mark.parametrize("arch", ["dcgan", "sagan"])
def test_export_to_native_matches_port_generator(tmp_path, arch):
    """A port-written ``.model`` -> ``export_torch --to_native`` (through
    ``cli.main``) -> the JAX ``load_model``: G's output on fixed noise is
    the port's within 1e-5."""
    _, tc = _cfgs(arch)
    tr = GANTrainer(tc, device="cpu")
    st = tr.init_state()
    rng = np.random.RandomState(1)
    for _ in range(2):
        tr.train_step(st, _batch(rng, tc.model))
    src = str(tmp_path / "port.model")
    tr.save_model(st, src, epoch=1)
    out = str(tmp_path / "native.msgpack")
    assert tmain.main(["export-torch", "--config", _config_json(tmp_path, arch), "--checkpoint", src, "--out", out,
                       "--to_native", "--device", "cpu"]) == 0
    _, meta = tckpt.load_bundle(out)
    assert meta == {"converted_from": src}

    jc, _ = _cfgs(arch)
    js = _jax_trainer(jc).load_model(out)
    noise = rng.randn(3, tc.model.encoding_dims).astype(F32)
    ref = np.asarray(_jax_trainer(jc).generator.apply({"params": js.g_params, "batch_stats": js.g_stats},
                                                     jnp.asarray(noise), labels=None, train=False))
    with torch.no_grad():
        got = st.generator.forward_stats(torch.from_numpy(noise), st.g_stats, False)[0]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-5)
    assert int(js.step) == st.step == 2


def test_export_to_torchgan_refuses_other_archs(tmp_path):
    """``--gan_type sagan`` without ``--to_native``: the JAX package's ValueError."""
    _, tc = _cfgs("sagan")
    tr = GANTrainer(tc, device="cpu")
    src = str(tmp_path / "sagan.model")
    tr.save_model(tr.init_state(), src)
    with pytest.raises(ValueError) as jax_err:
        _gen_layout(jcfg.GANModelConfig(**MODELS["sagan"]))
    with pytest.raises(ValueError) as err:
        export_torch.main(["--config", _config_json(tmp_path, "sagan"), "--checkpoint", src,
                           "--out", str(tmp_path / "x.model"), "--gan_type", "sagan", "--device", "cpu"])
    assert str(err.value) == str(jax_err.value)
