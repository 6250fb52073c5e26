"""The downstream ML run on the port (``tools/ml_experiment_run_torch.py``)
against the JAX package, on the CPU.

* The resize to the classifier's size and the uint8 cast against
  ``jax.image.resize(..., "bilinear")`` (which antialiases when it shrinks)
  and the JAX tool's ``clip(x * 255 + 0.5)`` cast, on the same float tiles:
  at most 1 level off, on at most 1 % of the values.
* ``generate_set_u8`` on a slide count that is not a multiple of the chunk
  of 64: JAX's uniforms for each chunk, padding rows included (the JAX
  tool's ``fold_in(key(777), i)`` draws), handed to the port; the [0, 1]
  tiles before the cast within the GAN parity tolerance (1e-5), the uint8
  tiles within a level.
* ``--smoke`` runs of the tool (2 folds, 1 epoch, ResNet18): the real arm
  alone with ``rnagan_synthetic_skipped`` when the workdir has no
  checkpoint, then the synthetic and mixed arms resumed into the same
  ``--out``; the JAX tool's keys read from its source with ``ast``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_parity import jax_generator_variables, jax_vae_variables
from test_torch_port_representation_run import smoke_workdir, source_keys

from rnagan_tpu.core import config as jcfg
from rnagan_tpu.losses import rna_infusion as jinf
from rnagan_tpu.models.betavae import BetaVAE as JaxBetaVAE
from rnagan_tpu.models.dcgan import make_generator
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.train.gan_trainer import GANTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)
import ml_experiment_run_torch as ml  # noqa: E402

VAE_KW = dict(rna_features=20, z_dim=16, encoder_dims=(24, 16), decoder_dims=(24,), compute_dtype="float32")
G_KW = dict(out_size=32, encoding_dims=16, step_channels=8, compute_dtype="float32")
R = 0.3
F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_u8(images01, size):
    """The JAX tool's resize and cast (``ml_experiment_run.py:60-62``)."""
    x = jax.image.resize(jnp.asarray(images01), (images01.shape[0], size, size, 3), method="bilinear")
    return np.asarray(jnp.clip(x * 255.0 + 0.5, 0, 255).astype(jnp.uint8))


def _within_a_level(got, ref):
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("side,size", [(256, 224), (64, 32), (32, 48)])
def test_resize_and_cast_match_jax(side, size):
    tiles = np.random.RandomState(side).rand(3, side, side, 3).astype(F32)
    got = ml.to_uint8_resized(torch.from_numpy(tiles), size).numpy()
    _within_a_level(got, _jax_u8(tiles, size))
    if side > size:  # a resize without antialiasing is not the JAX one
        plain = torch.nn.functional.interpolate(torch.from_numpy(tiles).permute(0, 3, 1, 2), size=(size, size),
                                                mode="bilinear", align_corners=False)
        plain = ml.to_uint8(plain.permute(0, 2, 3, 1)).numpy()
        assert np.abs(plain.astype(int) - got.astype(int)).max() > 1


@pytest.fixture(scope="module")
def generator():
    jv_cfg, jg_cfg = jcfg.VAEModelConfig(**VAE_KW), jcfg.GANModelConfig(**G_KW)
    tv_cfg, tg_cfg = tcfg.VAEModelConfig(**VAE_KW), tcfg.GANModelConfig(**G_KW)
    vae_vars = jax_vae_variables(jv_cfg, seed=3)
    g_params, g_stats = jax_generator_variables(jg_cfg, seed=4)
    tr = GANTrainer(tcfg.GANConfig(model=tg_cfg, loss_type="wganvae", vae=tv_cfg, noise_range=R),
                    convert.betavae_state_dict_from_jax(tv_cfg, vae_vars), device="cpu")
    st = tr.init_state()
    st.generator.load_state_dict(convert.generator_state_dict_from_jax(tg_cfg, g_params, g_stats))
    st.g_stats = [(m.clone(), v.clone()) for m, v in st.generator.bn_stats()]
    return dict(jv_cfg=jv_cfg, jg_cfg=jg_cfg, vae_vars=vae_vars, g_params=g_params, g_stats=g_stats, tr=tr, st=st)


def _jax_chunks(g, expr, slide_ids, size, seed=777, chunk=64):
    """The JAX tool's ``generate_set_u8`` chunk by chunk (``:74-107``): the
    last chunk padded with slide-0 rows, uniforms from ``fold_in(key(seed), i)``.
    Returns the [0, 1] resized chunks, their uint8 set and the uniforms."""
    jvae, gen = JaxBetaVAE(g["jv_cfg"]), make_generator(g["jg_cfg"])
    n = len(slide_ids)
    sl = np.concatenate([slide_ids, np.zeros((-n) % chunk, np.int32)])
    floats, us = [], []
    for i in range(0, len(sl), chunk):
        key = jax.random.fold_in(jax.random.key(seed), i // chunk)
        z_mean = jinf.encode_z_mean(jvae, g["vae_vars"], jnp.asarray(expr)[sl[i:i + chunk]])
        us.append(np.array(jax.random.uniform(key, z_mean.shape, jnp.float32, -R, R)))
        noise = jinf.infused_noise(key, z_mean, R)
        imgs = gen.apply({"params": g["g_params"], "batch_stats": g["g_stats"]}, noise, train=False)
        imgs01 = jnp.clip((imgs.astype(jnp.float32) + 1.0) * 0.5, 0.0, 1.0)
        floats.append(np.asarray(jax.image.resize(imgs01, (imgs01.shape[0], size, size, 3), method="bilinear")))
    u8 = np.concatenate([np.asarray(jnp.clip(f * 255.0 + 0.5, 0, 255).astype(jnp.uint8)) for f in floats])[:n]
    return floats, u8, us


def test_generate_set_matches_jax_with_padded_chunks(generator):
    """70 slides: a full chunk and one of 6 rows padded to 64 with slide 0,
    whose batch statistics the padding rows enter."""
    g = generator
    expr = np.random.RandomState(5).randn(5, VAE_KW["rna_features"]).astype(F32)
    slide_ids = np.random.RandomState(6).randint(0, 5, 70).astype(np.int32)
    ref_floats, ref_u8, us = _jax_chunks(g, expr, slide_ids, 24)
    got_floats = list(ml.generated_chunks(g["tr"], g["st"], expr, slide_ids, 24, uniforms=us))
    assert [x.shape for x in got_floats] == [(64, 24, 24, 3)] * 2
    for got, ref in zip(got_floats, ref_floats):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    got_u8 = ml.generate_set_u8(g["tr"], g["st"], expr, slide_ids, 24, uniforms=us).numpy()
    _within_a_level(got_u8, ref_u8)
    assert ref_u8.std() > 10
    # the last 6 rows standardized without the padding are other tiles
    unpadded = next(ml.generated_chunks(g["tr"], g["st"], expr, slide_ids[64:], 24, chunk=6, uniforms=[us[1][:6]]))
    assert np.abs(unpadded.numpy() - ref_floats[1][:6]).max() > 1e-3
    # drawn from seeds: chunk i takes seed 777 + i, so two runs give the same tiles
    a = ml.generate_set_u8(g["tr"], g["st"], expr, slide_ids, 24)
    assert torch.equal(a, ml.generate_set_u8(g["tr"], g["st"], expr, slide_ids, 24))


def _cv_keys():
    keys = source_keys(os.path.join(TOOLS, "ml_experiment_run.py"), "cv_resident")
    return keys["results"], keys["fold"], keys["fold.test"]


def _check_cv(record):
    results_keys, fold_keys, test_keys = _cv_keys()
    assert sorted(record) == results_keys
    assert len(record["folds"]) == 2
    for fold in record["folds"]:
        assert sorted(fold) == fold_keys and sorted(fold["test"]) == test_keys
        assert all(0.0 <= fold[k] <= 1.0 for k in ("accuracy", "weighted_f1"))
    for k in ("accuracy", "weighted_f1"):
        assert record[f"mean_{k}"] == pytest.approx(np.mean([f[k] for f in record["folds"]]))
        assert record[f"mean_test_{k}"] == pytest.approx(np.mean([f["test"][k] for f in record["folds"]]))


def test_smoke_run_skips_then_resumes(tmp_path):
    """The real arm with no checkpoint in the workdir (``rnagan_synthetic_skipped``),
    then the projection checkpoint's synthetic and mixed arms with the real
    arm resumed from ``--out``, unchanged."""
    out = str(tmp_path / "ml.json")
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    common = ["--smoke", "--device", "cpu", "--out", out]
    first = ml.main([*common, "--workdir", empty])
    jkeys = source_keys(os.path.join(TOOLS, "ml_experiment_run.py"))
    assert sorted(first) == ["meta", "real", "rnagan_synthetic_skipped"]
    assert set(first) <= set(jkeys["result"])
    _check_cv(first["real"])
    assert first["meta"]["train_tiles"] == 8 * 4 and first["meta"]["test_tiles"] == 8 * 2
    with open(out) as f:
        assert json.load(f) == first

    wd = smoke_workdir(tmp_path / "wd")
    second = ml.main([*common, "--workdir", wd, "--ckpt_name", "wganvae_proj"])
    assert sorted(second) == ["meta", "mixed", "real", "rnagan_synthetic"]
    assert sorted(second["meta"]) == jkeys["result.meta"]
    assert second["real"] == first["real"]  # resumed, not rerun
    assert second["meta"]["rnagan_ckpt"].endswith("wganvae_proj_last.model")
    for arm in ("rnagan_synthetic", "mixed"):
        _check_cv(second[arm])
