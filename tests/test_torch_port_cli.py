"""The port's remaining CLIs against the JAX package's, on a tiny workspace on the CPU.

* ``interpolate``: the report equals the JAX CLI's within 1e-5, by tissue
  and through a phenotype CSV; the pandas-free merge and factorize equal
  pandas' on awkward columns.
* ``sample``: the pickle has the JAX CLI's keys, shapes and dtypes (the
  latents come from different generators; ``test_torch_port_vae.py`` holds
  the module's values); a ``.pt`` + ``scaler.npz`` and a JAX bundle of the
  same VAE give equal samples for one seed.
* ``tile``: the databases equal the JAX tiler's key for key and byte for byte.
* ``metrics``: prints what the JAX viewer prints.
* ``representation``, ``generate`` and ``fid`` take ``--gan_type sagan`` /
  ``biggan`` bundles.
* ``main`` dispatches every command of the JAX table; ``ml-experiment`` runs
  (``test_torch_port_resnet.py``), ``export-torch`` too
  (``test_torch_port_export.py``).

The CSVs hold integer counts: pandas' float parser and Python's ``float()``
can differ by an ulp on other values.
"""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_port_parity import jax_vae_variables

from rnagan_tpu.cli import interpolate as jinterpolate
from rnagan_tpu.cli import main as jmain
from rnagan_tpu.cli import metrics as jmetrics
from rnagan_tpu.cli import sample as jsample
from rnagan_tpu.cli import tile as jtile
from rnagan_tpu.core import checkpoint as jckpt
from rnagan_tpu.core import config as jcfg
from rnagan_tpu.data import rna as jrna
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.cli import fid, generate, interpolate, main, metrics, representation, sample, tile
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.data import patches as tpatches
from rnagan_tpu_torch.data import store as tstore
from rnagan_tpu_torch.train.gan_trainer import GANTrainer

GENES = 12
VAE = dict(rna_features=GENES, z_dim=16, encoder_dims=(24, 16), decoder_dims=(24,))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Two tissue CSVs (6 slides each) with a database of 16x16 tiles per
    slide, a phenotype CSV, one VAE as a JAX bundle and as a ``.pt`` with its
    ``scaler.npz``, and the VAE and GAN JSON configs."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    csvs, names = [], []
    tiles = root / "tiles"
    for t in range(2):
        frame = pd.DataFrame(rng.randint(0, 300, (6, GENES)).astype(float),
                             columns=[f"rna_ENSG{i:03d}" for i in range(GENES)])
        frame["wsi_file_name"] = [f"GTEX-{t}{i}.svs" for i in range(6)]
        frame.to_csv(root / f"tissue{t}.csv", index=False)
        csvs.append(str(root / f"tissue{t}.csv"))
        names += list(frame["wsi_file_name"])
    for name in names:
        db = tpatches.slide_db_path(str(tiles), name)
        os.makedirs(os.path.dirname(db))
        with tstore.LMDBTileWriter(db) as w:
            for i in range(4):
                w.put_tile(f"{name}_{i}", rng.randint(0, 256, (16, 16, 3), dtype=np.uint8))
    # the phenotype table: shuffled, one slide missing, one listed twice, a numeric column
    pheno = pd.DataFrame({"wsi_file_name": names[::-1][1:] + [names[3]],
                          "sex": rng.randint(1, 3, len(names))})
    pheno.to_csv(root / "pheno.csv", index=False)

    table = pd.concat([pd.read_csv(c) for c in csvs], ignore_index=True)
    cols = jrna.rna_columns(table)
    scaler = jrna.Scaler.fit(jrna.log_transform(table[cols].values), "standard")
    variables = jax_vae_variables(jcfg.VAEModelConfig(**VAE), seed=4)
    vae_dir = root / "vae"
    vae_dir.mkdir()
    bundle = str(vae_dir / "model_best.ckpt")
    jckpt.save_bundle(bundle, {**variables, "scaler": scaler.state_dict()}, {"epoch": 3})
    pt = str(vae_dir / "model_dict_best.pt")
    torch.save(convert.betavae_state_dict_from_jax(tcfg.VAEModelConfig(**VAE), variables), pt)
    np.savez(str(vae_dir / "scaler.npz"), **scaler.state_dict())

    vae_cfg = {"path_csv": csvs, "rna_features": GENES, "z_dim": 16, "encoder_dims": [24, 16],
               "decoder_dims": [24]}
    (root / "vae.json").write_text(json.dumps(vae_cfg))
    gan_cfg = {**vae_cfg, "patch_data_path": [str(tiles)] * 2, "img_size": 16, "encoding_dims": 16,
               "step_channels": 4, "attn_size": 8, "compute_dtype": "float32"}
    (root / "gan.json").write_text(json.dumps(gan_cfg))
    return root


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------- interpolate


@pytest.mark.parametrize("labels", ["tissue", "phenotype"])
def test_interpolate_matches_jax(ws, labels):
    extra = ["--label_column", "sex", "--phenotype_csv", str(ws / "pheno.csv")] if labels == "phenotype" else []
    common = ["--config", str(ws / "vae.json"), "--alpha", "0.7", *extra]
    ref = jinterpolate.main([*common, "--checkpoint", str(ws / "vae" / "model_best.ckpt"),
                             "--save_path", str(ws / f"jax_{labels}.pkl")])
    for ckpt in ("model_best.ckpt", "model_dict_best.pt"):
        out = str(ws / f"port_{labels}.pkl")
        interpolate.main([*common, "--checkpoint", str(ws / "vae" / ckpt), "--save_path", out,
                          "--device", "cpu"])
        got = _load(out)
        assert set(got) == set(ref)
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        np.testing.assert_allclose(got["z_mu"], np.asarray(ref["z_mu"]), rtol=1e-5, atol=1e-5)
        assert list(got["difference_vectors"]) == list(ref["difference_vectors"])
        for pair in ref["difference_vectors"]:
            np.testing.assert_allclose(got["difference_vectors"][pair], ref["difference_vectors"][pair],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["recons"][pair], ref["recons"][pair], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("column", [["b", "a", "b", "", "c"], ["2", "1.0", "1", "", "2.5"], ["x", "7", "x"]])
def test_merge_and_factorize_match_pandas(tmp_path, column):
    """Duplicate and missing keys, empty cells, and numeric columns whose
    spellings differ, against ``merge(..., on=...)`` + ``pd.factorize``."""
    left = pd.DataFrame({"wsi_file_name": ["s0", "s1", "s2", "s3", "s1", "s9"]})
    keys = ["s1", "s0", "s3", "s2", "s1"][:len(column)]
    pd.DataFrame({"wsi_file_name": keys, "lab": column}).to_csv(tmp_path / "p.csv", index=False)
    pheno = pd.read_csv(tmp_path / "p.csv")
    merged = left.reset_index().merge(pheno[["wsi_file_name", "lab"]], on="wsi_file_name")
    idx, cells = interpolate.merge_labels(list(left["wsi_file_name"]), str(tmp_path / "p.csv"), "lab")
    np.testing.assert_array_equal(idx, merged["index"].values)
    np.testing.assert_array_equal(interpolate.factorize(cells), pd.factorize(merged["lab"])[0])


# --------------------------------------------------------------------- sample


def test_sample_matches_jax_layout(ws):
    """Keys, shapes and dtypes of the JAX CLI's pickle, with and without an
    interpolation direction; the ``.pt`` and the bundle give equal samples."""
    interp = str(ws / "interp.pkl")
    interpolate.main(["--config", str(ws / "vae.json"), "--checkpoint", str(ws / "vae" / "model_best.ckpt"),
                      "--save_path", interp, "--device", "cpu"])
    for extra in ([], ["--interpolation", interp, "--pair", "1,0"]):
        common = ["--config", str(ws / "vae.json"), "--num_samples", "5", "--seed", "3", *extra]
        jsample.main([*common, "--checkpoint", str(ws / "vae" / "model_best.ckpt"),
                      "--save_path", str(ws / "jax_s.pkl")])
        ref = _load(ws / "jax_s.pkl")
        outs = []
        for ckpt in ("model_best.ckpt", "model_dict_best.pt"):
            sample.main([*common, "--checkpoint", str(ws / "vae" / ckpt), "--save_path", str(ws / "s.pkl"),
                         "--device", "cpu"])
            got = _load(ws / "s.pkl")
            assert set(got) == set(ref) == {"expression", "meta"}
            assert got["expression"].shape == ref["expression"].shape == (5, GENES)
            assert got["expression"].dtype == np.asarray(ref["expression"]).dtype
            outs.append(got)
        np.testing.assert_array_equal(outs[0]["expression"], outs[1]["expression"])
        assert outs[0]["meta"] == ref["meta"] == {"epoch": 3}


def test_sample_refits_the_scaler_without_one(ws, tmp_path):
    """A ``.pt`` with no ``scaler.npz`` beside it: the scaler is re-fit from the
    splits, as the JAX CLI does for a bundle without one."""
    pt = tmp_path / "model.pt"
    pt.write_bytes((ws / "vae" / "model_dict_best.pt").read_bytes())
    out = str(tmp_path / "s.pkl")
    expr = sample.main(["--config", str(ws / "vae.json"), "--checkpoint", str(pt), "--num_samples", "3",
                        "--save_path", out, "--device", "cpu"])
    assert expr.shape == (3, GENES) and np.isfinite(expr).all() and _load(out)["meta"] == {}


# ------------------------------------------------------------ metrics, tile


def _jsonl(path):
    with open(path, "w") as f:
        for i in range(12):
            f.write(json.dumps({"tag": "gan", "step": i, "t": float(i), "d_loss": -0.5 * i,
                                "fid": 100.0 - i}) + "\n")
        f.write(json.dumps({"tag": "val", "step": 0, "total_loss": 1.25}) + "\n")
        f.write("{torn")


def test_metrics_prints_what_jax_prints(tmp_path, capsys, monkeypatch):
    path = str(tmp_path / "run.jsonl")
    _jsonl(path)
    for argv in ([path], [path, "--tag", "gan", "--last", "3"], [path, "--tag", "gan", "--metric", "fid"],
                 [path, "--metric", "d_loss", "--width", "4"], [path, "--tag", "nope"]):
        codes = []
        outs = []
        for mod in (jmetrics, metrics):
            codes.append(mod.main(argv))
            outs.append(capsys.readouterr())
        assert codes[0] == codes[1] and outs[0] == outs[1], argv
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        metrics.main([path, "--metric", "fid", "--png", str(tmp_path / "fid.png")])


def _slide(seed=0, h=384, w=320):
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 240, np.uint8)
    img[60:300, 40:260] = rng.randint(60, 200, (240, 220, 3), dtype=np.uint8)
    return img


def test_tile_databases_equal_jax(tmp_path):
    from PIL import Image

    wsi = tmp_path / "wsi"
    wsi.mkdir()
    for i in range(2):
        Image.fromarray(_slide(i)).save(str(wsi / f"SLIDE-{i}.png"))
    outs = {}
    for name, mod in (("jax", jtile), ("port", tile)):
        outs[name] = tmp_path / name
        done = mod.main(["--wsi_path", str(wsi), "--patch_path", str(outs[name] / "tiles"),
                         "--mask_path", str(outs[name] / "masks"), "--patch_size", "32",
                         "--max_patches_per_slide", "12"])
        assert done == 2
    for i in range(2):
        sid = f"SLIDE-{i}"
        np.testing.assert_array_equal(np.load(outs["port"] / "masks" / sid / "mask.npy"),
                                      np.load(outs["jax"] / "masks" / sid / "mask.npy"))
        dbs = [str(outs[k] / "tiles" / sid / f"{sid}.db") for k in ("jax", "port")]
        with tstore.LMDBTileStore(dbs[0]) as a, tstore.LMDBTileStore(dbs[1]) as b:
            assert a.keys() == b.keys() and len(a.keys()) > 0
            for k in a.keys() + [b"__keys__"]:
                assert a.get_raw(k) == b.get_raw(k)


# ------------------------------------------------------- the SN archs' CLIs


@pytest.fixture(scope="module")
def bundles(ws):
    """A wganvae SAGAN bundle, a wgan SAGAN bundle and a conditional BigGAN
    one, each after one step, as the CLIs' ``_load_trainer`` configures them."""
    cfg_json = json.loads((ws / "gan.json").read_text())
    out = {}
    for name, arch, vae in (("rnagan", "sagan", True), ("gan", "sagan", False), ("biggan", "biggan", True)):
        model = tcfg.GANModelConfig(arch=arch, out_size=16, encoding_dims=16, step_channels=4, attn_size=8,
                                    num_classes=2 if arch == "biggan" else 0, compute_dtype="float32")
        cfg = tcfg.GANConfig(model=model, loss_type="wganvae" if vae else "wgan",
                             vae=tcfg.VAEModelConfig(**VAE), batch_size=4,
                             vae_checkpoint=str(ws / "vae" / "model_dict_best.pt") if vae else None)
        tr = GANTrainer(cfg, device="cpu")
        st = tr.init_state()
        rng = np.random.RandomState(7)
        batch = {"image": rng.randint(0, 256, (4, 16, 16, 3), dtype=np.uint8),
                 "rna_data": rng.randn(4, GENES).astype(np.float32), "labels": np.array([0, 1, 1, 0])}
        tr.train_step(st, batch)
        out[name] = str(ws / f"{name}.model")
        tr.save_model(st, out[name])
    assert cfg_json["img_size"] == 16
    return out


def test_representation_cli_takes_sagan(ws, bundles):
    save = ws / "reps"
    reps = representation.main([
        "--config", str(ws / "gan.json"), "--checkpoint", bundles["rnagan"], "--checkpoint2", bundles["gan"],
        "--vae", str(ws / "vae" / "model_dict_best.pt"), "--gan_type", "sagan", "--max_patients", "2",
        "--tiles_per_patient", "2", "--num_patches", "4", "--condition_mode", "population",
        "--save_dir", str(save), "--device", "cpu"])
    for name in ("real", "rnagan", "gan"):
        assert reps[name].shape == (2, 2048) and np.isfinite(reps[name]).all()
        np.testing.assert_array_equal(np.load(save / f"representations_{name}.npy"), reps[name])


def test_generate_and_fid_take_biggan(ws, bundles):
    common = ["--config", str(ws / "gan.json"), "--checkpoint", bundles["biggan"], "--gan_type", "biggan",
              "--vae", str(ws / "vae" / "model_dict_best.pt"), "--device", "cpu"]
    imgs = generate.main([*common, "--rna_file", str(ws / "tissue0.csv"), "--random_patient",
                          "--sample_size", "4", "--save_path", str(ws / "gen.png")])
    assert imgs.shape == (4, 16, 16, 3) and os.path.exists(ws / "gen.png")
    mean, _ = fid.main([*common, "--patient1", "GTEX-01.svs", "--num_images", "4", "--repetitions", "1",
                        "--batch_size", "4"])
    assert np.isfinite(mean)


# ----------------------------------------------------------------------- main


def test_main_dispatches(ws, capsys, tmp_path):
    assert main.main([]) == 0
    listed = capsys.readouterr().out
    assert all(name in listed for name in jmain.COMMANDS)
    assert set(main.COMMANDS) == set(jmain.COMMANDS) | {"metrics"}  # the JAX table, and metrics
    assert main.main(["nope"]) == 2
    with pytest.raises(SystemExit) as exit_:  # export-torch is ported: argparse prints its help
        main.main(["export-torch", "--help"])
    assert exit_.value.code == 0 and "--to_native" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exit_:  # ml-experiment is ported: argparse prints its help
        main.main(["ml-experiment", "--help"])
    assert exit_.value.code == 0 and "--backbone_weights" in capsys.readouterr().out
    path = str(tmp_path / "run.jsonl")
    _jsonl(path)
    assert main.main(["metrics", path, "--tag", "gan"]) == 0
    assert "d_loss" in capsys.readouterr().out
    out = str(tmp_path / "s.pkl")
    assert main.main(["sample", "--config", str(ws / "vae.json"), "--checkpoint",
                      str(ws / "vae" / "model_dict_best.pt"), "--num_samples", "2", "--save_path", out,
                      "--device", "cpu"]) == 0
    assert _load(out)["expression"].shape == (2, GENES)
