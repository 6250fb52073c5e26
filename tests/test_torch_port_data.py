"""The port's tile data plane against the JAX package's.

Stores written by either package's ``LMDBTileWriter`` read bit-equal in the
other; corrupt entries are dropped alike; the restricted unpickler refuses
globals; the slide table, ``load_patch_data``, ``patient_tiles``,
``PatchBatches`` and ``StreamingPatchBatches`` give the JAX package's tiles,
labels and RNA rows for the same CSVs and seed; and ``cli.gan_train`` trains
an epoch on the CPU from a JAX-format VAE checkpoint with an FID probe.
"""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_port_parity import jax_vae_variables

from rnagan_tpu.cli.common import load_gan_dataframe as jax_load_gan_dataframe
from rnagan_tpu.core import checkpoint as jckpt
from rnagan_tpu.core import config as jcfg
from rnagan_tpu.data import patches as jpatches
from rnagan_tpu.data import rna as jrna
from rnagan_tpu.data import store as jstore
from rnagan_tpu.data import tiles as jtiles
from rnagan_tpu_torch.cli import fid, gan_train, generate
from rnagan_tpu_torch.cli.common import load_gan_dataframe
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.data import patches as tpatches
from rnagan_tpu_torch.data import rna as trna
from rnagan_tpu_torch.data import store as tstore
from rnagan_tpu_torch.data import tiles as ttiles
from rnagan_tpu_torch.eval import representation as trep
from rnagan_tpu_torch.train.gan_trainer import GANTrainer

GENES = 12
TILE = 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once, and a full
    thread pool in each makes the CPU convolutions crawl."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _write_tiles(writer_cls, path, rng, n, size=TILE):
    tiles = rng.randint(0, 256, (n, size, size, 3), dtype=np.uint8)
    with writer_cls(path) as w:
        for i, t in enumerate(tiles):
            w.put_tile(f"tile_{i}", t)
    return tiles


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_read_bit_equal_across_packages(tmp_path, writer):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "slide.db")
    writer_cls = jstore.LMDBTileWriter if writer == "jax" else tstore.LMDBTileWriter
    tiles = _write_tiles(writer_cls, path, rng, 40)
    with jstore.LMDBTileStore(path) as js, tstore.LMDBTileStore(path) as ts:
        assert ts.keys() == js.keys() == [str(i).encode() for i in range(40)]
        assert len(ts) == len(js)
        for k in (b"0", b"17", b"39", b"missing"):
            assert ts.get_raw(k) == js.get_raw(k)
        np.testing.assert_array_equal(ts.get_tile(b"5"), tiles[5][..., ::-1])  # BGR -> RGB on read
        keys = [b"3", b"1", b"38", b"nope"]
        (a, ok_a), (b, ok_b) = ts.load_tiles_fixed(keys, TILE, TILE), js.load_tiles_fixed(keys, TILE, TILE)
        np.testing.assert_array_equal(ok_a, ok_b)
        np.testing.assert_array_equal(a[ok_a], b[ok_b])
        (a, kept_a), (b, kept_b) = ts.load_tiles(keys), js.load_tiles(keys)
        assert kept_a == kept_b == keys[:3]
        np.testing.assert_array_equal(a, b)
        assert ts.prewarm() == js.prewarm() == os.path.getsize(path)


def test_lz4_and_tile_values_match_jax(rng):
    data = rng.bytes(70_000) + b"tile" * 5000
    assert tstore.lz4f_compress(data) == jstore.lz4f_compress(data)
    assert tstore.lz4f_decompress(jstore.lz4f_compress(data)) == data
    img = rng.randint(0, 256, (8, 8, 3), dtype=np.uint8)
    value = tstore.serialize_tile("a", img)
    assert value == jstore.serialize_tile("a", img)
    np.testing.assert_array_equal(tstore.deserialize_tile(value), jstore.deserialize_tile(value))


def test_corrupt_entries_are_dropped_alike(tmp_path, rng):
    path = str(tmp_path / "bad.db")
    with tstore.LMDBTileWriter(path) as w:
        for i in range(6):
            w.put_tile(f"t{i}", rng.randint(0, 256, (TILE, TILE, 3), dtype=np.uint8))
        w.put_raw(b"garbage", b"not an lz4 frame")
        w.put_raw(b"short", tstore.serialize_tile("s", np.zeros((4, 4, 3), np.uint8)))
        w.put_raw(b"truncated", tstore.serialize_tile("x", np.ones((TILE, TILE, 3), np.uint8))[:-9])
    keys = [b"0", b"garbage", b"1", b"short", b"truncated", b"5"]
    with jstore.LMDBTileStore(path) as js, tstore.LMDBTileStore(path) as ts:
        (a, kept_a), (b, kept_b) = ts.load_tiles(keys), js.load_tiles(keys)
        assert kept_a == kept_b == [b"0", b"1", b"5"]
        np.testing.assert_array_equal(a, b)
        for k in (b"garbage", b"truncated"):
            assert ts.get_tile(k) is None and js.get_tile(k) is None


class _Evil:
    def __reduce__(self):
        return (eval, ("1 + 1",))


@pytest.mark.parametrize("payload", [
    ("t", _Evil(), (2, 2, 3)),
    ("t", np.zeros(12, np.uint8), (2, 2, 3)),  # an ndarray names numpy's globals
])
def test_restricted_unpickler_refuses_globals(tmp_path, payload):
    raw = pickle.dumps(payload)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tstore.restricted_loads(raw)
    assert tstore.deserialize_tile(tstore.lz4f_compress(raw)) is None
    # a key index that names a global is ignored: the keys come from a tree walk
    path = str(tmp_path / "evil.db")
    w = tstore.LMDBTileWriter(path)
    w.put_raw(b"7", tstore.serialize_tile("t", np.zeros((TILE, TILE, 3), np.uint8)))
    w.put_raw(b"__keys__", tstore.lz4f_compress(pickle.dumps([b"7", _Evil()])))
    w._lib.ts_lmdb_writer_close(w._h)
    w._h = None
    with tstore.LMDBTileStore(path) as ts:
        assert ts.keys() == [b"7"]


def test_tile_batches_and_prefetcher_match_jax(rng):
    images = rng.randint(0, 256, (11, 4, 4, 3), dtype=np.uint8)
    rna, labels = rng.randn(11, 5).astype(np.float32), rng.randint(0, 3, 11)
    np.testing.assert_array_equal(ttiles.tiles_to_float(images), jtiles.tiles_to_float(images))
    kw = dict(batch_size=4, seed=3, pad_to=2)
    a, b = ttiles.TileBatches(images, rna, labels, **kw), jtiles.TileBatches(images, rna, labels, **kw)
    assert len(a) == len(b)
    for epoch in (0, 1):
        for x, y in zip(a.epoch(epoch), b.epoch(epoch), strict=True):
            assert set(x) == set(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
    assert list(ttiles.Prefetcher(iter(range(5)), depth=2)) == list(range(5))

    def failing():
        yield 1
        raise OSError("disk gone")

    pf = ttiles.Prefetcher(failing())
    assert next(pf) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(pf)


# ------------------------------------------------------------- slide corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two tissue CSVs (5 and 4 slides, ``rna_*`` columns and
    ``wsi_file_name``), a database per slide except one, one slide with a
    corrupt entry and one with nothing but; and a reference-layout JSON config."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(1)
    csvs, dirs = [], []
    for tissue, n_slides in enumerate((5, 4)):
        patch_dir = root / f"tiles_{tissue}"
        patch_dir.mkdir()
        names = [f"GTEX-{tissue}{i}.svs" if i % 2 else f"GTEX-{tissue}{i}" for i in range(n_slides)]
        # integer counts: pandas' float parser and Python's float() agree on them
        frame = pd.DataFrame(rng.randint(0, 500, (n_slides, GENES)).astype(float),
                             columns=[f"rna_{g}" for g in range(GENES)])
        frame.insert(3, "wsi_file_name", names)
        frame["other"] = np.arange(n_slides)
        csv = root / f"tissue_{tissue}.csv"
        frame.to_csv(csv, index=False)
        for i, name in enumerate(names):
            if tissue == 1 and i == 1:
                continue  # a slide without a database: skipped, and no draw
            db = jpatches.slide_db_path(str(patch_dir), name)
            os.makedirs(os.path.dirname(db))
            with tstore.LMDBTileWriter(db) as w:
                if tissue == 1 and i == 3:  # a slide none of whose entries decode: kept, then dropped
                    for _ in range(5):
                        w.put_raw(str(w._count).encode(), b"corrupt")
                        w._count += 1
                    continue
                for t in range(7 + 3 * i):
                    w.put_tile(f"{name}_{t}", rng.randint(0, 256, (TILE, TILE, 3), dtype=np.uint8))
                if tissue == 0 and i == 2:  # an indexed entry that does not decode
                    w.put_raw(str(w._count).encode(), b"corrupt")
                    w._count += 1
        csvs.append(str(csv))
        dirs.append(str(patch_dir))
    config = {"path_csv": csvs, "patch_data_path": dirs}
    path = root / "config.json"
    path.write_text(json.dumps(config))
    return config, str(path), root


def _normalized(config):
    """The JAX frame and the port's table, each normalized as gan_train does."""
    df = jax_load_gan_dataframe(config)
    cols = jrna.rna_columns(df)
    vals = jrna.log_transform(df[cols].values)
    df[cols] = jrna.Scaler.fit(vals, "standard").transform(vals)
    table = load_gan_dataframe(config)
    tvals = trna.log_transform(table.rna.values)
    return df, table.with_rna_values(trna.Scaler.fit(tvals, "standard").transform(tvals))


def test_slide_table_matches_pandas_frame(corpus):
    config = corpus[0]
    df = jax_load_gan_dataframe(config)
    table = load_gan_dataframe(config)
    cols = jrna.rna_columns(df)
    assert list(table.rna.columns) == cols
    np.testing.assert_array_equal(table.rna.values, df[cols].values)
    assert list(table.wsi_file_name) == list(df["wsi_file_name"])
    assert list(table.patch_data_path) == list(df["patch_data_path"])
    np.testing.assert_array_equal(table.labels, df["labels"].values)
    picked = trna.sample_rows(table.rna, 5, seed=4)
    assert list(picked.wsi_file_name) == list(df.sample(5, random_state=4)["wsi_file_name"])


def _assert_patch_data_equal(a, b):
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.slide_idx, b.slide_idx)
    assert a.slides == b.slides
    if b.rna is None:
        assert a.rna is None
    else:
        np.testing.assert_array_equal(a.rna, b.rna)


@pytest.mark.parametrize("with_rna", [False, True])
@pytest.mark.parametrize("quick", [False, True])
def test_load_patch_data_matches_jax(corpus, with_rna, quick):
    df, table = _normalized(corpus[0])
    kw = dict(max_patches_total=9, seed=5, quick=quick, with_rna=with_rna, verbose=False)
    got, ref = tpatches.load_patch_data(table, **kw), jpatches.load_patch_data(df, **kw)
    assert len(ref) > 0 and len(ref.slides) == 7  # the slide without a database is skipped
    _assert_patch_data_equal(got, ref)


def test_patient_tiles_match_jax(corpus):
    df, table = _normalized(corpus[0])
    for patient in ("GTEX-01.svs", "GTEX-10"):
        (a, rna_a), (b, rna_b) = (tpatches.patient_tiles(table, patient, 5, seed=2),
                                  jpatches.patient_tiles(df, patient, 5, seed=2))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(rna_a, rna_b)
    with pytest.raises(KeyError):
        tpatches.patient_tiles(table, "GTEX-nobody", 5)


def test_patch_batches_match_jax(corpus):
    df, table = _normalized(corpus[0])
    kw = dict(max_patches_total=9, seed=6, with_rna=True, verbose=False)
    got, ref = tpatches.load_patch_data(table, **kw), jpatches.load_patch_data(df, **kw)
    bkw = dict(batch_size=8, with_rna=True, with_labels=True, seed=6)
    a, b = tpatches.PatchBatches(got, **bkw), jpatches.PatchBatches(ref, **bkw)
    assert len(a) == len(b)
    for epoch in (0, 1):
        for x, y in zip(a.epoch(epoch), b.epoch(epoch), strict=True):
            assert set(x) == set(y) == {"image", "rna_data", "labels"}
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("emit_uint8", [False, True])
def test_streaming_batches_match_jax(corpus, emit_uint8):
    df, table = _normalized(corpus[0])
    kw = dict(batch_size=8, max_patches_total=9, with_rna=True, with_labels=True, seed=7,
              emit_uint8=emit_uint8, prewarm=True)
    a, b = tpatches.StreamingPatchBatches(table, **kw), jpatches.StreamingPatchBatches(df, **kw)
    try:
        a.wait_prewarm(30)
        assert len(a) == len(b)
        for x, y in zip(a.epoch(1), b.epoch(1), strict=True):
            for k in ("image", "rna_data", "labels"):
                np.testing.assert_array_equal(x[k], y[k])
    finally:
        a.close()
        b.close()


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """``cli.gan_train`` for one epoch on the CPU from the slide CSVs, a
    JAX-format VAE bundle as ``--vae_checkpoint`` and an FID probe (the
    Inception at its real widths on 16x16 tiles resized to 299)."""
    config, _, _ = corpus
    tmp = tmp_path_factory.mktemp("gan_train")
    small = {**config, "img_size": TILE, "encoding_dims": 8, "step_channels": 4,
             "compute_dtype": "float32", "rna_features": GENES, "z_dim": 8,
             "encoder_dims": [10, 8], "decoder_dims": [10]}
    cfg_path = str(tmp / "small.json")
    with open(cfg_path, "w") as f:
        json.dump(small, f)
    vae_model = jcfg.VAEModelConfig(rna_features=GENES, z_dim=8, encoder_dims=(10, 8), decoder_dims=(10,))
    vae_ckpt = str(tmp / "model_best.ckpt")
    jckpt.save_bundle(vae_ckpt, jax_vae_variables(vae_model, seed=3), {"config": "betavae"})
    model_dir = str(tmp / "models")
    res = gan_train.main(["--config", cfg_path, "--device", "cpu", "--num_epochs", "1",
                          "--num_patches", "6", "--batch_size", "8", "--vae_checkpoint", vae_ckpt,
                          "--fid_every", "1", "--fid_images", "4", "--model_dir", model_dir,
                          "--image_dir", str(tmp / "images")])
    tc = tcfg.GANConfig(model=tcfg.GANModelConfig(out_size=TILE, encoding_dims=8, step_channels=4,
                                                  compute_dtype="float32"),
                        vae=tcfg.VAEModelConfig(rna_features=GENES, z_dim=8, encoder_dims=(10, 8),
                                                decoder_dims=(10,)),
                        vae_checkpoint=vae_ckpt)
    return res, tc, cfg_path, vae_ckpt, model_dir, tmp


def test_gan_train_cli_trains_an_epoch_on_the_corpus(trained):
    res, tc, _, _, model_dir, tmp = trained
    last = res["history"][-1]
    assert res["data"]["slides"] == 7 and res["data"]["tiles"] == 42
    assert np.isfinite(last["fid"]) and np.isfinite(last["d_loss"])
    tr = GANTrainer(tc, device="cpu")
    for name in ("gan_last.model", "gan_best.model"):  # the bundles it writes reload
        state = tr.load_model(os.path.join(model_dir, name))
        assert state.step == 6 and tr.z_pop is not None
    assert torch.isfinite(tr.z_pop[1]).all()
    assert os.path.exists(tmp / "images" / "epoch_0.png")


def test_generate_and_fid_clis_run(trained, corpus):
    """``cli.generate`` (a patient of the corpus CSV, population mode, the
    comparison grids) and ``cli.fid`` (a patient's real tiles against the
    checkpoint's samples, 2 repetitions) on the CPU."""
    _, _, cfg_path, vae_ckpt, model_dir, tmp = trained
    ckpt = os.path.join(model_dir, "gan_last.model")
    common = ["--config", cfg_path, "--device", "cpu", "--seed", "3"]
    imgs = generate.main([*common, "--checkpoint", ckpt, "--vae", vae_ckpt,
                          "--rna_file", corpus[0]["path_csv"][0], "--patient", "GTEX-01.svs",
                          "--condition_mode", "population", "--sample_size", "6",
                          "--save_path", str(tmp / "gen.png"), "--checkpoint2", ckpt,
                          "--save_dir", str(tmp / "compare")])
    assert imgs.shape == (6, TILE, TILE, 3) and 0.0 <= float(imgs.min()) <= float(imgs.max()) <= 1.0
    assert sorted(os.listdir(tmp / "compare")) == ["patient_gan.png", "patient_real.png",
                                                   "patient_rnagan.png"]
    mean, std = fid.main([*common, "--checkpoint", ckpt, "--vae", vae_ckpt, "--patient1", "GTEX-10",
                          "--num_images", "4", "--repetitions", "2", "--batch_size", "4"])
    assert np.isfinite(mean) and np.isfinite(std)


def test_compute_representations_runs(trained, corpus):
    """Per-patient mean activations of real, RNA-GAN and GAN tiles (an
    extractor of mean colours stands in for Inception), written as .npy."""
    _, tc, _, _, model_dir, tmp = trained
    _, table = _normalized(corpus[0])
    tr = GANTrainer(tc, device="cpu")
    state = tr.load_model(os.path.join(model_dir, "gan_last.model"))

    def extractor(images, batch_size):
        return torch.as_tensor(images).float().mean(dim=(1, 2))

    patients = ["GTEX-01.svs", "GTEX-10"]
    reps = trep.compute_representations(
        patients, lambda p: tpatches.patient_tiles(table, p, 5, seed=1)[0],
        lambda p: tpatches.patient_tiles(table, p, 1, seed=1)[1], tr, state, tr, state, seed=4,
        tiles_per_patient=6, extractor=extractor, save_dir=str(tmp / "reps"),
        condition_mode="population")
    assert {k: v.shape for k, v in reps.items()} == {k: (2, 3) for k in ("real", "rnagan", "gan")}
    tiles = tpatches.patient_tiles(table, "GTEX-10", 5, seed=1)[0]
    np.testing.assert_allclose(reps["real"][1], tiles.astype(np.float32).mean(axis=(0, 1, 2)) / 255.0,
                               rtol=1e-6)
    np.testing.assert_array_equal(np.load(tmp / "reps" / "representations_rnagan.npy"), reps["rnagan"])
