"""The LMDB data-plane tools on the port (``tools/make_lmdb_corpus_torch.py``,
``tools/data_plane_run_torch.py``) against the JAX package, on the CPU.

* The corpus the port writes is the JAX package's format: each value holds
  the tile BGR, and the JAX ``LMDBTileStore`` reads every tile back (its
  BGR->RGB swap) equal to the port's render cast to uint8 (round half up); ``expression.csv`` read with pandas and
  ``rnagan_tpu/data/rna.py``'s columns equals the port's ``RNATable`` and the
  corpus's float32 expression.
* Resumability: a complete store is kept, a partial one written anew.
* A ``--smoke`` data-plane run (wganvae through ``StreamingPatchBatches``,
  the three transfer modes) writes the JAX tool's JSON keys (read from its
  source with ``ast``); ``--probe_only`` resolves no device.
"""

import os
import pickle
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_port_representation_run import source_keys

from rnagan_tpu.data import rna as jrna
from rnagan_tpu.data.store import LMDBTileStore as JaxStore
from rnagan_tpu.data.store import lz4f_decompress
from rnagan_tpu_torch.data.rna import RNATable
from rnagan_tpu_torch.data.store import LMDBTileWriter
from rnagan_tpu_torch.data.synthetic import SyntheticCorpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)
import data_plane_run_torch as dp  # noqa: E402
import make_lmdb_corpus_torch as mk  # noqa: E402

SLIDES, TILES, GENES, SIZE, BATCH = 3, 5, 16, 32, 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _write(out):
    return mk.main(["--device", "cpu", "--out", str(out), "--slides", str(SLIDES), "--tiles_per_slide", str(TILES),
                    "--genes", str(GENES), "--size", str(SIZE), "--batch", str(BATCH)])


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("corpus")
    summary = _write(out)
    assert summary["slides_written"] == SLIDES and summary["tiles_written"] == SLIDES * TILES
    return out


def test_stores_read_by_the_jax_package(corpus_dir):
    """Each value is the reference's ``(name, BGR bytes, shape)``; the JAX
    reader's BGR->RGB swap gives back the render, bit for bit."""
    corpus = SyntheticCorpus(n_slides=SLIDES, tiles_per_slide=TILES, n_genes=GENES, size=SIZE, device="cpu")
    for s in range(SLIDES):
        imgs = corpus.render(np.full(TILES, s), np.arange(TILES)).numpy()
        want = np.clip((imgs + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)
        with JaxStore(str(corpus_dir / f"slide{s:04d}" / f"slide{s:04d}.db")) as st:
            keys = st.keys()
            assert len(keys) == TILES
            tiles, kept = st.load_tiles(keys)
            raw = [pickle.loads(lz4f_decompress(st.get_raw(k))) for k in keys]
        assert kept == keys
        np.testing.assert_array_equal(tiles, want)
        for j, (name, data, shape) in enumerate(raw):
            assert name == f"slide{s:04d}_patch_{j}" and tuple(shape) == (SIZE, SIZE, 3)
            np.testing.assert_array_equal(np.frombuffer(data, np.uint8).reshape(shape), want[j][..., ::-1])


def test_expression_csv_read_by_pandas_equals_the_port_table(corpus_dir):
    path = str(corpus_dir / "expression.csv")
    df = pd.read_csv(path)
    cols = jrna.rna_columns(df)
    table = RNATable.read_csv(path)
    assert cols == list(table.columns) == [f"rna_g{i}" for i in range(GENES)]
    assert list(df["wsi_file_name"]) == list(table.wsi_file_name) == [f"slide{s:04d}" for s in range(SLIDES)]
    np.testing.assert_array_equal(df[cols].values, table.values)
    expr = SyntheticCorpus(n_slides=SLIDES, tiles_per_slide=TILES, n_genes=GENES, size=SIZE,
                           device="cpu").expression.numpy()
    np.testing.assert_array_equal(table.values.astype(np.float32), expr)  # float() gives back each float32


def test_complete_stores_are_kept_and_partial_ones_rewritten(tmp_path):
    out = tmp_path / "c"
    _write(out)
    db = out / "slide0001" / "slide0001.db"
    kept = (out / "slide0000" / "slide0000.db").stat().st_mtime_ns
    with LMDBTileWriter(str(db)) as w:  # an interrupted slide: 2 tiles of 5
        for j in range(2):
            w.put_tile(f"slide0001_patch_{j}", np.zeros((SIZE, SIZE, 3), np.uint8))
    assert not mk.store_is_complete(str(db), TILES)
    summary = _write(out)
    assert summary["slides_written"] == 1
    assert mk.store_is_complete(str(db), TILES)
    assert (out / "slide0000" / "slide0000.db").stat().st_mtime_ns == kept
    assert _write(out)["slides_written"] == 0


def test_smoke_data_plane_run_writes_the_jax_tools_keys(tmp_path):
    """The corpus rebuilt in-process, the VAE pre-train, the probes, the
    overlap A/B over the three transfer modes and one streamed epoch."""
    out = str(tmp_path / "dp.json")
    corpus = str(tmp_path / "corpus")
    result = dp.main(["--smoke", "--device", "cpu", "--corpus", corpus, "--out", out, "--overlap_ab", "2"])
    assert os.path.exists(os.path.join(corpus, "expression.csv"))
    jkeys = source_keys(os.path.join(TOOLS, "data_plane_run.py"))
    assert sorted(result) == jkeys["result"]
    assert sorted(result["meta"]) == jkeys["result.meta"]
    assert sorted(result["device_put_ms"]) == jkeys["xfer"] == ["float32", "uint8"]
    assert sorted(result["overlap_ab_ms"]) == jkeys["modes"]
    assert all(len(v) == 2 for v in result["overlap_ab_ms"].values())
    (epoch,) = result["epochs"]
    assert sorted(epoch) == jkeys["rec"]
    assert epoch["steps"] == 8 and np.isfinite([epoch["d_loss"], epoch["g_loss"]]).all()
    assert result["meta"]["tiles"] == 32 and result["resident_step_ms"] > 0


def test_probe_only_resolves_no_device(tmp_path, monkeypatch):
    from rnagan_tpu_torch.core import device

    corpus = str(tmp_path / "corpus")
    mk.main(["--smoke", "--device", "cpu", "--out", corpus])

    def no_device(*_args, **_kw):
        raise AssertionError("--probe_only resolved a device")

    monkeypatch.setattr(device, "resolve_device", no_device)
    res = dp.main(["--smoke", "--corpus", corpus, "--probe_only", "--host_probe_batches", "3"])
    assert sorted(res) == ["host_ms_per_batch", "host_pipeline_tiles_per_s"]
    assert res["host_pipeline_tiles_per_s"] > 0


def test_close_stops_the_workers_of_unfinished_epochs(corpus_dir):
    """The tools leave epochs unfinished (the host probe, the overlap A/B):
    ``close`` stops their workers, which still decode ahead, before it
    closes the stores they read."""
    from rnagan_tpu_torch.data.patches import SlideTable, StreamingPatchBatches

    rna = RNATable.read_csv(str(corpus_dir / "expression.csv"))
    table = SlideTable(rna, np.array([str(corpus_dir)] * SLIDES, dtype=object), np.zeros(SLIDES, np.int64))
    batches = StreamingPatchBatches(table, batch_size=1, max_patches_total=TILES, emit_uint8=True,
                                    prefetch_depth=1)
    epochs = [iter(batches.epoch(e)) for e in range(3)]
    first = [next(it)["image"] for it in epochs]
    assert all(x.shape == (1, SIZE, SIZE, 3) for x in first)
    batches.close()
    assert not any(it._thread.is_alive() for it in epochs)
