"""The port's procedural corpus (``rnagan_tpu_torch/data/synthetic.py``)
against ``rnagan_tpu/data/synthetic.py``, and the port's quality run.

Given JAX's draws (made here exactly as each JAX function makes them), the
port's deterministic functions give JAX's values: tiles within 1e-5
absolute (the nucleus union is a product in another order), latents, gene
map and expression within 1e-5 relative. On the port's own Philox draws the
corpus has the properties of ``tests/test_synthetic.py`` and, at JAX's slide
latents, JAX's statistics: per-channel tile mean and std over 64 tiles
within 0.02, nucleus coverage within 0.03, the expression's zero fraction
within 0.02. ``tools/quality_run_torch.py --smoke`` writes the JAX tool's
JSON keys.
"""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnagan_tpu.data import synthetic as J
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.data import synthetic as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tool's subprocess runs two threads, as the tests in this process: the
#: suite runs several workers at once, and a full thread pool in each makes
#: the CPU kernels crawl (a subprocess with all 8 ran past its 300 s limit)
TWO_THREADS = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_tile_draws(key, size, max_nuclei):
    """``render_tile``'s draws for ``key``, as it makes them."""
    m = max_nuclei
    ks = jax.random.split(key, 8)
    return {"kf": jax.random.uniform(ks[0], (6, 2), minval=-1.0, maxval=1.0),
            "ph": jax.random.uniform(ks[1], (6,), maxval=2 * jnp.pi),
            "centers": jax.random.uniform(ks[2], (m, 2), maxval=float(size)),
            "present": jax.random.uniform(ks[3], (m,)),
            "radii": jax.random.uniform(ks[4], (m,), minval=0.65, maxval=1.35),
            "thetas": jax.random.uniform(ks[5], (m,), maxval=jnp.pi),
            "lcenters": jax.random.uniform(ks[6], (4, 2), maxval=float(size)),
            "lpresent": jax.random.uniform(ks[7], (4,)),
            "noise": jax.random.normal(jax.random.fold_in(key, 99), (size, size, 3))}


SIZES = [(32, 96), (32, 8), (64, 96), (64, 8)]


@pytest.mark.parametrize("size,max_nuclei", SIZES)
def test_render_tile_matches_jax(size, max_nuclei):
    rng = np.random.RandomState(size + max_nuclei)
    for i in range(3):
        key = jax.random.key(i)
        s = (1.5 * rng.randn(J.LATENT)).astype(np.float32)
        ref = np.asarray(J.render_tile(key, jnp.asarray(s), size, max_nuclei))
        draws = {k: _t(v) for k, v in jax_tile_draws(key, size, max_nuclei).items()}
        got = T.render_tile_from_draws(torch.from_numpy(s), draws, size, max_nuclei).numpy()
        assert got.shape == (size, size, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size,max_nuclei", SIZES)
def test_render_batch_matches_jax(size, max_nuclei):
    """``render_batch``'s per-tile keys (``fold_in(key, tile_id)``) give the
    draws; the port renders the batch at once."""
    rng = np.random.RandomState(7)
    key = jax.random.key(11)
    s = (1.5 * rng.randn(5, J.LATENT)).astype(np.float32)
    ids = np.array([0, 3, 17, 214, 5], np.int32)
    ref = np.asarray(J.render_batch(key, jnp.asarray(s), jnp.asarray(ids), size, max_nuclei))
    per_tile = [jax_tile_draws(jax.random.fold_in(key, int(t)), size, max_nuclei) for t in ids]
    draws = {k: torch.stack([_t(d[k]) for d in per_tile]) for k in per_tile[0]}
    got = T.render_batch_from_draws(torch.from_numpy(s), draws, size, max_nuclei).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_soft_disc_matches_jax(rng):
    yy, xx = np.mgrid[0:16, 0:16].astype(np.float32)
    for _ in range(4):
        cy, cx, theta = (rng.rand(3) * [16, 16, np.pi]).astype(np.float32)
        ry, rx = (2 + 3 * rng.rand(2)).astype(np.float32)
        ref = np.asarray(J._soft_disc(jnp.asarray(yy), jnp.asarray(xx), cy, cx, ry, rx, theta))
        got = T._soft_disc(_t(yy), _t(xx), *(torch.tensor(v) for v in (cy, cx, ry, rx, theta))).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_sample_slides_matches_jax():
    key = jax.random.key(4)
    ref = J.sample_slides(key, 10, 3)
    k1, k2, _ = jax.random.split(key, 3)
    got = T.sample_slides_from_draws(10, 3, _t(jax.random.normal(k1, (3, J.LATENT))),
                                     _t(jax.random.normal(k2, (10, J.LATENT))))
    np.testing.assert_allclose(got.s.numpy(), np.asarray(ref.s), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got.tissue.numpy(), np.asarray(ref.tissue))


def _jax_gene_map_draws(key, n_genes):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return (_t(jax.random.normal(k1, (J.LATENT, n_genes))), _t(jax.random.uniform(k2, (n_genes,))),
            _t(jax.random.normal(k3, (n_genes,))), _t(jax.random.uniform(k4, (n_genes,), maxval=0.35)))


def test_make_gene_map_matches_jax():
    key = jax.random.key(5)
    ref = J.make_gene_map(key, 300)
    got = T.make_gene_map_from_draws(*_jax_gene_map_draws(key, 300))
    for k in ("W", "base", "zero_p"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=0, err_msg=k)


def test_expression_from_slides_matches_jax():
    key = jax.random.key(6)
    slides = J.sample_slides(jax.random.fold_in(key, 0), 12)
    gene_map = J.make_gene_map(jax.random.fold_in(key, 1), 500)
    ekey = jax.random.fold_in(key, 2)
    ref = np.asarray(J.expression_from_slides(ekey, slides.s, gene_map))
    k1, k2 = jax.random.split(ekey)
    got = T.expression_from_slides_from_draws(
        _t(slides.s), {k: _t(v) for k, v in gene_map.items()},
        _t(jax.random.normal(k1, (12, 500))), _t(jax.random.uniform(k2, (12, 500)))).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


# ----------------------------------------------- the corpus on Philox draws


def test_render_tile_shape_range_determinism():
    s = torch.zeros(T.LATENT)
    a = T.render_tile(0, 0, s, 64, 32)
    b = T.render_tile(0, 0, s, 64, 32)
    assert a.shape == (64, 64, 3) and a.dtype == torch.float32
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0
    assert torch.equal(a, b)
    assert not torch.allclose(a, T.render_tile(0, 1, s, 64, 32))
    assert not torch.allclose(a, T.render_tile(1, 0, s, 64, 32))  # another corpus seed


def test_latent_changes_morphology():
    """The nuclei density latent visibly changes tile statistics."""
    sparse = torch.zeros(T.LATENT)
    sparse[0] = -3.0
    dense = -sparse
    t_sparse = T.render_tile(1, 0, sparse, 64, 48)
    t_dense = T.render_tile(1, 0, dense, 64, 48)
    assert float(t_dense.mean()) < float(t_sparse.mean()) - 0.05  # nuclei are dark


def test_corpus_batches_and_expression_coupling():
    corpus = T.SyntheticCorpus(n_slides=12, tiles_per_slide=10, n_genes=64, size=32, seed=0,
                               n_tissues=2, device="cpu")
    assert corpus.expression.shape == (12, 64)
    expr = corpus.expression.numpy()
    assert expr.min() >= 0.0 and (expr == 0).mean() > 0.02  # zero-inflated

    sl, ti = corpus.batch_ids(3, 8)
    assert sl.shape == ti.shape == (1, 8)
    assert int(sl.max()) < 12 and int(ti.max()) < 10 and int(min(sl.min(), ti.min())) >= 0
    imgs = corpus.render(sl[0], ti[0])
    assert imgs.shape == (8, 32, 32, 3)
    assert torch.equal(imgs, corpus.render(sl[0], ti[0]))
    assert not torch.allclose(imgs, corpus.render(sl[0], ti[0] + 1))

    # slides close in expression space are close in latent space (the map is
    # linear in s), hence similar tiles: tissues cluster in expression
    tissue = corpus.slides.tissue.numpy()
    log_expr = np.log1p(expr)
    d_within, d_across = [], []
    for i in range(12):
        for j in range(i + 1, 12):
            d = np.linalg.norm(log_expr[i] - log_expr[j])
            (d_within if tissue[i] == tissue[j] else d_across).append(d)
    assert np.mean(d_within) < np.mean(d_across), "tissues must cluster in expression"

    batches = list(corpus.batches(2, 4, 3, seed=5, expr_norm=corpus.expression))
    assert len(batches) == 3 and batches[0]["image"].shape == (4, 32, 32, 3)
    again = list(corpus.batches(2, 4, 3, seed=5))
    assert torch.equal(again[2]["image"], batches[2]["image"]) and "rna_data" not in again[0]
    assert not torch.equal(next(corpus.batches(3, 4, 1, seed=5))["image"], batches[0]["image"])
    sl, _ = corpus.batch_ids(SeedStream(5).seed("synthetic_batches", 2), 4, 3)
    assert torch.equal(batches[1]["rna_data"], corpus.expression[sl[1]])


def test_real_tiles_disjoint_from_training_ids():
    corpus = T.SyntheticCorpus(n_slides=4, tiles_per_slide=6, n_genes=16, size=32, seed=1, device="cpu")
    real = corpus.real_tiles(8)
    assert real.shape == (8, 32, 32, 3)
    assert float(real.min()) >= 0.0 and float(real.max()) <= 1.0
    # the ids of held-out tiles never collide with any slide's training-tile ids
    tps, span, stride = corpus.tiles_per_slide, corpus.HELDOUT_SPAN, corpus.id_stride
    train_ids = {t + s * stride for s in range(corpus.n_slides) for t in range(tps)}
    held_ids = {tps + k + s * stride for s in range(corpus.n_slides) for k in range(span)}
    assert not (train_ids & held_ids)


def test_draws_are_addressable():
    """A tile's draws depend on (seed, tile id) alone: its place in the
    batch, the batch's other tiles and ``max_nuclei`` of the other slots
    change nothing."""
    a = T.tile_draws(3, torch.tensor([5, 9]), 32, 96)
    b = T.tile_draws(3, torch.tensor([9]), 32, 8)
    for k in ("kf", "ph", "lcenters", "noise"):
        assert torch.equal(a[k][1], b[k][0]), k
    assert torch.equal(a["present"][1, :8], b["present"][0])
    noise = a["noise"]
    assert abs(float(noise.mean())) < 0.02 and abs(float(noise.std()) - 1.0) < 0.02
    for k, (lo, hi) in {"kf": (-1, 1), "ph": (0, 2 * np.pi), "centers": (0, 32), "radii": (0.65, 1.35),
                        "thetas": (0, np.pi), "present": (0, 1)}.items():
        assert lo <= float(a[k].min()) and float(a[k].max()) < hi, k


def _nucleus_coverage(tiles01):
    """Share of pixels whose red channel is below 0.6: hematoxylin nuclei
    (red at most 0.52 with the chroma noise), not stroma (0.82 and up) or lumen."""
    return float((tiles01[..., 0] < 0.6).mean())


def test_statistics_match_jax_corpus():
    """At JAX's slide latents, the port's own draws give JAX's tile and
    expression statistics."""
    jc = J.SyntheticCorpus(n_slides=8, tiles_per_slide=8, n_genes=2048, size=64, seed=0)
    rng = np.random.RandomState(0)
    sl = rng.randint(0, 8, 64).astype(np.int32)
    ti = rng.randint(0, 8, 64).astype(np.int32)
    ref = (np.asarray(jc.render(jnp.asarray(sl), jnp.asarray(ti))) + 1) * 0.5
    s = _t(jc.slides.s)
    got = ((T.render_batch(0, s[torch.from_numpy(sl).long()],
                           torch.from_numpy(ti + sl * jc.id_stride).long(), 64) + 1) * 0.5).numpy()
    for c in range(3):
        assert abs(got[..., c].mean() - ref[..., c].mean()) <= 0.02, c
        assert abs(got[..., c].std() - ref[..., c].std()) <= 0.02, c
    assert abs(_nucleus_coverage(got) - _nucleus_coverage(ref)) <= 0.03
    assert 0.05 < _nucleus_coverage(ref) < 0.95  # the measure sees the nuclei

    expr = T.expression_from_slides(0, s, T.make_gene_map(0, 2048, device="cpu"))
    zeros = float((expr == 0).float().mean())
    assert abs(zeros - float((np.asarray(jc.expression) == 0).mean())) <= 0.02


def test_corpus_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the CUDA default does not raise here")
    for call in (lambda: T.SyntheticCorpus(n_slides=2, tiles_per_slide=2, n_genes=8, size=16),
                 lambda: T.sample_slides(0, 2), lambda: T.make_gene_map(0, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ------------------------------------------------------------- quality run


def _json_keys(result):
    return (sorted(result), sorted(result["meta"]), [sorted(h) for h in result["history"]],
            sorted(result["best"]))


def _jax_tool_keys(epochs):
    """The JSON keys that ``tools/quality_run.py`` writes, read from its
    source: its ``meta`` literal, its per-epoch ``rec`` literal and the keys
    it adds with the FID probe on (``fid_train_mode`` needs
    ``--probe_train``), and the dumped object's keys."""
    with open(os.path.join(REPO, "tools", "quality_run.py")) as f:
        tree = ast.parse(f.read())
    literals, added, dumped = {}, set(), None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            if isinstance(target, ast.Name):
                literals[target.id] = {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            target = node.targets[0]
            if getattr(target.value, "id", None) == "rec":
                added.add(target.slice.value)
        if isinstance(node, ast.Dict) and [getattr(k, "value", None) for k in node.keys] == ["meta", "history",
                                                                                             "best"]:
            dumped = {"best": {k.value for k in node.values[2].keys}}
    record = sorted(literals["rec"] | (added - {"fid_train_mode"}))
    return (["best", "history", "meta"], sorted(literals["meta"]), [record] * epochs, sorted(dumped["best"]))


@pytest.mark.parametrize("loss_type", ["wganvae", "wgan"])
def test_quality_run_torch_smoke(tmp_path, loss_type):
    """``--smoke --device cpu``: two epochs, finite losses and FID, grids,
    checkpoints, and the JAX tool's JSON keys."""
    wd = str(tmp_path / "q")
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "quality_run_torch.py"), "--smoke",
                          "--device", "cpu", "--loss_type", loss_type, "--workdir", wd], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300, env=TWO_THREADS)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(os.path.join(wd, f"{loss_type}.json")) as f:
        result = json.load(f)
    assert _json_keys(result) == _jax_tool_keys(2)
    hist = result["history"]
    assert len(hist) == 2
    assert all(np.isfinite([h["d_loss"], h["g_loss"], h["fid"]]).all() for h in hist)
    assert result["meta"]["fid_floor_real_vs_real"] >= 0.0
    assert result["meta"]["loss_type"] == loss_type and result["meta"]["backend"] == "cpu"
    for name in ("grids/real.png", f"grids/{loss_type}_epoch001.png", f"{loss_type}_last.model"):
        assert os.path.exists(os.path.join(wd, name)), name
