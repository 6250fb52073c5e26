"""InceptionV3 and FID in the port against the JAX package (and keras).

The port's ``InceptionV3Features`` reproduces the keras golden fixture and
the JAX module on one set of seeded numpy weights, at the real widths on 2-3
images; its resize to 299 is ``jax.image.resize``'s; its statistics and
Frechet distance routes agree with the JAX package's ``scipy`` route.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnagan_tpu.eval import fid as jfid
from rnagan_tpu.eval import representation as jrep
from rnagan_tpu.models import inception as jinc
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.eval import fid as tfid
from rnagan_tpu_torch.eval import representation as trep
from rnagan_tpu_torch.models import inception as tinc

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from gen_inception_fixture import regen_inputs, regen_weights  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "inception_keras_golden.npz")
F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once, and a full
    thread pool in each makes the CPU convolutions crawl."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_model(variables, **kw):
    model = tinc.InceptionV3Features(**kw)
    model.load_state_dict(convert.inception_state_dict_from_jax(variables))
    return model


def _keras_arrays():
    golden = np.load(FIXTURE)
    return golden, regen_weights([tuple(s) for s in golden["shapes"]], int(golden["weight_seed"]))


def test_keras_conv_order_matches_jax():
    assert tinc.KERAS_CONV_ORDER == jinc.KERAS_CONV_ORDER


def test_port_reproduces_keras_golden_activations(tmp_path):
    """The fixture's weights through the port's keras loader (``.npz``) give
    keras' activations, to the JAX test's tolerance
    (``tests/test_inception_keras_parity.py``)."""
    golden, (kernels, betas, means, variances) = _keras_arrays()
    path = str(tmp_path / "keras.npz")
    np.savez(path, **{f"{field}_{i}": arr for field, arrs in
                      (("kernel", kernels), ("beta", betas), ("mean", means), ("var", variances))
                      for i, arr in enumerate(arrs)})
    sd, kwargs = tinc.load_fid_inception(path)
    assert kwargs == {"transform_input": False, "torch_pool": False}
    model = tinc.InceptionV3Features(**kwargs)
    model.load_state_dict(sd)
    x01 = regen_inputs(int(golden["input_seed"]), int(golden["n_inputs"]))
    with torch.inference_mode():
        feats = model(torch.from_numpy(x01)).numpy()
    ref = golden["features"]
    np.testing.assert_allclose(feats, ref, rtol=2e-4, atol=2e-3)
    assert np.corrcoef(feats.ravel(), ref.ravel())[0, 1] > 0.999999


def _seeded_variables(seed=0):
    """Random flax-layout variables for the JAX model: He-scaled kernels so
    activations keep their scale through 94 ReLU layers, BN statistics and
    affine parameters away from (0, 1)."""
    model = jinc.InceptionV3Features()
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 299, 299, 3), jnp.float32)),
                            jax.random.key(0))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(F32)
        if name in ("scale", "var"):
            return rng.uniform(0.7, 1.3, s.shape).astype(F32)
        return (0.1 * rng.randn(*s.shape)).astype(F32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def seeded():
    return _seeded_variables(), np.random.RandomState(3).rand(2, 299, 299, 3).astype(F32)


@pytest.mark.parametrize("torch_pool", [False, True])
@pytest.mark.parametrize("transform_input", [True, False])
def test_port_matches_jax_on_seeded_weights(seeded, torch_pool, transform_input):
    variables, x01 = seeded
    jmodel = jinc.InceptionV3Features(transform_input=transform_input, torch_pool=torch_pool)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, x01))
    model = _port_model(variables, transform_input=transform_input, torch_pool=torch_pool)
    with torch.inference_mode():
        got = model(torch.from_numpy(x01)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4 * np.abs(ref).max())
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.99999


def test_seeded_default_init_is_flax_distribution():
    """lecun-normal kernels (variance 1/fan_in, truncated at 2 std), BN at
    (1, 0, 0, 1); the same seed gives the same weights, another seed others."""
    a, b, c = (tinc.InceptionV3Features(seed=s).state_dict() for s in (0, 0, 1))
    w = a["Mixed_7c.branch3x3dbl_1.conv.weight"]
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.var()) * fan_in - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / fan_in ** 0.5 + 1e-6
    bn = "Mixed_5b.branch1x1.bn."
    for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
        assert torch.equal(a[bn + name], torch.full((64,), value))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv2d_1a_3x3.conv.weight"], c["Conv2d_1a_3x3.conv.weight"])


@pytest.mark.parametrize("size", [64, 256, 512])
def test_resize_matches_jax_image_resize(size):
    img = np.random.RandomState(size).rand(2, size, size, 3).astype(F32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (2, 299, 299, 3), method="bilinear"))
    got = tfid.resize_bilinear(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_extractor_matches_jax_extractor(seeded):
    """Resize from 64x64, a fixed batch of 2 with the last one padded, float32."""
    variables, _ = seeded
    images = np.random.RandomState(4).rand(3, 64, 64, 3).astype(F32)
    ref = jfid.InceptionExtractor(variables, dtype=jnp.float32)(images, batch_size=2)
    ext = tfid.InceptionExtractor(convert.inception_state_dict_from_jax(variables), dtype="float32",
                                  device="cpu")
    got = ext(images, batch_size=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4 * np.abs(ref).max())


def _fake_extractor(table):
    """An extractor that maps image indices to given activations."""
    return lambda images, batch_size: table[np.asarray(images)]


def test_statistics_match_jax():
    """Dyadic activations (multiples of 2^-8) over 64 rows: JAX's float32
    mean is then exact, so both means agree to float64 rounding; the
    covariances differ only in summation order."""
    rng = np.random.RandomState(5)
    act = (rng.randint(0, 1024, (64, 48)) / 256.0).astype(F32)
    idx = np.arange(64)
    mu_j, s_j = jfid.calculate_activation_statistics(idx, 64, _fake_extractor(act))
    mu_t, s_t = tfid.calculate_activation_statistics(idx, 64, _fake_extractor(act))
    assert mu_t.dtype == s_t.dtype == torch.float64
    for got, ref in ((mu_t.numpy(), mu_j), (s_t.numpy(), s_j)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * np.abs(ref).max())


def _stats(rng, n, d, shift=0.0):
    act = rng.randn(n, d) + shift
    return act.mean(0), np.cov(act, rowvar=False)


@pytest.mark.parametrize("method", ["eigh", "scipy"])
def test_frechet_distance_matches_jax_scipy_route(method):
    rng = np.random.RandomState(6)
    a, b = _stats(rng, 200, 32), _stats(rng, 150, 32, shift=0.3)
    ref = jfid.calculate_frechet_distance(*a, *b, method="scipy")
    got = tfid.calculate_frechet_distance(*(torch.from_numpy(x) for x in (*a, *b)), method=method)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert tfid.calculate_frechet_distance(*a, *a, method=method) == pytest.approx(0.0, abs=1e-8)


def _singular_pair():
    """Low-rank covariances whose product has no finite scipy sqrtm, so the
    scipy route takes its eps retry."""
    from scipy import linalg

    rng = np.random.RandomState(0)
    for trial in range(1000):
        d, r1, r2 = rng.randint(3, 8), rng.randint(1, 7), rng.randint(1, 7)
        a, b = rng.randn(d, min(r1, d - 1)), rng.randn(d, min(r2, d - 1))
        if trial % 3 == 0:
            b[:, 0] = 0
            b[0, :] = 0
        s1, s2 = a @ a.T, b @ b.T
        if not np.isfinite(linalg.sqrtm(s1 @ s2)).all():
            return s1, s2
    raise AssertionError("no singular product found")


def test_singular_products_take_the_eps_path():
    s1, s2 = _singular_pair()
    mu1, mu2 = np.zeros(len(s1)), np.full(len(s1), 0.5)
    ref = jfid.calculate_frechet_distance(mu1, s1, mu2, s2, method="scipy")
    got = tfid.calculate_frechet_distance(mu1, s1, mu2, s2, method="scipy")
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_eigh_route_retries_with_eps(monkeypatch):
    """A non-finite trace is computed again on S + eps I, as the JAX route does."""
    rng = np.random.RandomState(7)
    (m1, s1), (m2, s2) = _stats(rng, 64, 8), _stats(rng, 64, 8)
    calls = []
    real = tfid._trace_sqrtm_product

    def first_fails(a, b):
        calls.append(1)
        return float("nan") if len(calls) == 1 else real(a, b)

    monkeypatch.setattr(tfid, "_trace_sqrtm_product", first_fails)
    got = tfid.calculate_frechet_distance(m1, s1, m2, s2, eps=1e-3)
    monkeypatch.setattr(tfid, "_trace_sqrtm_product", real)
    off = np.eye(8) * 1e-3
    want = float((m1 - m2) @ (m1 - m2) + np.trace(s1) + np.trace(s2)) - 2 * real(
        torch.from_numpy(s1 + off), torch.from_numpy(s2 + off))
    assert len(calls) == 2 and got == pytest.approx(want, rel=1e-12)


def test_fid_repetitions_match_jax():
    rng = np.random.RandomState(8)
    table = rng.randn(64 * 4, 16).astype(F32)  # real: rows 0-63, rep r: rows 64(r+1)...
    ext = _fake_extractor(table)
    real = np.arange(64)

    def gen(rep):
        return np.arange(64 * (rep + 1), 64 * (rep + 2))

    mean, std, fids = tfid.fid_repetitions(real, gen, n_reps=3, extractor=ext)
    mu_r, s_r = jfid.calculate_activation_statistics(real, 64, ext)
    ref = [jfid.calculate_frechet_distance(mu_r, s_r, *jfid.calculate_activation_statistics(gen(r), 64, ext),
                                           method="scipy") for r in range(3)]
    np.testing.assert_allclose(fids, ref, rtol=1e-6)
    assert mean == pytest.approx(np.mean(ref), rel=1e-6) and std == pytest.approx(np.std(ref), rel=1e-5)


@pytest.mark.parametrize("with_labels", [False, True])
def test_distance_statistics_match_jax(with_labels):
    rng = np.random.RandomState(9)
    real = rng.randn(6, 10)
    fake = real + 0.5 * rng.randn(6, 10)
    labels = np.array([0, 0, 1, 1, 2, 2]) if with_labels else None
    assert trep.distance_statistics(real, fake, labels) == jrep.distance_statistics(real, fake, labels)
