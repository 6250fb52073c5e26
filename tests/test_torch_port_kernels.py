"""The port's kernels, through their plain PyTorch versions on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there). Here the plain versions are held
against the Pallas kernels they replace (interpret mode) or the formulas
those kernels compute, and the C entry points against their bindings.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnagan_tpu.losses.rna_infusion import infused_noise_population, standardize_batch
from rnagan_tpu.ops.quantize import pallas_tanh_to_uint8
from rnagan_tpu_torch.kernels import _build
from rnagan_tpu_torch.kernels import fused_adam as tadam
from rnagan_tpu_torch.kernels import infusion as tinfusion
from rnagan_tpu_torch.kernels import quant_matmul as tquant
from rnagan_tpu_torch.kernels.infusion import infused_noise, philox4x32, philox_uniform, rows_per_thread
from rnagan_tpu_torch.kernels.quant_matmul import int8_matmul
from rnagan_tpu_torch.kernels.quantize import tanh_to_uint8

_FF = 0xFFFFFFFF


# Random123's known-answer vectors for Philox4x32-10
@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_FF, _FF, _FF, _FF), (_FF, _FF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    words = philox4x32(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in words) == expected


@pytest.mark.parametrize("z_rows", [32, 1])
def test_infusion_given_u_matches_jax(rng, z_rows):
    """u mode == the Pallas kernel's formula, standardize_batch(u + z), with
    z (n, D) or one (1, D) row broadcast over the batch."""
    n, d = 32, 512
    z = (rng.randn(z_rows, d) * 3).astype(np.float32)
    u = rng.uniform(-0.3, 0.3, (n, d)).astype(np.float32)
    ref = np.asarray(standardize_batch(jnp.asarray(u) + jnp.asarray(z)))
    got = infused_noise(torch.from_numpy(z), n, u=torch.from_numpy(u), noise_range=0.3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_infusion_population_matches_jax(rng):
    n, d = 16, 256
    z = (rng.randn(1, d) * 2).astype(np.float32)
    pop_mean = rng.randn(d).astype(np.float32)
    pop_std = (0.5 + rng.rand(d)).astype(np.float32)
    key = jax.random.key(5)
    ref = infused_noise_population(key, jnp.asarray(z), jnp.asarray(pop_mean),
                                   jnp.asarray(pop_std), n, 0.3)
    u = np.array(jax.random.uniform(key, (n, d), jnp.float32, -0.3, 0.3))
    got = infused_noise(torch.from_numpy(z), n, u=torch.from_numpy(u), noise_range=0.3,
                        pop_mean=torch.from_numpy(pop_mean), pop_std=torch.from_numpy(pop_std))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_infusion_seeded_statistics(rng):
    """The tolerances of the Pallas kernel's own test (tests/test_ops.py)."""
    z = torch.from_numpy((rng.randn(32, 512) * 3).astype(np.float32))
    out = infused_noise(z, 32, seed=7, noise_range=0.3).numpy()
    assert out.shape == (32, 512) and out.dtype == np.float32
    np.testing.assert_allclose(out.mean(axis=0), 0.0, atol=1e-5)
    np.testing.assert_allclose(out.std(axis=0, ddof=1), 1.0, atol=1e-4)
    assert np.corrcoef(z.numpy()[:, 0], out[:, 0])[0, 1] > 0.9


def test_infusion_seeds(rng):
    z = torch.from_numpy(rng.randn(16, 256).astype(np.float32))
    a = infused_noise(z, 16, seed=7)
    assert torch.equal(a, infused_noise(z, 16, seed=7))
    assert (a - infused_noise(z, 16, seed=8)).abs().max() > 1e-2


def test_philox_uniforms_cover_the_range():
    u = philox_uniform(3, 64, 1024, 0.3, "cpu")
    assert u.dtype == torch.float32 and u.shape == (64, 1024)
    assert -0.3 <= float(u.min()) < -0.29 and 0.29 < float(u.max()) < 0.3
    assert abs(float(u.mean())) < 0.01
    assert abs(float(u.var()) - 0.6**2 / 12) < 1e-3


@pytest.mark.parametrize("n,rows", [(2, 1), (8, 1), (32, 1), (33, 2), (64, 2), (128, 4), (256, 8),
                                    (257, 0), (300, 0)])
def test_infusion_rows_per_thread(n, rows):
    """The one-pass kernel takes the fewest rows a thread that cover the batch
    (32 threads a column); above 256 rows the loop kernel (0) runs."""
    assert rows_per_thread(n) == rows
    if rows:
        assert n <= tinfusion.ROW_GROUPS * rows and rows in tinfusion.REGISTER_ROWS


@pytest.mark.parametrize("n", [2, 8, 32, 64, 128, 256, 300])
def test_infusion_plain_matches_jax_at_each_kernel_size(rng, n):
    """The plain version (given u) against JAX's ``standardize_batch`` at a
    batch for each kernel instance the wrapper picks, the loop kernel's 300
    rows included, with a ragged D: within 1e-5."""
    d = 200
    z = (rng.randn(n, d) * 3).astype(np.float32)
    u = rng.uniform(-0.3, 0.3, (n, d)).astype(np.float32)
    ref = np.asarray(standardize_batch(jnp.asarray(u) + jnp.asarray(z)))
    got = infused_noise(torch.from_numpy(z), n, u=torch.from_numpy(u), noise_range=0.3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_infusion_population_matches_jax_at_300_rows(rng):
    n, d = 300, 200
    z = (rng.randn(1, d) * 2).astype(np.float32)
    pop_mean = rng.randn(d).astype(np.float32)
    pop_std = (0.5 + rng.rand(d)).astype(np.float32)
    key = jax.random.key(9)
    ref = infused_noise_population(key, jnp.asarray(z), jnp.asarray(pop_mean),
                                   jnp.asarray(pop_std), n, 0.3)
    u = np.array(jax.random.uniform(key, (n, d), jnp.float32, -0.3, 0.3))
    got = infused_noise(torch.from_numpy(z), n, u=torch.from_numpy(u), noise_range=0.3,
                        pop_mean=torch.from_numpy(pop_mean), pop_std=torch.from_numpy(pop_std))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _cu_constant(source, name):
    return int(re.search(r"constexpr int " + name + r" = (\d+);", (_build.CSRC / source).read_text()).group(1))


def test_wrapper_constants_match_the_kernels():
    """The Python side sizes scratch buffers and picks kernel instances from
    constants that must equal the CUDA sources' own."""
    assert tinfusion.ROW_GROUPS == _cu_constant("infusion.cu", "kStripGroups")
    onepass = re.findall(r"ONEPASS\((\d+)\)", (_build.CSRC / "infusion.cu").read_text())
    assert tuple(int(r) for r in onepass) == tinfusion.REGISTER_ROWS
    assert tquant.WGMMA_K_PITCH == _cu_constant("quant_matmul.cu", "kKPitch")
    assert tquant.BYTEWISE_TILE_N == _cu_constant("quant_matmul.cu", "kByteBM")
    assert tquant.BYTEWISE_TILE_K == _cu_constant("quant_matmul.cu", "kByteBK")
    cases = re.findall(r"case (\d+): err = launch_wgmma<(\d+)>", (_build.CSRC / "quant_matmul.cu").read_text())
    assert all(a == b for a, b in cases)
    assert tuple(int(a) for a, _ in cases) == tquant.WGMMA_TILES_N
    assert tadam.MAX_TENSORS == _cu_constant("fused_adam.cu", "kMaxTensors")


@pytest.mark.parametrize("kwargs", [{}, {"seed": 1, "u": torch.zeros(4, 8)},
                                    {"seed": 1, "pop_mean": torch.zeros(8)}])
def test_infusion_rejects_bad_arguments(kwargs):
    with pytest.raises(ValueError):
        infused_noise(torch.zeros(4, 8), 4, **kwargs)


def test_quantize_matches_pallas_kernel(rng):
    """Plain version (NCHW in) against the Pallas kernel (NHWC in), interpret
    mode: XLA's and torch's CPU tanh may differ by an ulp at a rounding
    boundary, so at most 1 level apart on under 0.1 % of pixels."""
    x = (rng.randn(4, 32, 32, 3) * 2).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_tanh_to_uint8(jnp.asarray(x)))
    got = tanh_to_uint8(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.001


def test_quantize_range_endpoints():
    x = torch.tensor([-100.0, 0.0, 100.0]).reshape(1, 3, 1, 1)
    assert tanh_to_uint8(x).flatten().tolist() == [0, 128, 255]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_tanh_to_uint8(jnp.asarray(x.numpy().reshape(1, 1, 1, 3))))
    assert ref.ravel().tolist() == [0, 128, 255]


def test_quantize_writes_nhwc():
    """Channel c of the NCHW input lands in the last axis of the output."""
    x = torch.full((2, 3, 4, 8), -100.0)
    x[:, 1] = 0.0
    x[:, 2] = 100.0
    x[1, 0, 2, 5] = 100.0
    out = tanh_to_uint8(x)
    assert out.shape == (2, 4, 8, 3)
    expected = torch.tensor([0, 128, 255], dtype=torch.uint8).expand(2, 4, 8, 3).clone()
    expected[1, 2, 5, 0] = 255
    assert torch.equal(out, expected)


@pytest.mark.parametrize("fn,arg", [
    (lambda t: infused_noise(t, 4, seed=0), torch.empty(4, 8, device="meta")),
    (tanh_to_uint8, torch.empty(1, 3, 4, 4, device="meta")),
    (lambda t: int8_matmul(t, torch.empty(8, 16, dtype=torch.int8, device="meta"),
                           torch.empty(16, device="meta"), torch.empty(16, device="meta")),
     torch.empty(4, 8, device="meta")),
])
def test_wrappers_take_cpu_or_cuda_only(fn, arg):
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(arg)


def test_c_entry_points_match_their_bindings():
    """Every bound entry point is defined in csrc/ with as many parameters as
    its argtypes, and returns int (its cudaError_t). nvcc is not here, so this
    is the check the CPU can make of the binding."""
    text = "".join(src.read_text() for src in _build.sources())
    for name, argtypes in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
    assert {p.name for p in _build.sources()} == {"infusion.cu", "quantize.cu", "fused_adam.cu",
                                                  "quant_matmul.cu", "marks.cu", "batchnorm.cu"}
