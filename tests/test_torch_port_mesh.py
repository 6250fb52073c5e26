"""The port's rank mesh (``rnagan_tpu_torch/parallel``) against the JAX
package's device mesh, on the CPU.

Worlds are gloo process groups of 2 or 3 ranks spawned on the CPU
(``parallel/launch.py::spawn``, one torch thread a rank) running the
functions of ``tests/_torch_port_mesh_worker.py``; the one-rank references
run in the test process, without a process group. The JAX side runs on the
conftest's virtual CPU devices. One world per test runs all of its checks.

Tolerances: K1's group mode within 1e-6 of the reference's largest value
(float32, the sums taken in another order); BatchNorm's forward, backward
and double backward over a group within 1e-5 of the largest value (float32
statistics summed in two halves); bit-for-bit where nothing is reduced
(placement, gathers).
"""

import multiprocessing

import jax
import numpy as np
import pytest
import torch
from _torch_port_mesh_worker import bn_world, k1_group, multihost_child, warm_adam

from rnagan_tpu.core.config import MeshConfig as JaxMeshConfig
from rnagan_tpu.losses import rna_infusion as jinfusion
from rnagan_tpu.parallel import mesh as jmesh
from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, MeshConfig, VAEModelConfig
from rnagan_tpu_torch.kernels.infusion import infused_noise_plain, philox_uniform
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.parallel.launch import free_port, spawn
from rnagan_tpu_torch.parallel.mesh import (full_state_dict, local_rows, make_mesh, pad_to_multiple,
                                            shard_batch, shard_dense_params)
from rnagan_tpu_torch.train.gan_trainer import GANTrainer

F32 = np.float32


def _close(got, ref, scaled, msg=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0.0,
                               atol=scaled * float(np.abs(ref).max()), err_msg=msg)


# ------------------------------------------------------------------- mesh


def test_one_device_mesh_and_placement():
    """Outside a process group the mesh is the one-device mesh (every group
    None, ``shard_batch`` the identity); the JAX package's ``pad_to_multiple``
    and its (data, model) arithmetic and error."""
    mesh = make_mesh(MeshConfig(), "cpu")
    assert (mesh.world, mesh.data, mesh.model, mesh.data_group, mesh.model_group) == (1, 1, 1, None, None)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.writer and mesh.device == torch.device("cpu")
    batch = {"image": np.zeros((6, 2)), "labels": None}
    assert shard_batch(batch, mesh) is batch
    for n, m in [(7, 4), (8, 4), (1, 3), (5, 1)]:
        assert pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        make_mesh(MeshConfig(data=2), "cpu")
    # the JAX rule on its devices raises the same way
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        jmesh.make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(MeshConfig())  # entry points default to the card


class _FakeMesh:
    """A rank's coordinates without a process group (placement only)."""

    def __init__(self, data, model, data_index, model_index):
        self.data, self.model, self.data_index, self.model_index = data, model, data_index, model_index
        self.model_group = None


def test_shard_batch_and_dense_split_follow_the_jax_rule():
    """``shard_batch`` gives rank i rows [i n/D, (i+1) n/D), as the JAX mesh
    places them; ``local=True`` passes a batch through. ``shard_dense_params``
    splits exactly the Dense kernels (and their biases and BatchNorm vectors)
    that the JAX package's ``shard_dense_params`` splits over the model axis,
    and each rank's block is its slice of the columns."""
    x = np.arange(24, dtype=F32).reshape(8, 3)
    jm = jmesh.make_mesh(JaxMeshConfig(data=4, model=1), devices=jax.devices()[:4])
    placed = jmesh.shard_batch({"x": x}, jm)["x"]
    for i in range(4):
        mesh = _FakeMesh(4, 1, i, 0)
        got = shard_batch({"x": x, "n": None}, mesh)
        shard = next(s for s in placed.addressable_shards if s.device == jm.devices[i, 0])
        np.testing.assert_array_equal(got["x"], np.asarray(shard.data))
        mine = x[2 * i:2 * i + 2]  # a batch this process holds alone passes through
        assert shard_batch(mine, mesh, local=True) is mine and got["n"] is None
    assert local_rows(8, _FakeMesh(4, 1, 3, 0)) == slice(6, 8)
    with pytest.raises(ValueError, match="pad it"):
        local_rows(7, _FakeMesh(2, 1, 0, 0))

    from rnagan_tpu.core.config import VAEModelConfig as JaxVAEModelConfig
    from rnagan_tpu.models.betavae import init_betavae

    kw = dict(rna_features=20, z_dim=16, encoder_dims=(24, 15), decoder_dims=(24,))
    grid = jmesh.make_mesh(JaxMeshConfig(data=4, model=2), devices=jax.devices())
    jvars = init_betavae(JaxVAEModelConfig(**kw), jax.random.key(0))
    split_jax = {"/".join(str(p.key) for p in path[:-1])
                 for tree in ("params", "batch_stats")
                 for path, leaf in jax.tree_util.tree_leaves_with_path(jmesh.shard_dense_params(jvars[tree], grid))
                 if "model" in str(leaf.sharding.spec)}
    flax_name = {"encoder.encoder.1.0": "encoder/dense_0", "encoder.encoder.1.1": "encoder/bn_0",
                 "encoder.encoder.2.0": "encoder/dense_1", "encoder.encoder.2.1": "encoder/bn_1",
                 "z_mu": "z_mu", "z_logvar": "z_logvar", "decoder.0.0": "decoder/dense_0",
                 "decoder.0.1": "decoder/bn_0", "decoder.1.0": "decoder/dense_out"}
    full = BetaVAE(VAEModelConfig(**kw), seed=1)
    for j in range(2):
        vae = shard_dense_params(BetaVAE(VAEModelConfig(**kw), seed=1), _FakeMesh(4, 2, 0, j))
        split = {name for name, m in vae.named_modules() if getattr(m, "model_split", None)}
        assert {flax_name[n] for n in split} == split_jax  # widths 24, 16 (z), 24 and 20; 15 stays whole
        for name, t in vae.state_dict().items():
            ref = full.state_dict()[name]
            if name.rpartition(".")[0] in split and t.ndim:
                k = ref.shape[0] // 2
                assert torch.equal(t, ref[j * k:(j + 1) * k]), name
            else:
                assert torch.equal(t, ref), name


# --------------------------------------------------------- K1's group mode


def _jax_standardized(x, mesh2):
    """The JAX package's ``standardize_batch`` of ``x`` sharded over a
    2-device data mesh (pjit reduces the batch statistics across them)."""
    sharded = jmesh.shard_batch({"x": x}, mesh2)["x"]
    return np.asarray(jax.jit(jinfusion.standardize_batch)(sharded))


def test_k1_group_plain_matches_jax_mesh_and_one_rank():
    """K1's group mode (CPU tensors: its plain version) over 2 and 3 ranks
    with ragged row counts: from given uniforms against the JAX
    ``standardize_batch`` of ``u + z`` over a 2-device mesh, and seeded
    (Philox rows from each rank's global offset) against the one-rank plain
    version of the whole batch."""
    rng = np.random.RandomState(0)
    n, d, r = 10, 24, 0.3
    z = rng.randn(n, d).astype(F32)
    u = ((rng.rand(n, d) * 2 - 1) * r).astype(F32)
    mesh2 = jmesh.make_mesh(JaxMeshConfig(data=2, model=1), devices=jax.devices()[:2])
    ref_u = _jax_standardized(u + z, mesh2)
    ref_seed = infused_noise_plain(torch.from_numpy(z), n, seed=5, noise_range=r).numpy()
    # the Philox stream at a row offset continues the stream of the whole batch
    assert torch.equal(philox_uniform(5, 4, d, r, "cpu", row0=6), philox_uniform(5, n, d, r, "cpu")[6:])
    for counts in ((3, 7), (2, 5, 3)):
        outs = spawn(k1_group, len(counts), z, u, 5, counts, r, backend="gloo", threads=1, timeout=120)
        assert [len(o["u"]) for o in outs] == list(counts)
        _close(np.concatenate([o["u"] for o in outs]), ref_u, 1e-6, f"given u, ranks {counts}")
        _close(np.concatenate([o["seed"] for o in outs]), ref_seed, 1e-6, f"seeded, ranks {counts}")


def test_k1_without_a_group_is_the_one_device_path():
    """``group=None`` leaves K1 on its one-device path, bit for bit."""
    from rnagan_tpu_torch.kernels.infusion import infused_noise

    z = torch.from_numpy(np.random.RandomState(1).randn(5, 8).astype(F32))
    assert torch.equal(infused_noise(z, 5, seed=1, group=None), infused_noise_plain(z, 5, seed=1))
    with pytest.raises(ValueError, match="exactly one"):
        infused_noise(z, 5, noise_range=0.3, group=None)


# ------------------------------------------------------ BatchNorm over a group


def test_batch_norm_over_a_group_matches_one_rank(rng):
    """Train-mode BatchNorm with its statistics reduced over 2 ranks: output,
    new statistics, the input gradient and the parameter gradients of a
    weighted sum, and the parameter gradients of the double backward (the
    WGAN-GP's), against one rank on the whole batch."""
    x = (rng.randn(8, 5, 3, 3) * 2 + 1).astype(F32)
    w = rng.randn(*x.shape).astype(F32)
    scale, bias = (rng.rand(5) + 0.5).astype(F32), rng.randn(5).astype(F32)
    mean, var = rng.randn(5).astype(F32), (rng.rand(5) + 0.5).astype(F32)
    ref = bn_world(0, 1, x, w, scale, bias, mean, var)
    outs = spawn(bn_world, 2, x, w, scale, bias, mean, var, backend="gloo", threads=1, timeout=120)
    for key in ("y", "gx"):
        _close(np.concatenate([o[key].detach().numpy() for o in outs]), ref[key].detach().numpy(), 1e-5, key)
    for o in outs:
        for key in ("mean", "var", "gscale", "gbias", "g2scale"):
            _close(o[key].numpy(), ref[key].detach().numpy(), 1e-5, key)
    assert torch.equal(outs[0]["g2scale"], outs[1]["g2scale"])  # the summed gradients agree bit for bit


def test_group_none_batch_norm_is_the_one_device_arithmetic(rng):
    """Under the one-device mesh the statistics are the one-device
    arithmetic, bit for bit."""
    from rnagan_tpu_torch.models.batchnorm import batch_norm

    x = torch.from_numpy(rng.randn(6, 4, 2, 2).astype(F32))
    args = (torch.ones(4), torch.zeros(4), torch.zeros(4), torch.ones(4))
    plain = batch_norm(x, *args, train=True)
    with collectives.active(make_mesh(MeshConfig(), "cpu")):
        meshed = batch_norm(x, *args, train=True)
    for a, b in zip(plain, meshed):
        assert torch.equal(a, b)


# ------------------------------------------------------------ placement I/O


def test_full_state_dict_of_an_unsplit_model_is_its_state_dict():
    vae = BetaVAE(VAEModelConfig(rna_features=8, z_dim=4, encoder_dims=(6,), decoder_dims=(6,)), seed=2)
    mesh = make_mesh(MeshConfig(), "cpu")
    for k, v in full_state_dict(vae, mesh).items():
        assert torch.equal(v, vae.state_dict()[k])


# ---------------------------------------------- init_distributed, two hosts

MODEL16 = GANModelConfig(encoding_dims=8, out_size=16, step_channels=4, compute_dtype="float32")


def test_init_distributed_two_processes_step_from_local_halves():
    """The counterpart of ``tests/test_multihost.py``: two processes join one
    world through ``init_distributed`` with an explicit coordinator, each
    holds only its half of the global batch and passes it through
    ``shard_batch(local=True)``; one wgan step gives both processes the same
    global metrics, those of one process stepping on the whole batch."""
    cfg = GANConfig(model=MODEL16, loss_type="wgan", batch_size=8, seed=7)
    images = np.random.RandomState(0).rand(8, 16, 16, 3).astype(F32) * 2 - 1
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=multihost_child, args=(pid, port, cfg, {"image": images[4 * pid:4 * pid + 4]},
                                                       results), daemon=True) for pid in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict((pid, (met, world)) for pid, met, world in (results.get(timeout=180) for _ in procs))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for pid in range(2):
        assert got[pid][1] == 2, got[pid][0]
    assert got[0][0] == got[1][0]
    tr = GANTrainer(cfg, device="cpu")
    _, ref = tr.train_step(warm_adam(tr.init_state()), {"image": images})
    for k, v in ref.items():
        np.testing.assert_allclose(got[0][0][k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
