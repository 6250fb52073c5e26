"""The port's β-VAE trainer over a mesh: the data axis (2 gloo ranks) and the
(data 2 x model 2) grid of 4 ranks whose Dense layers are split column-wise,
each against one rank on the CPU.

The counterparts of ``tests/test_sharding_equivalence.py:66-112``, at their
bounds: the validation losses of every epoch within rtol 1e-3, atol 1e-4.
The grid's best ``.pt`` (its shards gathered on save) loads strictly into a
one-card ``BetaVAE`` and holds the one-rank run's numbers within 1e-4 of
each tensor's largest value plus 1e-5 (one epoch of Adam at lr 1e-3 from
gradients summed in another order). A Dense bias ahead of a train-mode
BatchNorm is the exception: the BatchNorm subtracts the batch mean, so its
true gradient is 0 and what it gets is rounding noise, which Adam turns into
steps of up to the rate; it is held to twice the sum of the epoch's rates.
"""

import os

import numpy as np
import pytest
import torch
from _torch_port_mesh_worker import vae_world

from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core.config import MeshConfig, VAEConfig, VAEModelConfig
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.parallel.launch import spawn
from rnagan_tpu_torch.train.schedules import gradual_warmup_cosine

VAE_SMALL = VAEModelConfig(rna_features=20, z_dim=16, encoder_dims=(24, 16), decoder_dims=(24,))


def _cfg(epochs, mesh):
    return VAEConfig(model=VAE_SMALL, lr=1e-3, batch_size=16, num_epochs=epochs, warmup_steps=4, mesh=mesh,
                     seed=11)


def _val_close(ref, got):
    assert len(ref["val"]) == len(got["val"])
    for e1, e2 in zip(ref["val"], got["val"]):
        np.testing.assert_allclose(e2["total_loss"], e1["total_loss"], rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def data():
    return np.random.RandomState(0).randn(64, 20).astype(np.float32)


def test_vae_data_axis_identical_across_world_sizes(data, tmp_path):
    """Two epochs over 2 ranks (the validation batch of 16 a wrap-padded
    tail: 16 rows, 8 a rank) against one rank; both ranks keep the same
    history."""
    ref = vae_world(0, 1, _cfg(2, MeshConfig(data=1, model=1)), data[:48], data[48:], None)
    outs = spawn(vae_world, 2, _cfg(2, MeshConfig()), data[:48], data[48:], None, backend="gloo", threads=1,
                 timeout=300)
    _val_close(ref["history"], outs[0]["history"])
    assert outs[0]["history"] == outs[1]["history"]


def test_vae_grid_tensor_parallel_matches_one_rank(data, tmp_path):
    """(data 2 x model 2): the first Linear holds 12 of its 24 output rows on
    each rank; one epoch matches one rank, and the best ``.pt``, written by
    rank 0 from the gathered shards, loads strictly into a one-card BetaVAE
    with the one-rank run's numbers."""
    ref = vae_world(0, 1, _cfg(1, MeshConfig(data=1, model=1)), data[:48], data[48:], str(tmp_path / "one"))
    outs = spawn(vae_world, 4, _cfg(1, MeshConfig(data=2, model=2)), data[:48], data[48:], str(tmp_path / "grid"),
                 backend="gloo", threads=1, timeout=300)
    assert ref["first_linear"] == (24, 20)
    assert all(o["first_linear"] == (12, 20) for o in outs)
    _val_close(ref["history"], outs[0]["history"])
    assert all(o["history"] == outs[0]["history"] for o in outs)
    assert sorted(os.listdir(tmp_path / "grid")) == sorted(os.listdir(tmp_path / "one"))
    cfg = _cfg(1, MeshConfig())
    noise_bound = 2 * sum(gradual_warmup_cosine(cfg.lr, cfg.warmup_steps, cfg.cosine_steps)(t) for t in range(3))
    pre_norm = {f"encoder.encoder.{i + 1}.0.bias" for i in range(len(VAE_SMALL.encoder_dims))} | {
        f"decoder.{i}.0.bias" for i in range(len(VAE_SMALL.decoder_dims))}
    loaded = BetaVAE(VAE_SMALL)
    loaded.load_state_dict(convert.load_betavae_state_dict(str(tmp_path / "grid" / "model_dict_best.pt")))
    one = convert.load_betavae_state_dict(str(tmp_path / "one" / "model_dict_best.pt"))
    for k, v in loaded.state_dict().items():
        ref_v = one[k].float()
        atol = noise_bound if k in pre_norm else 1e-5 + 1e-4 * float(ref_v.abs().max())
        np.testing.assert_allclose(v.float().numpy(), ref_v.numpy(), rtol=0, atol=atol, err_msg=k)
        assert torch.equal(outs[0]["state_dict"][k], v), k  # the file holds the gathered state
