"""The port's ResNet-family trainers over the data axis: one step of the tile
classifier, SimCLR and fusion over 2 gloo ranks on the CPU against one rank,
with given draws of the global batch, from a state warmed by 5 one-rank
steps whose AdamW moments are then set as ``tests/test_torch_port_train.py``
sets them (``nu`` far above ``(1-b2)*g^2``): Adam's early steps are near
sign(g)*lr and amplify ulps, this update is a smooth function of the gradient.

Tolerances are those of ``tests/test_torch_port_resnet.py`` and
``tests/test_torch_port_ssl_fusion.py``: a step's loss 1e-5 relative and
its accuracy 1e-6 (two ranks' shares of a count); parameters and BatchNorm
statistics 1e-5 relative plus 1e-6 of each tensor's largest value, AdamW
moments 1e-5 plus 1e-5 of it; a Dense bias ahead of a train-mode BatchNorm
(fusion's RNA encoder) at its kernel's scale. SimCLR's NT-Xent over 2 ranks
sees the global negatives: its loss and gradients are the one-rank ones on
the concatenated batch.
"""

import functools

import numpy as np
import torch
from _torch_port_mesh_worker import fusion_step, ml_step, nt_xent_world, ssl_step

from rnagan_tpu_torch.core.config import MLConfig
from rnagan_tpu_torch.models import resnet as tresnet
from rnagan_tpu_torch.parallel.launch import spawn
from rnagan_tpu_torch.train import fusion_trainer as tfusion
from rnagan_tpu_torch.train import ml_experiment as tml
from rnagan_tpu_torch.train import ssl_trainer as tssl

SIZE, N, GENES = 16, 8, 12
TBB = functools.partial(tresnet.ResNet, tresnet.BasicBlock, (1, 1, 1, 1), compute_dtype="float32")
ML_CFG = MLConfig(num_classes=2, num_epochs=1, batch_size=N, folds=2, image_size=SIZE)
SSL_CFG = tssl.SSLConfig(batch_size=N, image_size=SIZE, projection_hidden=32, projection_dim=16)
FUSION_CFG = tfusion.FusionConfig(batch_size=4, rna_hidden_dims=(16, 8))


def _close(got, ref, rtol=1e-5, scaled=1e-6, msg=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=scaled * float(np.abs(ref).max()) if ref.size else 0.0, err_msg=msg)


def _assert_steps_agree(ref, outs, names, kernels=None):
    """World 2's step (both ranks alike) against world 1's; ``names`` are the
    optimizer's tensors in order, ``kernels`` maps a pre-norm bias to its kernel."""
    kernels = kernels or {}
    got, sd, ref_sd = outs[0], outs[0]["state_dict"], ref["state_dict"]
    _close(got["metrics"]["loss"], ref["metrics"]["loss"], scaled=0.0)
    for k in ref["metrics"]:
        _close(got["metrics"][k], ref["metrics"][k], rtol=1e-6, scaled=0.0, msg=k)

    def scale(name, tensors):
        return float(tensors[kernels.get(name, name)].abs().max())

    for k, v in ref_sd.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6 * scale(k, ref_sd), err_msg=k)
        assert torch.equal(sd[k], outs[1]["state_dict"][k]), f"replicas differ at {k}"
    assert got["count"] == ref["count"]
    for moments in ("mu", "nu"):
        want = dict(zip(names, ref[moments]))
        for name, g in zip(names, got[moments]):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5,
                                       atol=1e-5 * scale(name, want), err_msg=f"{moments} {name}")


def _smooth_moments(state, seed=0):
    rng = np.random.RandomState(seed)
    for mu, nu in zip(state.opt.mu, state.opt.nu):
        mu.copy_(torch.from_numpy(rng.randn(*mu.shape).astype(np.float32) * 1e-3))
        nu.copy_(torch.from_numpy((rng.rand(*nu.shape).astype(np.float32) + 0.5) * 1e-2))
    return state


def _mask(n):
    return np.r_[np.ones(n - 1), 0.0].astype(np.float32)  # a padded row, on the last rank


def test_classifier_step_world_2_matches_world_1():
    rng = np.random.RandomState(5)
    images = rng.rand(24, SIZE, SIZE, 3).astype(np.float32)
    labels = (np.arange(24) % 2).astype(np.int64)
    model = functools.partial(TBB, num_classes=2)
    tr = tml.TileClassifierTrainer(ML_CFG, model=model, device="cpu")
    state = tr.init_state()
    for k in range(5):
        idx = (np.arange(N) + 3 * k) % 24
        # the flips this test's state was first reached with (a torch.Generator a step): from the
        # state the trainer's own Philox flips reach, the compared step lies within float32 rounding
        # of a kink (a ReLU or max-pool tie), and world 2 falls far outside the bounds of world 1
        gen = tr.seeds.generator("ml", state.step)
        warm = {"flip_h": torch.rand(N, generator=gen) < 0.5, "flip_v": torch.rand(N, generator=gen) < 0.5}
        state, _ = tr.train_step(state, images[idx], labels[idx], np.ones(N, np.float32), draws=warm)
    _smooth_moments(state)
    idx = np.arange(N) + 9
    draws = {"flip_h": rng.rand(N) < 0.5, "flip_v": rng.rand(N) < 0.5}
    args = (ML_CFG, model, state, images[idx], labels[idx], _mask(N), draws)
    ref = ml_step(0, 1, *args)
    _assert_steps_agree(ref, spawn(ml_step, 2, *args, backend="gloo", threads=1, timeout=300),
                        [n for n, _ in state.model.named_parameters()])


def test_nt_xent_over_two_ranks_sees_the_global_negatives():
    """The loss, accuracy and gradients of NT-Xent over 2 ranks (each holding
    its rows of both views) equal the one-rank NT-Xent of the whole batch."""
    rng = np.random.RandomState(2)
    z = rng.randn(2 * N, 16).astype(np.float32)
    z[N:] = z[:N] + rng.randn(N, 16).astype(np.float32) * 0.3
    zt = torch.from_numpy(z).requires_grad_(True)
    loss, acc = tssl.nt_xent_loss(zt, 0.5)
    (grad,) = torch.autograd.grad(loss, zt)
    loss = loss.detach()
    outs = spawn(nt_xent_world, 2, z, 0.5, backend="gloo", threads=1, timeout=120)
    _close(float(outs[0]["metrics"]["loss"]), float(loss), rtol=1e-6, scaled=0.0)
    _close(float(outs[0]["metrics"]["acc"]), float(acc), rtol=1e-6, scaled=0.0)
    half = N // 2
    for r, o in enumerate(outs):  # rank r's rows: A[r*4:(r+1)*4], then B's
        rows = np.r_[r * half:(r + 1) * half, N + r * half:N + (r + 1) * half]
        _close(o["grad"].numpy(), grad[rows].numpy(), rtol=1e-5, scaled=1e-6)


def test_simclr_step_world_2_matches_world_1():
    images = np.random.RandomState(11).rand(N, SIZE, SIZE, 3).astype(np.float32)
    tr = tssl.SimCLRTrainer(SSL_CFG, backbone=TBB, device="cpu")
    state = tr.init_state()
    for k in range(5):
        state, _ = tr.train_step(state, np.roll(images, k, axis=0))
    _smooth_moments(state)
    draws = {v: {k: t.numpy() for k, t in tssl.draw_view(N, SSL_CFG.crop_scale_min, 3 + i, "cpu").items()}
             for i, v in enumerate("ab")}
    args = (SSL_CFG, TBB, state, images, draws)
    ref = ssl_step(0, 1, *args)
    _assert_steps_agree(ref, spawn(ssl_step, 2, *args, backend="gloo", threads=1, timeout=300),
                        [n for n, _ in state.model.named_parameters()])


def test_fusion_step_world_2_matches_world_1():
    rng = np.random.RandomState(13)
    bags = rng.randint(0, 255, (N, 2, SIZE, SIZE, 3), dtype=np.uint8)
    labels = (np.arange(N) % 2).astype(np.int64)
    rna = rng.randn(N, GENES).astype(np.float32)
    tr = tfusion.FusionTrainer(FUSION_CFG, backbone=TBB, device="cpu")
    state = tr.init_state(bags.shape[1:], GENES)
    for k in range(5):
        idx = (np.arange(4) + 2 * k) % N
        state, _ = tr.train_step(state, bags[idx], rna[idx], labels[idx], np.ones(4, np.float32))
    _smooth_moments(state)
    idx = np.array([1, 4, 6, 7])
    keep = rng.rand(4, GENES) < 0.5
    args = (FUSION_CFG, TBB, state, bags[idx], rna[idx], labels[idx], _mask(4), keep)
    ref = fusion_step(0, 1, *args)
    outs = spawn(fusion_step, 2, *args, backend="gloo", threads=1, timeout=300)
    _assert_steps_agree(ref, outs, tfusion.trainable_names(state.model, True), state.model.pre_norm_biases())
