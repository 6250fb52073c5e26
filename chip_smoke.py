#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result line is printed):

1. the card, its power limit, and the kernels built from ``rnagan_tpu_torch/csrc``;
2. K1 (infused noise) against its plain PyTorch version in its four modes at
   ``K1_SHAPES`` (each instance of its one-pass kernel and the loop kernel);
3. K2 (tanh -> uint8, NCHW -> NHWC) against its plain version at (128, 3, 256, 256);
   K3 (Adam) against its plain version on the training generator's
   parameters, float32 and bfloat16 mu: bit-equal; K4 (int8 matmul) against
   its plain version (TF32 off) at ``K4_SHAPES`` (the head's (N, 2048) x
   (2048, 32768) at N = 128, 64 and 1, ragged shapes) and a misaligned
   weight, on both of its kernels (TMA + wgmma, byte-wise): within 1e-5 of
   max |out|;
4. the serving path at full width (``VAEModelConfig()`` and ``GANModelConfig()``
   widths, float32, TF32 off): a ``Synthesizer`` on the card serves a batch of
   128 patients (reference mode), one patient x 64 (population mode) and a
   repeat of the first request, with the launch counters read around them;
   the kernel path is held against the plain-op path, and a small
   configuration against the same Synthesizer on the CPU. Then the same
   three requests through ``Synthesizer(quantized_head=True)`` (K1, K4 on its
   wgmma kernel, as its route counter must show, K2),
   held against K1, K4 and K2's plain versions, with the int8 head's
   deviation from the float head on the same noise; and small
   configurations of ``quantized_full``, ``dcgan_up`` (exact border on and
   off, and with the int8 head) and ``condgan`` on the card against the CPU;
5. training checks (float32, TF32 off, cuDNN deterministic): one full-width
   ``GANTrainer`` step through K3 against the same step through the plain
   Adam; a small configuration's step of each arch (``dcgan``, ``dcgan_up``,
   ``condgan`` with labels) on the card against the CPU, K1 and K3 launched
   twice each on the card; a small ``VAEConfig``'s 3 steps with given draws
   on the card against the CPU;
6. the training path: ``GANConfig()`` (wganvae, bfloat16, batch 8) at full
   width takes 3 warm-up and 10 timed steps, with the K1 and K3 launch
   counters read around the timed ones (2 launches a step each); the step
   again at batch 64, the step's stages timed one by one, and three steps
   under ``torch.profiler`` (device time by kernel category, idle share);
7. the VAE training path: ``VAEConfig()`` at full width (float32, batch 128,
   Adam through K3 at the warmup+cosine rates) fits one epoch of random rows
   with the K3 counter read around it (one launch a train step, none in
   validation); its best ``.pt`` reloads strictly and feeds a ``GANTrainer``
   step through ``GANConfig(vae_checkpoint=...)``; then the step timed (CUDA
   events), its forward and backward, peak memory, K3 bit-equal to its plain
   version on one step's gradients, and K3's times at the VAE's 26 tensors
   beside its bound and ``torch.optim.Adam(fused=True)``;
8. the data plane, FID and the JAX package's checkpoints: the tile-store
   library built (``native/tilestore.cc``); a corpus of 4 slides x 64 tiles
   (256x256) written by the port's ``LMDBTileWriter``, with a 19,198-gene
   expression CSV and a reference-layout JSON config; the full-width VAE as
   a JAX-format ``model_best.ckpt`` (``load_frozen_vae`` bit-equal to the
   ``.pt`` route, z_mean on the card too); ``cli.gan_train.main`` for one
   epoch (32 steps of ``GANConfig()``, FID probe on 128 images), the K1 and
   K3 counters read around it (2 launches a step each); both bundles
   reloaded; InceptionV3 at full width, float32 on the card against the CPU
   and bfloat16 against float32, images/s at batch 64; the FID distance's
   float64 eigh on the card against scipy on 256 images' statistics; and
   ``compute_representations`` for 2 patients (one K1 launch each);
9. SAGAN and BigGAN, and the remaining CLIs: small configurations (float32,
   TF32 off, cuDNN deterministic, given draws, attention gates and
   conditional BatchNorm projections drawn) of ``sagan``, conditional
   ``biggan`` and unconditional ``biggan`` take one wganvae step each on the
   card against the CPU, and BigGAN's step with ``remat`` (recomputed
   blocks) is bit-equal to its plain step on the card; the full-width SAGAN
   discriminator's stored spectral-norm sigma within 5 % of its kernel's top
   singular value after 30 updating forwards; SAGAN and BigGAN (remat off
   and on) at the CLI's widths, batch 8 (step ms, peak memory, a profile);
   ``cli.main
   gan-train`` with ``--gan_type sagan`` and ``biggan`` (the corpus split
   over two CSVs, so BigGAN has 2 classes) for one epoch each, the K1 and K3
   counters read around each run (2 launches a step each), step time and
   peak memory; then through ``cli.main``: ``generate`` and ``fid`` on the
   BigGAN bundle, ``representation`` for 2 patients on the SAGAN bundle,
   ``sample`` from the ``.pt`` and from the JAX-format VAE (equal for one
   seed), ``interpolate`` on the two-CSV table and ``metrics`` on a JSONL of
   the two runs. ``tile`` stays a CPU test (``tests/test_torch_port_cli.py``):
   the card's machine has neither PIL nor OpenSlide;
10. the ResNet family (AdamW through K3, its decoupled-decay path): K3 as
   AdamW against its plain version at the shapes, rate and decay of every
   full-width step below (the classifier's ResNet50 with 161 tensors and
   ResNet152 with 467, SimCLR's 163, fusion's 103 trainable at decay 0), one
   launch each, bit-equal; small configurations of the
   classifier, SimCLR and fusion steps on the card against the CPU (float32,
   TF32 off, cuDNN deterministic, given draws; the fusion step's frozen
   parameters bit-unchanged); ``run_cv_experiment`` with ``MLConfig()``
   (ResNet50, 224x224, batch 64, bfloat16) over 2 folds of 1 epoch on 512
   drawn tiles and ``fit_resident`` for an epoch, one K3 launch a step;
   SimCLR at ``SSLConfig()`` (batch 256, 512 views), 5 steps, its
   backbone handed to a classifier that steps; ``FusionConfig()`` (ResNet50
   with conv1..layer2 frozen + the 19,198-gene RNA encoder, 4 bags x 40 tiles
   of 256x256) for 2 epochs of 8 bags, one K3 launch a step over the
   trainable tensors, frozen parameters bit-unchanged, their BatchNorm
   statistics moved; for each trainer the step's device time (CUDA events),
   images/s, TFLOP/s (``FlopCounterMode``), peak memory and a profile; K3's
   times at ResNet50's shapes beside its bound and ``torch.optim.AdamW(fused=True)``;
11. timings with CUDA events: each kernel (through its wrapper, and replayed
   from a CUDA graph for its device time), its plain version and a PyTorch
   yardstick; K4 also at N = 64 and 1, K1 with ``u`` given and beside a
   graph-replayed launch of a one-element fill (the floor of any launch); the
   serving stages and tiles/s at batch 128 in float32 and bfloat16; the
   generator again with cuDNN autotuning; the float head's
   ConvTranspose alone; tiles/s of ``quantized_head``, ``quantized_full`` and
   ``dcgan_up`` serving in float32 and bfloat16, and in float32 the last two
   checked at that width: every W8A8 layer exact against float64, W8A8
   against the float path, and a few rows of each against the CPU;
12. the mesh (run before 11): ranks spawned with the backend named, two on
   the one card over gloo (NCCL refuses two ranks on one device) or one a
   card over NCCL on several, each running ``mesh_rank``: K1's group mode
   (global batches of 128 and 8 rows x 2048, split over the ranks) against
   its plain version and, concatenated, against the one-pass kernel on the
   whole batch (1e-6 of max |out|), with its times; a small ``dcgan``
   wganvae GAN's 3 steps against one rank in this process at the CPU mesh
   tests' tolerances; ``GANConfig()`` at full width (bfloat16, global batch
   8) for 1 + 3 steps, the K1 group-mode and K3 counters read around the 3
   (6 and 2 launches a step), the step time and the bytes all-reduced a
   step, finite losses, every rank's parameters bit-equal to rank 0's;
   ``VAEConfig()`` at full width with its Linears split over 2 ranks, one
   step against a one-rank step of the same state (``VAE_TOL``), the
   gathered state too; one ``MLConfig()`` classifier step (ResNet50,
   float32) whose loss is the one-rank step's within 1e-5;
13. the synthetic corpus, the quality run and ``export_torch`` (run after
   12): ``SyntheticCorpus`` (16 slides x 64 tiles, 19,198 genes, 256x256) on
   the card and on the CPU, the same Philox words and batch ids, a batch of
   32 tiles within 1e-5, the render's time at batch 32 and 64, its host
   enqueue time, launches and peak memory; ``tools/quality_run_torch.py``'s
   functions at full width, cut (2 VAE epochs of the full-width bfloat16
   beta-VAE, one epoch of 16 steps of ``dcgan`` at 256x256 and batch 32 for
   wganvae and for wgan, FID on 128 + 128 tiles): K1 and K3 twice a step
   under wganvae, K3 twice and K1 never under wgan, finite losses and FID;
   the wganvae state through ``state_to_jax`` and the msgpack bundle back,
   bit-equal, and through ``export_torch`` both ways with G's output
   unchanged; the quality run's knobs (``compat_reference_gp``,
   ``n_critic=2`` over two steps, the EMA, the projection critic,
   ``dcgan_up`` and ``condgan`` at 64x64) as small steps on the card
   against the CPU (``train_small_matches_cpu``);
14. the experiment tools (run after 13): ``tools/representation_run_torch.py``,
   ``conditioning_panel_torch.py``, ``ml_experiment_run_torch.py``,
   ``make_lmdb_corpus_torch.py`` and ``data_plane_run_torch.py`` through their
   ``main``, in-process, at full width (the beta-VAE's widths in bfloat16,
   ``dcgan`` at 256x256, float32 InceptionV3, ResNet50 at 224x224 in
   bfloat16) with only counts cut: a workdir of the VAE and three GAN
   bundles (init states, G redrawn at O(1) activations); the representation
   run (4 patients x 16 tiles, projection critic), ``--ceiling_only`` and the
   panel (4 patients x 5 columns, both arms), K1 counted exactly (one launch
   a generation call), statistics finite, the z delta above 0, the ``.npy``
   shapes and the panel's size; the ML CV (16 slides, 8 + 4 tiles a slide, 2
   folds x 1 epoch, batch 64), its three arms, K1 once a chunk of 64 and K3
   once a classifier step; the LMDB corpus (4 slides x 64 tiles, a store
   read back bit-equal to the render) and the data-plane run (batch 32, 8
   resident steps, the overlap A/B of 4 steps, one streamed epoch), K1 and
   K3 twice a GAN step and K3 once a VAE step; the render, generation and
   float32 Inception rates of those runs timed alone. ``demo_e2e_torch`` stays a
   CPU test (``tests/test_torch_port_demo.py``): the card's machine has no PIL.

It prints a details line, the ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device": ...}``.
Weights and data are random, from fixed seeds. Needs no JAX and no network.
"""

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

BATCH = 128
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor-core and
# bf16 dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps=20, iters=10):
    """Device milliseconds of one ``fn()`` with the host's work left out:
    ``reps`` calls captured in a CUDA graph, replayed ``iters`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, iters=iters) / reps


def bound_ms(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def generator_flops(cfg, batch):
    """Multiply-adds x 2 of the ConvTranspose stack: the 4x4 head on a 1x1
    map, then each stride-2 4x4 layer, where an output pixel sums 2x2 taps."""
    r = cfg.out_size.bit_length() - 4
    c = cfg.step_channels * 2**r
    flops, cin, h = 2 * 16 * cfg.encoding_dims * c, c, 4
    for cout in [c // 2**i for i in range(1, r + 1)] + [cfg.out_channels]:
        h *= 2
        flops += 2 * h * h * cout * cin * 4
        cin = cout
    return batch * flops


def k4_bound(n, k, m):
    """The bound of K4 on x (n, k) f32, w_q (k, m) int8, per-column scale and
    bias f32, out (n, m) f32: each read or written once; 2*n*k*m operations
    at the bf16 dense tensor-core peak (the kernel's products are bf16)."""
    nbytes = n * k * 4 + k * m + 2 * m * 4 + n * m * 4
    return (*bound_ms(nbytes, 2 * n * k * m, BF16_FLOP_PER_S), nbytes)


def vae_encode_flops(cfg, batch):
    dims = (cfg.rna_features, *cfg.encoder_dims)
    return 2 * batch * (sum(a * b for a, b in zip(dims, dims[1:])) + 2 * dims[-1] * cfg.z_dim)


def randomize(module, gen):
    """Random BN running statistics, far from (0, 1), so BN folding is
    exercised; ConvTranspose and Conv weights redrawn with a variance that
    keeps the activations O(1), so the tiles span the uint8 range (DCGAN's
    N(0, 0.02) init gives tiles of one grey level)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(1.0, 2.0, generator=gen)
            elif isinstance(m, torch.nn.ConvTranspose2d):
                taps = 1 if m.stride[0] == 1 else 4  # a 1x1-input head vs a stride-2 4x4
                m.weight.normal_(0.0, (m.in_channels * taps) ** -0.5, generator=gen)
            elif isinstance(m, torch.nn.Conv2d):  # dcgan_up's 3x3 convs
                m.weight.normal_(0.0, (m.in_channels * 9) ** -0.5, generator=gen)


def uint8_diff(a, b):
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


#: (N, D) of the K1 checks: each one-pass instance (rows a thread 1, 2, 4, 8),
#: the loop kernel (N = 300), a D that is no multiple of 32
K1_SHAPES = tuple((n, d) for n in (2, 64, 128, 256, 300) for d in (2048, 2000))
MODES = ("u", "seed", "seed_broadcast", "population")


def check_k1(dev, gen):
    """K1 against its plain version in all four modes at each of ``K1_SHAPES``
    (1e-5), and at the main path's (128, 2048): column means 0 and stds 1, the
    same seed the same output, another seed another."""
    from rnagan_tpu_torch.kernels.infusion import (infused_noise, infused_noise_plain, philox_uniform,
                                                   rows_per_thread)

    errs = {}
    for n, d in K1_SHAPES:
        z = torch.randn(n, d, generator=gen, device=dev) * 3
        u = (torch.rand(n, d, generator=gen, device=dev) * 2 - 1) * 0.3
        pm = torch.randn(d, generator=gen, device=dev)
        ps = torch.rand(d, generator=gen, device=dev) + 0.5
        modes = {
            "u": infused_noise(z, n, u=u) - infused_noise_plain(z, n, u=u),
            "seed": infused_noise(z, n, seed=7) - infused_noise_plain(z, n, seed=7),
            "seed_broadcast": infused_noise(z[:1], n, seed=7) - infused_noise_plain(z[:1], n, seed=7),
            "population": (infused_noise(z[:1], n, seed=7, pop_mean=pm, pop_std=ps)
                           - infused_noise_plain(z[:1], n, seed=7, pop_mean=pm, pop_std=ps)),
        }
        errs[f"{n}x{d},rows{rows_per_thread(n)}"] = {k: float(v.abs().max()) for k, v in modes.items()}
        # both against float64 statistics of the same float32 x (reported, not gated)
        x = (philox_uniform(7, n, d, 0.3, dev) + z[:1]).double()
        ref = (x - x.mean(0)) / torch.sqrt(x.var(0, correction=1) + 1e-12)
        errs[f"{n}x{d},rows{rows_per_thread(n)}"]["seed_broadcast_vs_f64"] = {
            "kernel": float((infused_noise(z[:1], n, seed=7).double() - ref).abs().max()),
            "plain": float((infused_noise_plain(z[:1], n, seed=7).double() - ref).abs().max())}
    worst = max(e for per in errs.values() for k, e in per.items() if k in MODES)
    check(worst <= 1e-5, f"K1 differs from its plain version: {errs}")
    n, d = BATCH, 2048
    z = torch.randn(n, d, generator=gen, device=dev) * 3
    out = infused_noise(z, n, seed=7)
    check(float(out.mean(0).abs().max()) <= 1e-5, "K1 column means are not 0")
    check(float((out.std(0, correction=1) - 1).abs().max()) <= 1e-4, "K1 column stds are not 1")
    corr = float(torch.corrcoef(torch.stack([z[:, 0], out[:, 0]]))[0, 1])
    check(corr > 0.9, f"K1 corr(z, out) = {corr}")
    check(torch.equal(out, infused_noise(z, n, seed=7)), "K1 same seed, different output")
    check(float((out - infused_noise(z, n, seed=8)).abs().max()) > 1e-2, "K1 seeds 7 and 8 agree")
    print(f"K1 infused_noise vs plain, max abs err by shape and mode: {errs}; corr(z, out) {corr:.4f}")
    return worst


def check_k2(dev, gen):
    from rnagan_tpu_torch.kernels.quantize import tanh_to_uint8, tanh_to_uint8_plain

    x = torch.randn(BATCH, 3, 256, 256, generator=gen, device=dev) * 2
    got, ref = tanh_to_uint8(x), tanh_to_uint8_plain(x)
    check(got.shape == (BATCH, 256, 256, 3) and got.dtype == torch.uint8, "K2 output shape/dtype")
    worst, share = uint8_diff(got, ref)
    check(worst <= 1, f"K2 differs from its plain version by {worst} levels")
    ends = tanh_to_uint8(torch.tensor([-100.0, 0.0, 100.0], device=dev).reshape(1, 3, 1, 1).repeat(1, 1, 2, 2))
    check(ends[0, 0, 0].tolist() == [0, 128, 255], f"K2 endpoints {ends[0, 0, 0].tolist()}")
    print(f"K2 tanh_to_uint8 vs plain: max {worst} level, {share:.3e} of values differ; endpoints exact")
    return worst, share


ADAM_HP = dict(lr=1e-4, b1=0.5, b2=0.999, eps=1e-8)


def adam_corrections(t, b1=ADAM_HP["b1"], b2=ADAM_HP["b2"]):
    from rnagan_tpu_torch.optim.adam import bias_corrections

    return bias_corrections(t, b1, b2)


def adam_inputs(shapes, dev, gen, mu_dtype):
    """p, g, mu, nu as a step-5 state would hold them: nu >> (1-b2)*g^2, so
    the update is not the sign(g)*lr of a first step."""
    def draw(s, scale):
        return torch.randn(s, generator=gen, device=dev) * scale
    return ([draw(s, 0.02) for s in shapes], [draw(s, 1e-3) for s in shapes],
            [draw(s, 1e-3).to(mu_dtype) for s in shapes],
            [torch.rand(s, generator=gen, device=dev) * 1e-5 + 1e-7 for s in shapes])


def ulps(a, b):
    """Largest distance in units in the last place between two float tensors."""
    if a.dtype == torch.bfloat16:
        a, b = a.float(), b.float()
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def check_k3(dev, gen, shapes):
    """K3 against its plain version on one model's parameter list, float32 and
    bfloat16 mu. Both round each step alone in the same order: bit-equal."""
    from rnagan_tpu_torch.kernels.fused_adam import adam_update_plain, fused_adam

    c1, c2 = adam_corrections(6)
    worst, err = {}, 0.0
    for mu_dtype in (torch.float32, torch.bfloat16):
        a = adam_inputs(shapes, dev, gen, mu_dtype)
        p0 = [t.clone() for t in a[0]]
        b = [[t.clone() for t in ts] for ts in a]
        fused_adam(*a, c1=c1, c2=c2, **ADAM_HP)
        adam_update_plain(*b, c1, c2, **ADAM_HP)
        torch.cuda.synchronize()
        for name, xs, ys in zip(("p", "mu", "nu"), (a[0], a[2], a[3]), (b[0], b[2], b[3])):
            worst[f"{name}_{str(mu_dtype)[6:]}"] = max(ulps(x, y) for x, y in zip(xs, ys))
            err = max(err, max(float((x.float() - y.float()).abs().max()) for x, y in zip(xs, ys)))
        check(all(not torch.equal(x, y) for x, y in zip(a[0], p0)), "K3 left a tensor unchanged")
        del a, b, p0
    print(f"K3 fused_adam vs plain on {len(shapes)} tensors, "
          f"{sum(math.prod(s) for s in shapes):,} params: largest ulp difference {worst}, "
          f"max abs err {err}")
    check(max(worst.values()) == 0, f"K3 differs from its plain version: {worst} ulp")
    return err


def k3_timings(shapes_by_model, dev, gen):
    """K3 through its wrapper and replayed from a CUDA graph, its plain
    version, and ``torch.optim.Adam(fused=True)`` as the yardstick, per model."""
    from rnagan_tpu_torch.kernels.fused_adam import adam_update_plain, fused_adam

    c1, c2 = adam_corrections(6)
    out = {}
    for name, shapes in shapes_by_model.items():
        a = adam_inputs(shapes, dev, gen, torch.float32)
        params = sum(math.prod(s) for s in shapes)
        call = lambda: fused_adam(*a, c1=c1, c2=c2, **ADAM_HP)  # noqa: E731
        ps = [torch.nn.Parameter(t.clone()) for t in a[0]]
        for p, g in zip(ps, a[1]):
            p.grad = g
        library = torch.optim.Adam(ps, lr=ADAM_HP["lr"], betas=(ADAM_HP["b1"], ADAM_HP["b2"]),
                                   eps=ADAM_HP["eps"], fused=True)
        ms_bound, by = bound_ms(28 * params, 11 * params)  # read p, g, mu, nu; write p, mu, nu
        out[name] = {"params": params, "ms": time_ms(call, iters=20),
                     "device_ms": graph_ms(call, reps=10, iters=5),
                     "plain_ms": time_ms(lambda: adam_update_plain(*a, c1, c2, **ADAM_HP), iters=5),
                     "library_ms": time_ms(library.step, iters=10),
                     "bound_ms": ms_bound, "bound_by": by}
        del a, ps, library
    return out


#: (N, K, M) of the K4 checks: the generator head at batch 128, 64 and 1 (the
#: wgmma kernel's three N tiles), ragged N, K and M on the wgmma route (two N
#: tiles, K not a multiple of 8, M not of 256), several row tiles, and the
#: byte-wise route (M not a multiple of 16)
K4_SHAPES = ((BATCH, 2048, 32768), (64, 2048, 32768), (1, 2048, 32768), (129, 2048, 512),
             (65, 2051, 272), (37, 80, 272), (300, 64, 512), (5, 24, 270))
#: a weight whose pointer is not 16-byte aligned takes the byte-wise route too
K4_MISALIGNED = (64, 128, 512)


def check_k4(dev, gen):
    """K4 against its plain version, TF32 off for the plain version's matmul,
    on each route. bf16(x) and the int8 weight are exact in float32 and so are
    their products: only the order of the sums differs, within 1e-5 of max
    |out|."""
    from rnagan_tpu_torch.kernels.quant_matmul import int8_matmul, int8_matmul_plain, plan

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for (n, k, m), offset in [(s, 0) for s in K4_SHAPES] + [(K4_MISALIGNED, 1)]:
        x = torch.randn(n, k, generator=gen, device=dev) * 2
        w = torch.randint(-128, 128, (k * m + offset,), generator=gen, device=dev, dtype=torch.int8)
        w = w[offset:].view(k, m)
        scale = torch.rand(m, generator=gen, device=dev) * 1e-3 + 1e-4
        bias = torch.randn(m, generator=gen, device=dev) * 0.1
        route = plan(n, k, m, w.data_ptr()).route
        before = int8_matmul.launches_by_route[route]
        got, ref = int8_matmul(x, w, scale, bias), int8_matmul_plain(x, w, scale, bias)
        err = float((got - ref).abs().max())
        key = f"{n}x{k}x{m}" + (f"+{offset}" if offset else "")
        errs[key] = {"route": route, "max_abs_err": err, "rel_to_max": err / float(ref.abs().max())}
        check(int8_matmul.launches_by_route[route] == before + 1, f"K4 {key} did not take the {route} route")
        check(got.shape == (n, m) and bool(torch.isfinite(got).all()), f"K4 {key} output")
        check(errs[key]["rel_to_max"] <= 1e-5, f"K4 {key} differs: {errs}")
    check({e["route"] for e in errs.values()} == {"wgmma", "bytewise"}, f"K4 routes checked: {errs}")
    print(f"K4 int8_matmul vs plain: {errs}")
    return errs


def k4_small_batches(x, k4_args, w_bf16):
    """K4's device time (graph replay) on the head's weights at N = 64 and
    N = 1, with its bound and the bf16 library product's device time."""
    from rnagan_tpu_torch.kernels.quant_matmul import int8_matmul

    _, w_q, scale, bias = k4_args
    out = {}
    for n in (64, 1):
        xn = x[:n].contiguous()
        xb = xn.to(torch.bfloat16)
        out[f"device_ms_n{n}"] = graph_ms(lambda: int8_matmul(xn, w_q, scale, bias))
        out[f"bound_ms_n{n}"] = k4_bound(n, *w_q.shape)[0]
        out[f"library_device_ms_n{n}"] = graph_ms(lambda: torch.matmul(xb, w_bf16))
    return out


def head_weights(serve):
    """The int8 head's (w_q, scale, bias) of a quantized-head serving fn."""
    w = serve.weights
    return w["model.0.0.weight_q"], w["model.0.0.w_scale"], w["model.0.0.bias"]


def quantized_head_path(dev, cfg, vae_sd, g_sd, genes, z_pop, float_synth):
    """The float main path's three requests through ``Synthesizer(quantized_head=True)``,
    the K1, K4 and K2 counters set to 0 before them and read after; the
    requests again through the three kernels' plain versions (at most one
    uint8 level apart); the int8 head's deviation from the float head on the
    same noise, in tanh space."""
    from rnagan_tpu_torch.eval.generate import Synthesizer
    from rnagan_tpu_torch.eval.serving import dcgan_apply
    from rnagan_tpu_torch.kernels.infusion import infused_noise, infused_noise_plain
    from rnagan_tpu_torch.kernels.quant_matmul import int8_matmul, int8_matmul_plain
    from rnagan_tpu_torch.kernels.quantize import tanh_to_uint8, tanh_to_uint8_plain
    from rnagan_tpu_torch.losses.rna_infusion import encode_z_mean

    synth = Synthesizer(cfg, vae_sd, g_sd, quantized_head=True, device=dev)
    torch.cuda.synchronize()
    infused_noise.launches = int8_matmul.launches = tanh_to_uint8.launches = 0
    int8_matmul.launches_by_route = dict.fromkeys(int8_matmul.launches_by_route, 0)
    t0 = time.perf_counter()
    first = synth.synthesize(genes, seed=11)
    one_patient = synth.synthesize(genes[:1], 64, seed=12, z_pop=z_pop)
    repeat = synth.synthesize(genes, seed=11)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"infused_noise": infused_noise.launches, "int8_matmul": int8_matmul.launches,
                "tanh_to_uint8": tanh_to_uint8.launches}
    by_route = dict(int8_matmul.launches_by_route)
    print(f"quantized-head path: 3 requests in {seconds:.3f} s; launches {launches}, K4 by route {by_route}")
    check(all(v > 0 for v in launches.values()), f"a kernel of the quantized path never launched: {launches}")
    check(by_route == {"wgmma": launches["int8_matmul"], "bytewise": 0},
          f"the int8 head did not go through the wgmma kernel: {by_route}")
    size = cfg.model.out_size
    check(first.shape == (BATCH, size, size, 3) and first.dtype == torch.uint8, "quantized request 1")
    check(one_patient.shape == (64, size, size, 3), "quantized request 2 shape")
    check(torch.equal(first, repeat), "the repeated quantized request is not bit-identical")
    check(float(first.float().std()) > 1.0, "quantized request 1 tiles are constant")

    w_q, scale, bias = head_weights(synth.serve)
    p = synth.serve.weights
    gan_cfg = cfg.model

    def plain(z, n, **kw):
        noise = infused_noise_plain(z, n, **kw)
        head = lambda x: int8_matmul_plain(x, w_q, scale, bias).view(n, -1, 4, 4)  # noqa: E731
        return tanh_to_uint8_plain(dcgan_apply(gan_cfg, p, noise, head_fn=head, final_tanh=False))

    with torch.inference_mode():
        plain_first = plain(encode_z_mean(synth.vae, genes), BATCH, seed=11)
        plain_pop = plain(encode_z_mean(synth.vae, genes[:1]), 64, seed=12, pop_mean=z_pop[0],
                          pop_std=z_pop[1])
        noise = infused_noise(encode_z_mean(synth.vae, genes), BATCH, seed=11)
        q = torch.tanh(synth.serve.generator(noise))
        f = torch.tanh(float_synth.serve.generator(noise))
    path_diff = {"reference": uint8_diff(first, plain_first), "population": uint8_diff(one_patient, plain_pop)}
    for k, (worst, share) in path_diff.items():
        check(worst <= 1, f"quantized {k} request: kernel path vs plain path {worst} levels")
    d = (q - f).abs()
    deviation = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
                 "corr": float(torch.corrcoef(torch.stack([q.flatten(), f.flatten()]))[0, 1])}
    check(deviation["corr"] > 0.99, f"int8 head vs float head: {deviation}")
    print(f"quantized-head kernel path vs plain: {path_diff}; int8 vs float head (tanh space): "
          f"{deviation}")
    return synth, {"seconds": seconds, "launches": launches, "k4_launches_by_route": by_route,
                   "kernel_vs_plain_path": path_diff,
                   "int8_vs_float_head": deviation}


#: the small configurations of the serving options, card against CPU, with the
#: uint8 tolerance of their CPU tests (tests/test_torch_port_serving.py)
SMALL_VARIANTS = (("dcgan", {"quantized_full": True}, 0.01),
                  ("dcgan_up", {"exact_border": True}, 0.005),
                  ("dcgan_up", {"exact_border": True, "small_exact": 4}, 0.005),
                  ("dcgan_up", {"exact_border": False}, 0.005),
                  ("dcgan_up", {"quantized_head": True}, 0.005),
                  ("condgan", {}, 0.005))


def serving_variants_match_cpu(dev):
    """Each small configuration served on the card and on the CPU (whose paths
    the CPU tests hold against the JAX package), from the same weights and
    noise: uint8 at most one level apart on a small share, float32 reported.
    W8A8 (TF32 integer convs on the card, float32 on the CPU) is held to its
    CPU test's bound: within 0.05, and 1e-5 on 99 % of the values."""
    from rnagan_tpu_torch.core.config import GANModelConfig
    from rnagan_tpu_torch.eval.serving import make_serving_fn
    from rnagan_tpu_torch.models.dcgan import make_generator

    gen = torch.Generator().manual_seed(SEED + 1)
    out = {}
    for arch, kw, share_tol in SMALL_VARIANTS:
        m = GANModelConfig(arch=arch, out_size=64, encoding_dims=64, step_channels=8,
                           num_classes=3 if arch == "condgan" else 0, compute_dtype="float32")
        g = make_generator(m, seed=4)
        randomize(g, gen)
        sd = g.state_dict()
        noise = torch.randn(8, 64, generator=gen)
        extra = (torch.tensor([0, 1, 2, 0, 1, 2, 2, 1]),) if arch == "condgan" else ()
        u8 = [make_serving_fn(m, sd, device=d, **kw)(noise, *extra).cpu() for d in (dev, "cpu")]
        fl = [make_serving_fn(m, sd, device=d, uint8_output=False, **kw)(noise, *extra).cpu()
              for d in (dev, "cpu")]
        worst, share = uint8_diff(*u8)
        fd = (fl[0] - fl[1]).abs()
        name = arch + "".join(f",{k}={v}" for k, v in kw.items())
        out[name] = {"uint8_levels": worst, "uint8_share": share, "float_max_abs": float(fd.max())}
        check(worst <= 1 and share < share_tol, f"{name}: card vs CPU {out[name]}")
        check(float(u8[1].float().std()) > 5.0, f"{name}: the tiles are constant")
        if kw.get("quantized_full"):
            check(float(fd.max()) <= 0.05 and float((fd > 1e-5).float().mean()) <= 0.01,
                  f"{name}: card vs CPU {out[name]}")
    print(f"serving options, small configurations, card vs CPU: {out}")
    return out


def dcgan_up_stage_ms(model, up_sd, noise):
    """The ``dcgan_up`` generator stage three ways: fused with the border left
    as the transposed conv makes it, and unfused (the BN-folded
    ``DCGANUpGenerator``: upsample, reflect pad, 3x3 conv)."""
    from rnagan_tpu_torch.eval.serving import fold_generator, make_serving_fn
    from rnagan_tpu_torch.models.dcgan import DCGANUpGenerator

    no_fix = make_serving_fn(model, up_sd, exact_border=False, device=noise.device)
    folded_cfg, folded = fold_generator(model, up_sd)
    two_op = DCGANUpGenerator(folded_cfg, compat_no_tanh=True, device=noise.device)
    two_op.load_state_dict(folded)
    two_op.eval().requires_grad_(False)
    with torch.inference_mode():
        return {"generator_no_border_fix_ms": time_ms(lambda: no_fix.generator(noise), iters=5),
                "two_op_generator_ms": time_ms(lambda: two_op(noise), iters=5)}


#: cuDNN's algorithm choices the W8A8 layer check runs under; the first two gate
W8A8_CUDNN_MODES = {"default": {"deterministic": False, "benchmark": False},
                    "deterministic": {"deterministic": True, "benchmark": False},
                    "autotuned": {"deterministic": False, "benchmark": True}}
#: noise rows of a full-width option served on the card and on the CPU
CPU_ROWS = 4


def w8a8_layers_exact(model, q, noise):
    """Every W8A8 layer at full width on the served batch: the integer-valued
    float32 transposed conv as served (cuDNN, TF32 forced on) against the same
    conv in float64, exact for these integers, under each of
    ``W8A8_CUDNN_MODES``. Per layer: the largest |sum| and how many outputs
    differ in each mode; none may under cuDNN's default or deterministic
    choice."""
    import torch.nn.functional as F
    from rnagan_tpu_torch.eval.serving import _int8_conv_transpose, exact_integer_convs

    r = model.out_size.bit_length() - 4
    x, layers = noise.float()[:, :, None, None], []
    for b in range(r + 2):
        stride, pad = (1, 0) if b == 0 else (2, 1)
        w = q[f"model.{b}.0.weight_q"]
        a = torch.clamp(x.abs().amax() / torch.tensor(127.0, device=x.device), min=1e-8)
        xq = torch.clamp(torch.round(x / a), -127.0, 127.0)
        ref = F.conv_transpose2d(xq.double(), w.double(), None, stride, pad)
        check(torch.equal(ref, ref.round()), f"W8A8 layer {b}: the float64 sums are not integers")
        layer = {"max_abs_sum": float(ref.abs().max()), "outputs": ref.numel()}
        for mode, flags in W8A8_CUDNN_MODES.items():
            with torch.backends.cudnn.flags(enabled=True, **flags), exact_integer_convs():
                y = F.conv_transpose2d(xq, w, None, stride, pad)
            layer[f"differ_{mode}"] = int((y.double() != ref).sum())
        layers.append(layer)
        check(layer["differ_default"] == 0 and layer["differ_deterministic"] == 0,
              f"W8A8 layer {b} is not exact at full width: {layer}")
        del ref, y
        x = _int8_conv_transpose(x, q, b, stride, pad)
        if b <= r:
            x = F.leaky_relu(x, model.leaky_slope)
    return layers


def full_width_option_check(name, serve, model, sd, noise):
    """A full-width serving option checked on the card, on the timed
    Synthesizer's generator: finite tiles that vary; for W8A8 each layer exact
    (``w8a8_layers_exact``) and its tiles against the float path's on the same
    noise (tanh space; correlation gated as the int8 head's); and ``CPU_ROWS``
    noise rows served on the card and on the CPU (W8A8 as a batch of its own:
    its activation scales span the batch) within the small configurations'
    tolerances (``SMALL_VARIANTS``)."""
    from rnagan_tpu_torch.eval.serving import make_serving_fn

    kw = {"quantized_full": True} if name == "quantized_full" else {}
    out = {}
    with torch.inference_mode():
        t = torch.tanh(serve.generator(noise))
        check(bool(torch.isfinite(t).all()) and float(t.std()) > 0.05, f"{name}: full-width tiles are constant")
        if name == "quantized_full":
            out["layers"] = w8a8_layers_exact(model, serve.weights, noise)
            f = torch.tanh(make_serving_fn(model, sd, device=noise.device).generator(noise))
            d = (t - f).abs()
            out["vs_float"] = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
                               "corr": float(torch.corrcoef(torch.stack([t.flatten(), f.flatten()]))[0, 1])}
            check(out["vs_float"]["corr"] > 0.99, f"W8A8 vs float at full width: {out['vs_float']}")
            del f, d
        del t
        rows = noise[:CPU_ROWS]
        cpu = make_serving_fn(model, sd, device="cpu", **kw)
        u8 = serve(rows).cpu(), cpu(rows.cpu())
        fl = torch.tanh(serve.generator(rows)).cpu(), torch.tanh(cpu.generator(rows.cpu()))
    worst, share = uint8_diff(*u8)
    fd = (fl[0] - fl[1]).abs()
    out["vs_cpu"] = {"rows": CPU_ROWS, "uint8_levels": worst, "uint8_share": share,
                     "float_max_abs": float(fd.max()), "float_share_over_1e-5": float((fd > 1e-5).float().mean())}
    tol = 0.01 if kw else 0.005  # SMALL_VARIANTS' shares for W8A8 and dcgan_up
    check(worst <= 1 and share < tol,f"{name}: full-width rows, card vs CPU {out['vs_cpu']}")
    if kw:
        check(out["vs_cpu"]["float_max_abs"] <= 0.05 and out["vs_cpu"]["float_share_over_1e-5"] <= 0.01,
              f"{name}: full-width rows, card vs CPU {out['vs_cpu']}")
    print(f"{name} at full width, checked: {out}")
    return out


def serving_option_timings(cfg, vae_sd, g_sd, up_sd, genes):
    """Tiles/s at batch 128 of the quantized-head, W8A8 and dcgan_up serving,
    float32 and bfloat16, and the generator stage alone; W8A8 and dcgan_up
    in float32 checked at that width (``full_width_option_check``)."""
    from rnagan_tpu_torch.eval.generate import Synthesizer
    from rnagan_tpu_torch.kernels.infusion import infused_noise
    from rnagan_tpu_torch.losses.rna_infusion import encode_z_mean

    out = {}
    for name, kw in (("quantized_head", {"quantized_head": True}),
                     ("quantized_full", {"quantized_full": True}), ("dcgan_up", {})):
        for dtype in ("float32", "bfloat16"):
            model = dataclasses.replace(cfg.model, compute_dtype=dtype,
                                        arch="dcgan_up" if name == "dcgan_up" else "dcgan")
            c = dataclasses.replace(cfg, model=model, vae=dataclasses.replace(cfg.vae, compute_dtype=dtype))
            s = Synthesizer(c, vae_sd, up_sd if name == "dcgan_up" else g_sd, device=genes.device, **kw)
            with torch.inference_mode():
                noise = infused_noise(encode_z_mean(s.vae, genes), BATCH, seed=5)
                gen_ms = time_ms(lambda: s.serve.generator(noise), iters=5)
            req_ms = time_ms(lambda: s.synthesize(genes, seed=5), iters=5)
            out[f"{name}_{dtype}"] = {"request_ms_b128": req_ms, "tiles_per_s": BATCH / req_ms * 1e3,
                                      "generator_ms": gen_ms}
            if name == "dcgan_up":  # what the fusion and the exact border cost on this card
                out[f"{name}_{dtype}"].update(dcgan_up_stage_ms(model, up_sd, noise))
            if name != "quantized_head" and dtype == "float32":
                out[f"{name}_{dtype}"]["check"] = full_width_option_check(
                    name, s.serve, model, up_sd if name == "dcgan_up" else g_sd, noise)
            del s
    return out


# ---------------------------------------------------------------- training


def random_batch(gen, n, cfg, dev, size=256):
    return {"image": torch.randint(0, 256, (n, size, size, 3), generator=gen, device=dev,
                                   dtype=torch.uint8),
            "rna_data": torch.randn(n, cfg.vae.rna_features, generator=gen, device=dev)}


def training_draws(gen, n, cfg, dev):
    """A step's draws: the stages' uniforms and the GP's eps, one scalar
    under ``compat_reference_gp``."""
    d, r = cfg.model.encoding_dims, cfg.noise_range
    u = lambda: (torch.rand(n, d, generator=gen, device=dev) * 2 - 1) * r  # noqa: E731
    eps_shape = () if cfg.compat_reference_gp else (n, 1, 1, 1)
    return {"u_d": u(), "u_gp": u(), "u_g": u(), "eps": torch.rand(eps_shape, generator=gen, device=dev)}


def warm_adam(state, gen):
    """Adam moments as at step 5 (nu far above (1-b2)*g^2), so one step's
    update is smooth in the gradient instead of the sign(g)*lr of a first step."""
    for opt in (state.g_opt, state.d_opt):
        warm_moments(opt, gen)
    state.step = 5


def warm_moments(opt, gen):
    """One Adam/AdamW's moments and count as :func:`warm_adam` sets them."""
    for mu, nu in zip(opt.mu, opt.nu):
        mu.copy_(torch.randn(mu.shape, generator=gen, device=mu.device) * 1e-3)
        nu.copy_((torch.rand(nu.shape, generator=gen, device=nu.device) + 0.5) * 1e-2)
    opt.count = 5


def state_to(state, dev):
    """A copy of a ``GANTrainState`` on ``dev``."""
    st = copy.deepcopy(state)
    st.generator.to(dev)
    st.discriminator.to(dev)
    st.g_stats = [(m.to(dev), v.to(dev)) for m, v in st.g_stats]
    st.d_stats = [(m.to(dev), v.to(dev)) for m, v in st.d_stats]
    for opt in (st.g_opt, st.d_opt):
        opt.mu, opt.nu = [t.to(dev) for t in opt.mu], [t.to(dev) for t in opt.nu]
    if st.g_ema is not None:
        st.g_ema = [t.to(dev) for t in st.g_ema]
    return st


def state_pairs(a, b):
    """(group, tensor of a, tensor of b) over parameters, BN statistics and Adam moments."""
    for group, x, y in (("params", a.generator, b.generator), ("params", a.discriminator, b.discriminator)):
        yield from ((group, p, q) for p, q in zip(x.parameters(), y.parameters()))
    for s, t in ((a.g_stats, b.g_stats), (a.d_stats, b.d_stats)):
        yield from (("stats", x, y) for u, w in zip(s, t) for x, y in zip(u, w))
    for o, q in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        yield from (("mu", x, y) for x, y in zip(o.mu, q.mu))
        yield from (("nu", x, y) for x, y in zip(o.nu, q.nu))


def state_diff(a, b):
    """Largest absolute difference between two training states."""
    return max(float((x.detach().float() - y.detach().float().to(x.device)).abs().max())
               for _, x, y in state_pairs(a, b))


#: group -> (rtol, atol, share of the tensor's largest value): the CPU tests'
#: bounds (tests/test_torch_port_train.py) for one step from the same state
STATE_TOL = {"params": (1e-6, 1e-7, 0.0), "stats": (1e-5, 1e-6, 0.0),
             "mu": (1e-4, 1e-7, 1e-5), "nu": (1e-4, 1e-9, 1e-5)}


def share_refs(net, moments):
    """The tensor whose largest value scales each moment's share term, as the
    CPU tests take it (``tests/test_torch_port_train_archs.py::_grad_scale``):
    its own, except for a conv bias that a train-mode BatchNorm follows
    (``dcgan_up``'s ``model.<b>.0.bias``). That bias's gradient is 0 up to
    rounding, so both sides hold rounding noise of the sums behind the
    conv's kernel gradient, and its scale is the kernel's moment."""
    names = [n for n, _ in net.named_parameters()]
    refs = []
    for n, m in zip(names, moments):
        kernel = n.replace(".0.bias", ".0.weight")
        bn_after = n.endswith(".0.bias") and n.replace(".0.bias", ".1.weight") in names
        refs.append(moments[names.index(kernel)] if bn_after else m)
    return refs


def state_excess(a, b):
    """The largest ratio of a difference to its allowance under STATE_TOL (1 passes)."""
    def ratio(group, x, y, ref):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        rtol, atol, share = STATE_TOL[group]
        allow = atol + rtol * y.abs() + share * float(ref.detach().float().abs().max())
        return float(((x - y).abs() / allow).max())

    worst = 0.0
    for group, x, y in state_pairs(a, b):
        if group in ("params", "stats"):
            worst = max(worst, ratio(group, x, y, y))
    for net, o, q in ((b.generator, a.g_opt, b.g_opt), (b.discriminator, a.d_opt, b.d_opt)):
        for group, xs, ys in (("mu", o.mu, q.mu), ("nu", o.nu, q.nu)):
            for x, y, ref in zip(xs, ys, share_refs(net, ys), strict=True):
                worst = max(worst, ratio(group, x, y, ref))
    return worst


@contextlib.contextmanager
def plain_adam():
    """Adam steps through K3's plain version instead of the kernel."""
    from rnagan_tpu_torch.kernels.fused_adam import adam_update_plain
    from rnagan_tpu_torch.optim import adam as adam_module

    kernel = adam_module.fused_adam
    adam_module.fused_adam = lambda p, g, mu, nu, *, c1, c2, lr, b1, b2, eps, wd=0.0: adam_update_plain(
        p, g, mu, nu, c1, c2, lr, b1, b2, eps, wd)
    try:
        yield
    finally:
        adam_module.fused_adam = kernel


def train_kernel_vs_plain(dev, gen, vae_sd):
    """One full-width float32 step through K3 and the same step through the
    plain Adam, from one state with the same batch and draws: bit-equal.

    cuDNN is deterministic, but its algorithm choice for the very first step
    differs from later ones (the free workspace changes once the first step
    has allocated), which moves a few values by an ulp. So a throwaway step
    runs first, and ``first_step_max_abs_diff`` reports how far it lies from
    the compared steps."""
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    cfg = GANConfig(model=GANModelConfig(compute_dtype="float32"))
    tr = GANTrainer(cfg, vae_sd, device=dev)
    a = tr.init_state()
    warm_adam(a, gen)
    first, b = copy.deepcopy(a), copy.deepcopy(a)
    batch, draws = random_batch(gen, cfg.batch_size, cfg, dev), training_draws(gen, cfg.batch_size, cfg, dev)
    tr.train_step(first, batch, draws)
    _, ma = tr.train_step(a, batch, draws)
    with plain_adam():
        _, mb = tr.train_step(b, batch, draws)
    diff = state_diff(a, b)
    metric_diff = max(abs(float(ma[k]) - float(mb[k])) for k in ma)
    check(diff == 0.0 and metric_diff == 0.0,
          f"full-width f32 step: K3 vs plain Adam differ by {diff} (metrics {metric_diff})")
    return {"state_max_abs_diff": diff, "metric_max_abs_diff": metric_diff,
            "first_step_max_abs_diff": state_diff(first, a),
            "metrics": {k: float(v) for k, v in ma.items()}}


def open_gates(module, gen):
    """SAGAN's and BigGAN's attention gate ``gamma`` and the conditional
    BatchNorm projections start at 0: set and drawn here, so a check goes
    through the attention and the conditioning."""
    from rnagan_tpu_torch.models.biggan import ConditionalBatchNorm
    from rnagan_tpu_torch.models.sagan import SelfAttention2d

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, SelfAttention2d):
                m.gamma.fill_(0.5)
            elif isinstance(m, ConditionalBatchNorm):
                for lin in (m.gamma, m.beta):
                    lin.weight.normal_(0.0, 0.3 * lin.in_features ** -0.5, generator=gen)


def expected_launches(cfg, first_step, steps):
    """K1 and K3 launches of ``steps`` wganvae steps from ``first_step``: a
    D stage each, a GP stage each under ``compat_reference_gp``, and a G
    stage on every ``n_critic``-th step (``GANTrainer._train_step``)."""
    n = 0
    for step in range(first_step, first_step + steps):
        n += 1 + int(cfg.compat_reference_gp) + int(cfg.n_critic <= 1 or step % cfg.n_critic == cfg.n_critic - 1)
    return {"fused_adam": n, "infused_noise": n}


def train_small_matches_cpu(dev, gen, arch="dcgan", remat_check=False, cfg_kw=None, steps=1, **model_kw):
    """A small configuration's ``steps`` steps of ``arch`` (``GANConfig``
    fields ``cfg_kw``, ``GANModelConfig`` fields ``model_kw``) on the card
    against the same steps on the CPU (whose plain versions the CPU tests
    hold against the JAX package), each step on the same batch and draws;
    ``condgan``, and ``biggan`` with classes, with labels; SAGAN and BigGAN
    with their attention gates and projections drawn (``open_gates``).
    cuDNN and the CPU sum convolutions in other orders: the state (the EMA
    of G's weights too, at the parameters' bound) within the CPU tests'
    bounds (``STATE_TOL``), metrics within 1e-3 relative + 1e-5. The card's
    steps launch K1 and K3 as :func:`expected_launches` counts (twice each
    for one plain step: the D and G stages). ``remat_check``: the same step
    again on the card, plain and with ``remat`` (recomputed blocks),
    bit-equal to each other (the first card step ran before them: cuDNN's
    first call may choose other algorithms)."""
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.kernels.infusion import infused_noise
    from rnagan_tpu_torch.models.betavae import BetaVAE
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    kw = dict(arch=arch, out_size=32, encoding_dims=64, step_channels=8,
              num_classes=3 if arch == "condgan" else 0, compute_dtype="float32")
    cfg = GANConfig(model=GANModelConfig(**{**kw, **model_kw}),
                    vae=VAEModelConfig(rna_features=256, z_dim=64, encoder_dims=(128, 96, 64),
                                       decoder_dims=(96, 128)), **(cfg_kw or {}))
    cpu_gen = torch.Generator().manual_seed(SEED)
    vae = BetaVAE(cfg.vae, seed=3)
    randomize(vae, cpu_gen)
    cpu = GANTrainer(cfg, vae.state_dict(), device="cpu")
    card = GANTrainer(cfg, vae.state_dict(), device=dev)
    s_cpu = cpu.init_state()
    open_gates(s_cpu.generator, cpu_gen)
    open_gates(s_cpu.discriminator, cpu_gen)
    warm_adam(s_cpu, cpu_gen)
    s_card = state_to(s_cpu, dev)
    s_again = [state_to(s_cpu, dev) for _ in range(2)] if remat_check else []
    batch = random_batch(cpu_gen, cfg.batch_size, cfg, "cpu", size=cfg.model.out_size)
    if cfg.model.num_classes:
        batch["labels"] = torch.randint(0, cfg.model.num_classes, (cfg.batch_size,), generator=cpu_gen)
    draws = training_draws(cpu_gen, cfg.batch_size, cfg, "cpu")
    first_step = s_cpu.step
    cpu_metrics = [cpu.train_step(s_cpu, batch, draws)[1] for _ in range(steps)]
    before = (fused_adam.launches, infused_noise.launches)
    card_metrics = [card.train_step(s_card, batch, draws)[1] for _ in range(steps)]
    launches = {"fused_adam": fused_adam.launches - before[0], "infused_noise": infused_noise.launches - before[1]}
    name = " ".join(str(part) for part in (arch, cfg_kw or "", model_kw or "") if part)
    check(launches == expected_launches(cfg, first_step, steps), f"small {name} step launches {launches}")
    excess = state_excess(s_card, s_cpu)
    for m_cpu, m_card in zip(cpu_metrics, card_metrics):
        for k in m_cpu:
            a, b = float(m_cpu[k]), float(m_card[k])
            check(abs(a - b) <= 1e-3 * abs(a) + 1e-5, f"small {name} training step {k}: CPU {a}, card {b}")
    check(excess <= 1.0, f"small {name} training step: card vs CPU state at {excess} x its tolerance")
    out = {"state_excess": excess, "state_max_abs_diff": state_diff(s_card, s_cpu), "launches": launches}
    if s_cpu.g_ema is not None:
        rtol, atol, _ = STATE_TOL["params"]
        ema_excess = max(float(((x.cpu() - y).abs() / (atol + rtol * y.abs())).max())
                         for x, y in zip(s_card.g_ema, s_cpu.g_ema, strict=True))
        check(ema_excess <= 1.0, f"small {name}: card vs CPU EMA of G at {ema_excess} x its tolerance")
        out["ema_excess"] = ema_excess
    if remat_check:
        plain, remat = s_again
        for net in (remat.generator, remat.discriminator):
            net.cfg = dataclasses.replace(net.cfg, remat=True)
        _, m_plain = card.train_step(plain, batch, draws)
        _, m_remat = card.train_step(remat, batch, draws)
        diff = state_diff(plain, remat)
        metric_diff = max(abs(float(m_plain[k]) - float(m_remat[k])) for k in m_plain)
        check(diff == 0.0 and metric_diff == 0.0,
              f"small {name}: remat step differs from the plain step on the card by {diff} (metrics {metric_diff})")
        out.update(remat_vs_plain_max_abs_diff=diff, remat_state_excess_vs_cpu=state_excess(remat, s_cpu))
    return out


def train_main_path(dev, gen, vae_sd):
    """``GANConfig()`` at full width (wganvae, bfloat16, batch 8) on random
    uint8 tiles and genes: 3 warm-up steps, then 10 steps with the launch
    counters set to 0 before them and read after."""
    from rnagan_tpu_torch.core.config import GANConfig
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.kernels.infusion import infused_noise
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    cfg = GANConfig()
    tr = GANTrainer(cfg, vae_sd, device=dev)
    st = tr.init_state()
    batches = [random_batch(gen, cfg.batch_size, cfg, dev) for _ in range(4)]
    before = [p.detach().clone() for p in (*st.generator.parameters(), *st.discriminator.parameters())]
    for i in range(3):
        tr.train_step(st, batches[i % 4])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_adam.launches = infused_noise.launches = 0
    t0 = time.perf_counter()
    metrics = [tr.train_step(st, batches[i % 4])[1] for i in range(10)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    launches = {"fused_adam": fused_adam.launches, "infused_noise": infused_noise.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"training path: 10 steps at batch 8, {step_ms:.2f} ms a step; launches {launches}")
    check(launches == {"fused_adam": 20, "infused_noise": 20},
          f"training launches {launches}, expected 2 a step each")
    last = {k: float(v) for k, v in metrics[-1].items()}
    check(all(math.isfinite(float(v)) for m in metrics for v in m.values()), f"losses not finite: {last}")
    after = [*st.generator.parameters(), *st.discriminator.parameters()]
    unchanged = sum(bool(torch.equal(a, b)) for a, b in zip(before, after))
    check(unchanged == 0, f"{unchanged} parameter tensors did not change in 13 steps")
    check(st.g_opt.count == st.d_opt.count == 13 and st.step == 13, "Adam counts")
    return tr, st, batches, {"step_ms_b8": step_ms, "peak_mem_gib_b8": peak_gib,
                             "launches": launches, "last_metrics": last}


def train_step_ms_b64(dev, gen, vae_sd):
    from rnagan_tpu_torch.core.config import GANConfig
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    cfg = GANConfig(batch_size=64)
    tr = GANTrainer(cfg, vae_sd, device=dev)
    st = tr.init_state()
    batch = random_batch(gen, cfg.batch_size, cfg, dev)
    for _ in range(2):
        tr.train_step(st, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        tr.train_step(st, batch)
    torch.cuda.synchronize()
    return {"step_ms_b64": (time.perf_counter() - t0) * 1e3 / 5,
            "peak_mem_gib_b64": torch.cuda.max_memory_allocated() / 2**30}


def training_stage_ms(tr, st, batch):
    """The step's stages one by one with CUDA events, at the step's shapes:
    what ``train_step`` runs, without applying the updates."""
    from rnagan_tpu_torch.kernels.infusion import infused_noise
    from rnagan_tpu_torch.losses import gan as losses
    from rnagan_tpu_torch.losses.rna_infusion import encode_z_mean

    cfg, dev = tr.cfg, tr.device
    G, D = st.generator, st.discriminator
    g_params, d_params = list(G.parameters()), list(D.parameters())
    real = (batch["image"].float() / 127.5 - 1.0).permute(0, 3, 1, 2).contiguous()
    n = real.shape[0]
    z = encode_z_mean(tr.vae, batch["rna_data"])
    noise = infused_noise(z, n, seed=1)
    with torch.no_grad():
        fake, _ = G.forward_stats(noise, st.g_stats, True)
    eps = torch.rand(n, 1, 1, 1, device=dev)
    interp = eps * real + (1.0 - eps) * fake

    def g_forward():
        with torch.no_grad():
            G.forward_stats(noise, st.g_stats, True)

    def critic_loss():
        dx, s1 = D(real, st.d_stats, True)
        dgz, s2 = D(fake, s1, True)
        return losses.wasserstein_discriminator_loss(dx, dgz), s2

    def d_critic():
        torch.autograd.grad(critic_loss()[0], d_params)

    def d_stage():
        loss, s2 = critic_loss()
        gp = losses.gradient_penalty(lambda x: D(x, s2, True)[0], interp)
        torch.autograd.grad(loss + cfg.gp_lambda * gp, d_params)

    def g_stage():
        f, _ = G.forward_stats(noise, st.g_stats, True)
        dgz, _ = D(f, st.d_stats, True)
        torch.autograd.grad(losses.wasserstein_generator_loss(dgz), g_params)

    t = {"vae_encode_ms": time_ms(lambda: encode_z_mean(tr.vae, batch["rna_data"]), iters=10),
         "infused_noise_ms": time_ms(lambda: infused_noise(z, n, seed=1), iters=20),
         "g_forward_ms": time_ms(g_forward, iters=10),
         "d_critic_fwd_bwd_ms": time_ms(d_critic, iters=10),
         "d_stage_with_gp_ms": time_ms(d_stage, iters=10),
         "g_stage_ms": time_ms(g_stage, iters=10)}
    t["gp_ms"] = t["d_stage_with_gp_ms"] - t["d_critic_fwd_bwd_ms"]
    return t


def kernel_category(name):
    n = name.lower()
    for cat, keys in (("K3 fused_adam", ("fused_adam",)), ("K1 infused_noise", ("infused_noise",)),
                      ("convolution (cuDNN)", ("conv", "dgrad", "wgrad", "fprop", "cudnn", "implicit")),
                      ("matmul (cuBLAS)", ("gemm", "cublas", "cutlass")),
                      ("reduction", ("reduce",))):
        if any(k in n for k in keys):
            return cat
    return "elementwise and other"


def profile_training(step, steps=3):
    """``steps`` calls of ``step()`` (a training step) under ``torch.profiler``:
    device time by kernel category and the heaviest kernels, and the device's
    idle share of the window (the profiler's own host cost inflates the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3 / steps  # noqa: E731
    busy = sum(dev_ms(e) for e in kernels)
    if busy == 0.0:
        return {"device_time": "not measured: the profiler recorded no device time"}
    cats = {}
    for e in kernels:
        cats[kernel_category(e.key)] = cats.get(kernel_category(e.key), 0.0) + dev_ms(e)
    top = sorted(kernels, key=dev_ms, reverse=True)[:10]
    return {"wall_ms_per_step": wall_ms / steps, "device_busy_ms_per_step": busy,
            "launches_per_step": sum(e.count for e in kernels) / steps,
            "device_idle_share": 1.0 - busy * steps / wall_ms,
            "by_category_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
            "top_kernels": [(e.key[:90], dev_ms(e), e.count // steps) for e in top]}


# ------------------------------------------------------------ VAE training

#: the CPU tests' bounds (tests/test_torch_port_vae.py): rtol, share of the
#: tensor's largest value
VAE_TOL = {"params": (1e-5, 1e-6), "stats": (1e-5, 1e-6), "moments": (1e-5, 1e-5)}
#: rows of random "normalized expression" the full-width fit trains and validates on
VAE_ROWS = (1024, 256)


def vae_state_to(state, dev):
    """A copy of a ``VAETrainState`` on ``dev``."""
    st = copy.deepcopy(state)
    st.model.to(dev)
    rule = st.opt.rule
    rule.mu, rule.nu = [t.to(dev) for t in rule.mu], [t.to(dev) for t in rule.nu]
    return st


def vae_state_groups(state):
    """(group, tensor) over a VAE state's parameters, BN statistics and moments."""
    model = state.model
    yield from (("params", p) for p in model.parameters())
    yield from (("stats", b) for name, b in model.named_buffers() if "running" in name)
    yield from (("moments", t) for t in (*state.opt.rule.mu, *state.opt.rule.nu))


def vae_state_excess(a, b):
    """The largest ratio of a difference to its allowance under VAE_TOL (1 passes)."""
    worst = 0.0
    for (group, x), (_, y) in zip(vae_state_groups(a), vae_state_groups(b), strict=True):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        rtol, share = VAE_TOL[group]
        allow = rtol * y.abs() + share * float(y.abs().max()) + 1e-30
        worst = max(worst, float(((x - y).abs() / allow).max()))
    return worst


def vae_small_matches_cpu(dev):
    """A small ``VAEConfig`` (the CPU tests' widths) takes 3 steps with given
    dropout masks and eps on the card and on the CPU from one state at count 5
    (warmup 6, cosine 3: the steps cross the warmup's end): losses within
    1e-5 relative, the state within the CPU tests' bounds (``VAE_TOL``)."""
    from rnagan_tpu_torch.core.config import VAEConfig, VAEModelConfig
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    cfg = VAEConfig(model=VAEModelConfig(rna_features=64, z_dim=16, encoder_dims=(48, 32, 16),
                                         decoder_dims=(32, 48)),
                    lr=1e-3, batch_size=8, warmup_steps=6, cosine_steps=3)
    gen = torch.Generator().manual_seed(SEED + 2)
    cpu, card = VAETrainer(cfg, device="cpu"), VAETrainer(cfg, device=dev)
    s_cpu = cpu.init_state()
    for mu, nu in zip(s_cpu.opt.rule.mu, s_cpu.opt.rule.nu):
        mu.copy_(torch.randn(mu.shape, generator=gen) * 1e-3)
        nu.copy_((torch.rand(nu.shape, generator=gen) + 0.5) * 1e-2)
    s_cpu.opt.count = s_cpu.opt.rule.count = s_cpu.step = 5
    s_card = vae_state_to(s_cpu, dev)
    worst_loss = 0.0
    for _ in range(3):
        x = torch.randn(8, 64, generator=gen)
        mask = torch.tensor([1.0] * 6 + [0.0] * 2)
        draws = {"keep": torch.rand(8, 64, generator=gen) < 0.5, "eps": torch.randn(8, 16, generator=gen)}
        _, l_cpu = cpu.train_step(s_cpu, x, mask, draws)
        _, l_card = card.train_step(s_card, x.to(dev), mask.to(dev), draws)
        for k in l_cpu:
            a, b = float(l_cpu[k]), float(l_card[k])
            worst_loss = max(worst_loss, abs(a - b) / abs(a))
    excess = vae_state_excess(s_card, s_cpu)
    check(worst_loss <= 1e-5, f"small VAE steps: card vs CPU losses {worst_loss} relative")
    check(excess <= 1.0, f"small VAE steps: card vs CPU state at {excess} x its tolerance")
    return {"loss_max_rel_diff": worst_loss, "state_excess": excess}


def vae_fwd_bwd_flops(m, batch):
    """Multiply-adds x 2 of one forward and backward of the VAE's GEMMs: the
    forward, then twice it for the backward (input and weight gradients)
    less the first layer's input gradient, which nothing needs."""
    dims = [(m.rna_features, m.encoder_dims[0]), *zip(m.encoder_dims, m.encoder_dims[1:]),
            (m.encoder_dims[-1], m.z_dim), (m.encoder_dims[-1], m.z_dim),
            (m.z_dim, m.decoder_dims[0]), *zip(m.decoder_dims, m.decoder_dims[1:]),
            (m.decoder_dims[-1], m.rna_features)]
    fwd = 2 * batch * sum(a * b for a, b in dims)
    return 3 * fwd - 2 * batch * m.rna_features * m.encoder_dims[0]


def vae_k3_bit_equal(tr, st, x, mask):
    """One full-width step's gradients applied through K3 and through its
    plain version, each from clones of one state, at the step's rate and bias
    corrections: parameters and moments bit-equal."""
    from rnagan_tpu_torch.kernels.fused_adam import adam_update_plain, fused_adam
    from rnagan_tpu_torch.losses.vae import masked_beta_vae_loss
    from rnagan_tpu_torch.optim.adam import bias_corrections

    model, rule = st.model.train(), st.opt.rule
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    out, z_mean, z_logvar = model(x, gen)
    loss = masked_beta_vae_loss(x, out, z_mean, z_logvar, mask, tr.cfg.model.beta)["total_loss"]
    params = [p.detach() for p in model.parameters()]
    grads = list(torch.autograd.grad(loss, list(model.parameters())))
    del out, z_mean, z_logvar, loss
    c1, c2 = bias_corrections(rule.count + 1, rule.b1, rule.b2)
    hp = dict(lr=st.opt.lr(), b1=rule.b1, b2=rule.b2, eps=rule.eps)
    a = [[t.clone() for t in ts] for ts in (params, rule.mu, rule.nu)]
    before = fused_adam.launches
    fused_adam(a[0], grads, a[1], a[2], c1=c1, c2=c2, **hp)
    check(fused_adam.launches == before + 1, "K3 at the VAE's shapes: one launch for 26 tensors")
    b = [[t.clone() for t in ts] for ts in (params, rule.mu, rule.nu)]
    adam_update_plain(b[0], grads, b[1], b[2], c1, c2, **hp)
    torch.cuda.synchronize()
    worst = {name: max(ulps(u, v) for u, v in zip(xs, ys))
             for name, xs, ys in zip(("p", "mu", "nu"), a, b)}
    moved = sum(not torch.equal(u, v) for u, v in zip(a[0], params))
    check(max(worst.values()) == 0, f"K3 at the VAE's shapes differs from its plain version: {worst} ulp")
    check(moved == len(params), f"K3 at the VAE's shapes moved {moved} of {len(params)} tensors")
    err = max(float((u - v).abs().max()) for xs, ys in zip(a, b) for u, v in zip(xs, ys))
    return {"ulps": worst, "max_abs_err": err, "tensors": len(params),
            "params": sum(p.numel() for p in params), "lr": hp["lr"]}


def vae_training(dev, gen):
    """``VAEConfig()`` at full width (19198 -> 6000 -> 4000 -> 2048, z 2048,
    float32, batch 128, Adam through K3 at the warmup+cosine rates).

    The main path: ``fit`` for one epoch on ``VAE_ROWS`` random rows into a
    temporary directory, the K3 counter set to 0 before and read after (one
    launch a train step, none in validation); the best ``.pt`` reloaded
    strictly into a fresh ``BetaVAE`` and handed to a ``GANTrainer`` through
    ``GANConfig(vae_checkpoint=...)`` for one step at batch 8. Then, on a
    state of its own: 10 steps after 3 of warm-up (CUDA events, one K3 launch
    each, none in an eval step), the forward and backward alone, peak memory,
    K3 against its plain version on one step's gradients, and K3's times at
    the VAE's 26 tensors (``k3_timings``)."""
    import tempfile

    from rnagan_tpu_torch import convert
    from rnagan_tpu_torch.core.config import GANConfig, VAEConfig
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.losses.vae import masked_beta_vae_loss
    from rnagan_tpu_torch.models.betavae import BetaVAE
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    cfg = VAEConfig(num_epochs=1)
    m, feats = cfg.model, cfg.model.rna_features
    tr = VAETrainer(cfg, device=dev)
    train = torch.randn(VAE_ROWS[0], feats, generator=gen, device=dev)
    val = torch.randn(VAE_ROWS[1], feats, generator=gen, device=dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        fused_adam.launches = 0
        t0 = time.perf_counter()
        best, res = tr.fit(train, val, save_dir=tmp)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        launches = fused_adam.launches
        steps = VAE_ROWS[0] // cfg.batch_size
        print(f"VAE training path: fit, 1 epoch ({steps} steps + {VAE_ROWS[1] // cfg.batch_size} validation "
              f"batches) in {out['fit_s']:.3f} s; K3 launches {launches}")
        check(launches == steps, f"VAE fit launched K3 {launches} times for {steps} train steps")
        losses = [*res["history"]["train"], *res["history"]["val"]]
        check(all(math.isfinite(v) for ls in losses for v in ls.values()), f"VAE losses not finite: {res}")
        val_means = res["history"]["val"][0]
        check(val_means["total_loss"] == val_means["reconstruction_loss"], "VAE validation total != recons")
        check(res["best_epoch"] == 0 and best.step == steps, f"VAE best epoch {res['best_epoch']}")
        path = os.path.join(tmp, "model_dict_best.pt")
        sd = convert.load_betavae_state_dict(path)
        fresh = BetaVAE(m)
        fresh.load_state_dict(sd, strict=True)
        check(all(torch.equal(sd[k], v.cpu()) for k, v in best.model.state_dict().items()),
              "the best .pt is not the best state")
        gcfg = GANConfig(vae_checkpoint=path)
        gtr = GANTrainer(gcfg, device=dev)
        check(all(torch.equal(v, sd[k].to(dev)) for k, v in gtr.vae.state_dict().items()),
              "GANTrainer's frozen VAE is not the .pt")
        met = gtr.train_step(gtr.init_state(), random_batch(gen, gcfg.batch_size, gcfg, dev))[1]
        gan_metrics = {k: float(v) for k, v in met.items()}  # the GAN state is freed here
        check(all(math.isfinite(v) for v in gan_metrics.values()), f"GAN step on the trained VAE: {gan_metrics}")
        out.update(main_path_launches=launches, history=res["history"], handoff_gan_metrics=gan_metrics)
        del best, gtr, fresh, sd
    del train, val

    gc.collect()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()  # what earlier phases still hold
    st = tr.init_state()
    x = torch.randn(cfg.batch_size, feats, generator=gen, device=dev)
    mask = torch.ones(cfg.batch_size, device=dev)
    for _ in range(3):  # the first at the warmup's lr 0
        tr.train_step(st, x, mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = fused_adam.launches
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        _, last = tr.train_step(st, x, mask)
    end.record()
    end.synchronize()
    out["step_ms_b128"] = start.elapsed_time(end) / 10
    # the training state's own peak: p, g, mu, nu and the step's activations
    out["peak_mem_gib_steps"] = (torch.cuda.max_memory_allocated() - baseline) / 2**30
    check(fused_adam.launches - before == 10, f"10 VAE steps launched K3 {fused_adam.launches - before} times")
    check(all(math.isfinite(float(v)) for v in last.values()), f"VAE step losses {last}")
    before = fused_adam.launches
    eval_losses, _ = tr.eval_step(st, x, mask, torch.Generator(device=dev).manual_seed(1))
    check(fused_adam.launches == before, "an eval step launched K3")
    check(float(eval_losses["total_loss"]) == float(eval_losses["reconstruction_loss"]), "VAE eval total")

    def fwd_bwd():
        out_, zm, zl = st.model.train()(x, torch.Generator(device=dev).manual_seed(2))
        loss = masked_beta_vae_loss(x, out_, zm, zl, mask, m.beta)["total_loss"]
        torch.autograd.grad(loss, list(st.model.parameters()))

    flops = vae_fwd_bwd_flops(m, cfg.batch_size)
    out["fwd_bwd_ms"] = time_ms(fwd_bwd, iters=5, warmup=1)
    out["fwd_bwd_gflop"] = flops / 1e9
    out["fwd_bwd_tflop_per_s"] = flops / out["fwd_bwd_ms"] / 1e9
    out["profile_b128"] = profile_training(lambda: tr.train_step(st, x, mask))
    out["k3_vs_plain"] = vae_k3_bit_equal(tr, st, x, mask)
    shapes = [tuple(p.shape) for p in st.model.parameters()]
    del st
    torch.cuda.empty_cache()
    out["k3"] = k3_timings({"VAE": shapes}, dev, gen)["VAE"]
    out["k3"]["share_of_step"] = out["k3"]["device_ms"] / out["step_ms_b128"]
    print(f"VAE training: step {out['step_ms_b128']:.3f} ms at batch 128 (forward+backward "
          f"{out['fwd_bwd_ms']:.3f} ms, {out['fwd_bwd_tflop_per_s']:.2f} TFLOP/s), K3 device "
          f"{out['k3']['device_ms']:.4f} ms against its {out['k3']['bound_ms']:.4f} ms bound, "
          f"torch.optim.Adam(fused=True) {out['k3']['library_ms']:.4f} ms; peak {out['peak_mem_gib_steps']:.2f} GiB")
    return out


# ------------------------------------------- data plane, FID, JAX checkpoints

#: the corpus of the gan_train phase: slides, tiles a slide, tile size, genes
DATA_SLIDES, DATA_TILES, DATA_TILE, DATA_GENES = 4, 64, 256, 19198
#: reference-layout config keys beside path_csv and patch_data_path: none, so
#: gan_train builds GANConfig()'s and VAEModelConfig()'s full widths
DATA_CONFIG_KEYS = {}
#: images of the Inception checks: card vs CPU, the timed batch, each FID set
INCEPTION_CPU_IMAGES, INCEPTION_BATCH, FID_IMAGES = 4, 64, 256


def write_corpus(root, rng):
    """``DATA_SLIDES`` slide databases of ``DATA_TILES`` random uint8 tiles
    through the port's ``LMDBTileWriter``, an expression CSV (``rna_*``
    columns and ``wsi_file_name``) and a reference-layout JSON config."""
    import numpy as np

    from rnagan_tpu_torch.data.patches import slide_db_path
    from rnagan_tpu_torch.data.store import LMDBTileWriter

    names = [f"GTEX-S{i}.svs" for i in range(DATA_SLIDES)]
    for name in names:
        db = slide_db_path(root, name)
        os.makedirs(os.path.dirname(db))
        with LMDBTileWriter(db) as w:
            for t, tile in enumerate(rng.randint(0, 256, (DATA_TILES, DATA_TILE, DATA_TILE, 3), dtype=np.uint8)):
                w.put_tile(f"{name}_{t}", tile)
    csv = os.path.join(root, "expression.csv")
    with open(csv, "w") as f:
        f.write(",".join([f"rna_{g}" for g in range(DATA_GENES)] + ["wsi_file_name"]) + "\n")
        for name in names:
            f.write(",".join(map(repr, rng.gamma(0.5, 40.0, DATA_GENES).round(3).tolist())) + f",{name}\n")
    config = os.path.join(root, "config.json")
    with open(config, "w") as f:
        json.dump({"path_csv": [csv], "patch_data_path": [root], **DATA_CONFIG_KEYS}, f)
    return config, names


def jax_format_vae(tmp, vae_cfg, vae_sd, genes):
    """The VAE written as a JAX ``model_best.ckpt`` (the port's msgpack
    writer) and as a ``.pt``: ``load_frozen_vae`` of the two bit-equal, and
    their z_mean on the card bit-equal."""
    from rnagan_tpu_torch import convert
    from rnagan_tpu_torch.core.checkpoint import save_bundle, save_state_dict
    from rnagan_tpu_torch.losses.rna_infusion import encode_z_mean
    from rnagan_tpu_torch.models.betavae import BetaVAE
    from rnagan_tpu_torch.train.gan_trainer import load_frozen_vae

    ckpt, pt = os.path.join(tmp, "model_best.ckpt"), os.path.join(tmp, "model_dict_best.pt")
    t0 = time.perf_counter()
    save_bundle(ckpt, convert.betavae_variables_to_jax(vae_cfg, vae_sd), {"config": "betavae"})
    write_s = time.perf_counter() - t0
    save_state_dict(pt, vae_sd)
    t0 = time.perf_counter()
    from_ckpt = load_frozen_vae(ckpt, vae_cfg)
    read_s = time.perf_counter() - t0
    from_pt = load_frozen_vae(pt, vae_cfg)
    os.remove(pt)  # the phase's temporary directory holds ~5 GB of bundles at its peak
    check(set(from_ckpt) == set(from_pt) and all(torch.equal(from_ckpt[k], v) for k, v in from_pt.items()),
          "load_frozen_vae: the JAX bundle's state_dict differs from the .pt's")
    z = []
    for sd in (from_ckpt, from_pt):
        vae = BetaVAE(vae_cfg, device=genes.device)
        vae.load_state_dict(sd)
        with torch.inference_mode():
            z.append(encode_z_mean(vae.eval(), genes))
    check(torch.equal(*z), "encode_z_mean on the card differs between the JAX bundle and the .pt")
    print(f"JAX-format VAE: {os.path.getsize(ckpt) / 2**30:.3f} GiB bundle written in {write_s:.2f} s, "
          f"read by load_frozen_vae in {read_s:.2f} s; bit-equal to the .pt, z_mean on the card too")
    return ckpt, {"bundle_bytes": os.path.getsize(ckpt), "write_s": write_s, "read_s": read_s}


def gan_train_main_path(config, vae_ckpt, tmp, dev):
    """``cli.gan_train.main`` for one epoch on the corpus (the config's
    models, the JAX-format VAE, an FID probe on 128 images), the K1 and K3
    counters set to 0 just before it and read just after: 2 launches each a
    step; the probe's fid finite."""
    from rnagan_tpu_torch.cli import gan_train
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.kernels.infusion import infused_noise

    model_dir = os.path.join(tmp, "models")
    steps = -(-DATA_SLIDES * DATA_TILES // 8)
    torch.cuda.synchronize()
    fused_adam.launches = infused_noise.launches = 0
    t0 = time.perf_counter()
    res = gan_train.main(["--config", config, "--device", str(dev), "--num_epochs", "1",
                          "--num_patches", str(DATA_TILES), "--vae_checkpoint", vae_ckpt,
                          "--fid_every", "1", "--fid_images", "128", "--model_dir", model_dir,
                          "--image_dir", os.path.join(tmp, "images")])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"fused_adam": fused_adam.launches, "infused_noise": infused_noise.launches}
    epoch, data = res["history"][-1], res["data"]
    print(f"gan_train main path: {steps} steps in {main_s:.3f} s, {epoch['step_ms_mean']:.2f} ms a step, "
          f"fid {epoch['fid']:.6g}; load_patch_data {data['tiles']} tiles in {data['load_s']:.3f} s; "
          f"launches {launches}")
    check(launches == {"fused_adam": 2 * steps, "infused_noise": 2 * steps},
          f"gan_train launched {launches} in {steps} steps, expected 2 a step each")
    check(all(math.isfinite(v) for v in epoch.values()), f"gan_train epoch metrics {epoch}")
    check((data["tiles"], data["slides"]) == (DATA_SLIDES * DATA_TILES, DATA_SLIDES), f"gan_train loaded {data}")
    return model_dir, steps, {"main_s": main_s, "launches": launches, "epoch": epoch,
                              "step_ms_mean": epoch["step_ms_mean"], "load_patch_data_s": data["load_s"],
                              "load_patch_data_tiles_per_s": data["tiles"] / data["load_s"]}


def randomize_inception(model, gen):
    """He-scaled kernels and BN away from (1, 0, 0, 1), so features keep their
    scale through the 94 layers (the default init shrinks them to ~1e-4)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.weight, m.running_var):
                    t.copy_(torch.rand(t.shape, generator=gen) * 0.6 + 0.7)
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.randn(t.shape, generator=gen) * 0.1)


def inception_flops(model):
    """2 x multiply-adds of one 299x299 image's convolutions, from their
    output shapes (pools and BatchNorm not counted)."""
    from rnagan_tpu_torch.models.inception import BasicConv2d

    total = []

    def count(mod, inp, out):
        total.append(2 * out[0].numel() * mod.conv.weight[0].numel())

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, BasicConv2d)]
    with torch.inference_mode():
        model(torch.zeros(1, 299, 299, 3))
    for h in hooks:
        h.remove()
    return sum(total)


def inception_checks(dev, gen):
    """InceptionV3 at full width on randomized weights, through
    ``InceptionExtractor``: float32 on the card (TF32 off) against the CPU
    on 4 images, within 1e-3 of max |feature|; bfloat16 against float32,
    correlation > 0.999; images/s at batch 64 in both (CUDA events) beside
    the FLOP count, and a profiled bfloat16 batch. Returns the weights."""
    from rnagan_tpu_torch.eval.fid import InceptionExtractor
    from rnagan_tpu_torch.models.inception import InceptionV3Features

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = InceptionV3Features(dtype="float32")
    randomize_inception(cpu, gen)
    sd = cpu.state_dict()
    flops = inception_flops(cpu)
    exts = {dt: InceptionExtractor(sd, dtype=dt, device=dev) for dt in ("float32", "bfloat16")}
    x = torch.rand(INCEPTION_CPU_IMAGES, 299, 299, 3, generator=gen)
    with torch.inference_mode():
        ref = cpu(x)
    f32, bf16 = (exts[dt].features(x.to(dev)).cpu() for dt in ("float32", "bfloat16"))
    err, scale = float((f32 - ref).abs().max()), float(ref.abs().max())
    corr = float(torch.corrcoef(torch.stack([bf16.flatten(), f32.flatten()]))[0, 1])
    check(err <= 1e-3 * scale, f"Inception float32 card vs CPU: {err} against max |feature| {scale}")
    check(corr > 0.999, f"Inception bfloat16 vs float32 correlation {corr}")
    out = {"gflop_per_image": flops / 1e9, "f32_vs_cpu_max_abs_err": err, "max_abs_feature": scale,
           "bf16_vs_f32_corr": corr}
    xb = torch.rand(INCEPTION_BATCH, 299, 299, 3, generator=gen).to(dev)
    for dt, ext in exts.items():
        ms = time_ms(lambda: ext.features(xb), iters=5, warmup=2)
        out[dt] = {"batch_ms": ms, "images_per_s": INCEPTION_BATCH / ms * 1e3,
                   "tflop_per_s": flops * INCEPTION_BATCH / ms / 1e9}
    out["profile_bf16_batch"] = profile_training(lambda: exts["bfloat16"].features(xb))
    print(f"Inception: card f32 vs CPU max abs {err:.3e} (max |feature| {scale:.3e}), bf16 vs f32 corr "
          f"{corr:.7f}; batch {INCEPTION_BATCH}: " + ", ".join(
              f"{dt} {out[dt]['images_per_s']:.1f} images/s ({out[dt]['tflop_per_s']:.1f} TFLOP/s)"
              for dt in exts) + f"; {flops / 1e9:.4f} GFLOP an image; a profiled bf16 batch: "
          + json.dumps({k: v for k, v in out["profile_bf16_batch"].items() if k != "top_kernels"}))
    return exts["bfloat16"], out


def fid_distance_check(ext, real01, gen):
    """FID of the corpus tiles against as many dark uniform images (in [0,
    0.5]: a distance well away from 0, so the relative gate is not set by
    the rounding of the statistics' null space) through the randomized
    bfloat16 extractor: 2048-d statistics on the card, the float64 eigh
    route there against the scipy route, within 1e-6 relative."""
    from rnagan_tpu_torch.eval.fid import calculate_activation_statistics, calculate_frechet_distance

    fake = torch.rand(real01.shape, generator=gen) * 0.5
    stats = [calculate_activation_statistics(imgs, INCEPTION_BATCH, ext) for imgs in (real01, fake)]
    out = {"images": len(real01)}
    for method in ("eigh", "scipy"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[method] = calculate_frechet_distance(*stats[0], *stats[1], method=method)
        out[f"{method}_s"] = time.perf_counter() - t0
    out["rel_diff"] = abs(out["eigh"] - out["scipy"]) / abs(out["scipy"])
    print(f"FID distance on {len(real01)} images' 2048-d statistics: eigh (card, float64) {out['eigh']:.10g} "
          f"in {out['eigh_s']:.3f} s, scipy {out['scipy']:.10g} in {out['scipy_s']:.3f} s, "
          f"relative difference {out['rel_diff']:.3e}")
    check(math.isfinite(out["eigh"]) and out["rel_diff"] <= 1e-6,
          f"FID eigh vs scipy: {out['eigh']} vs {out['scipy']}")
    return out


def data_fid_checkpoints(dev, vae_cfg, vae_sd):
    """The data plane, FID and the JAX package's checkpoints: the tile-store
    library built; a corpus written; the VAE as a JAX-format bundle; the
    ``gan_train`` epoch (the training CLI's main path); both bundles reloaded;
    InceptionV3 and the FID distance checked; ``compute_representations``
    for 2 patients, K1 launched once for each conditioned generation."""
    import tempfile
    from types import SimpleNamespace

    import numpy as np

    from rnagan_tpu_torch.cli.common import load_gan_dataframe
    from rnagan_tpu_torch.cli.generate import _load_trainer
    from rnagan_tpu_torch.core.config import load_reference_json
    from rnagan_tpu_torch.data import store
    from rnagan_tpu_torch.data.patches import patient_tiles
    from rnagan_tpu_torch.data.rna import Scaler, log_transform
    from rnagan_tpu_torch.eval.fid import InceptionExtractor
    from rnagan_tpu_torch.eval.representation import compute_representations
    from rnagan_tpu_torch.kernels.infusion import infused_noise

    out = {}
    _, out["tilestore_build_s"] = store.build()
    store.native_lib()
    print(f"tile-store library built in {out['tilestore_build_s']:.1f} s")
    rng, gen = np.random.RandomState(SEED), torch.Generator().manual_seed(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        config, names = write_corpus(tmp, rng)
        out["corpus_write_s"] = time.perf_counter() - t0
        genes = torch.randn(8, vae_cfg.rna_features, generator=gen).to(dev)
        vae_ckpt, out["vae_bundle"] = jax_format_vae(tmp, vae_cfg, vae_sd, genes)
        model_dir, steps, out["gan_train"] = gan_train_main_path(config, vae_ckpt, tmp, dev)

        cfg_json = load_reference_json(config)
        args = SimpleNamespace(gan_type=None, seed=99, device=str(dev))
        t0 = time.perf_counter()
        for name in ("gan_best.model", "gan_last.model"):  # the last one stays loaded
            tr, state = _load_trainer(cfg_json, os.path.join(model_dir, name), vae_ckpt, args)
            check(state.step == steps and tr.z_pop is not None, f"{name} reloaded at step {state.step}")
        out["bundles_reload_s"] = time.perf_counter() - t0

        ext_bf16, out["inception"] = inception_checks(dev, gen)
        slides = load_gan_dataframe(cfg_json)
        real = np.concatenate([patient_tiles(slides, p, DATA_TILES, seed=0)[0] for p in names])
        out["fid_distance"] = fid_distance_check(ext_bf16, torch.from_numpy(real[:FID_IMAGES]).float() / 255.0,
                                                 gen)

        vals = log_transform(slides.rna.values)
        slides = slides.with_rna_values(Scaler.fit(vals, "standard").transform(vals))
        patients = names[:2]
        torch.cuda.synchronize()
        infused_noise.launches = 0
        t0 = time.perf_counter()
        reps = compute_representations(
            patients, lambda p: patient_tiles(slides, p, DATA_TILES, seed=1)[0],
            lambda p: patient_tiles(slides, p, 1, seed=1)[1], tr, state, tr, state, seed=5,
            tiles_per_patient=DATA_TILES, extractor=InceptionExtractor(device=dev), condition_mode="population")
        torch.cuda.synchronize()
        out["representations"] = {"s": time.perf_counter() - t0, "k1_launches": infused_noise.launches}
        check(infused_noise.launches == len(patients),
              f"compute_representations launched K1 {infused_noise.launches} times for {len(patients)} patients")
        check(all(v.shape == (len(patients), 2048) and np.isfinite(v).all() for v in reps.values()),
              "representations: shapes or values")
    print(f"representations of {len(patients)} patients x {DATA_TILES} tiles in "
          f"{out['representations']['s']:.3f} s, K1 launches {out['representations']['k1_launches']}")
    return out


# ----------------------------------------------- SAGAN, BigGAN and the CLIs

#: GANModelConfig fields of the full-width SAGAN and BigGAN checks beside
#: their defaults: none, so they run at the CLI's widths
SN_FULL_KEYS = {}
#: phase 9's small configurations, card against CPU: name -> (arch, fields)
SN_SMALL = {"sagan": ("sagan", {}), "biggan": ("biggan", {"num_classes": 2}),
            "biggan_unconditional": ("biggan", {})}


@contextlib.contextmanager
def collected(owner, name):
    """What ``owner.name`` (a module's function, or a class's method) returns
    while the block runs: a command's results while ``cli.main`` dispatches
    to it (the dispatcher itself returns only an exit code), a loop's
    histories."""
    results, original = [], getattr(owner, name)

    def wrapper(*args, **kwargs):
        results.append(original(*args, **kwargs))
        return results[-1]

    setattr(owner, name, wrapper)
    try:
        yield results
    finally:
        setattr(owner, name, original)


def dispatch(argv, module=None):
    """``cli.main.main(argv)``: exit code 0, host seconds, and what the
    command's ``main`` returned when ``module`` is given."""
    from rnagan_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    with collected(module, "main") if module is not None else contextlib.nullcontext([None]) as res:
        rc = cli_main.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"cli.main {argv[0]} exited {rc}")
    return (res[0] if res else None), time.perf_counter() - t0


def sn_sigma_check(dev, gen):
    """30 updating forwards of the full-width SAGAN discriminator: ``Conv_1``'s
    stored sigma within 5 % of its kernel's top singular value (the kernel
    reshaped as flax reshapes it; ``tests/test_attention_gans.py:72-92``)."""
    from rnagan_tpu_torch.core.config import GANModelConfig
    from rnagan_tpu_torch.models.sagan import SAGANDiscriminator, flax_matrix

    m = GANModelConfig(**{"arch": "sagan", "step_channels": 32, "compute_dtype": "float32", **SN_FULL_KEYS})
    d = SAGANDiscriminator(m, seed=3, device=dev)
    x = torch.randn(2, m.out_channels, m.out_size, m.out_size, generator=gen, device=dev)
    stats = d.bn_stats()
    with torch.no_grad():
        for _ in range(30):
            _, stats = d(x, stats, True)
    true = float(torch.linalg.matrix_norm(flax_matrix(d.Conv_1.weight.detach(), "conv"), 2))
    sigma = float(stats[d.Conv_1.slot][1])
    check(abs(sigma - true) <= 0.05 * true, f"SAGAN D Conv_1: stored sigma {sigma}, top singular value {true}")
    return {"sigma": sigma, "top_singular_value": true, "rel_err": abs(sigma - true) / true}


def sn_step_costs(dev, gen, vae_cfg, vae_sd):
    """SAGAN and BigGAN (remat off and on) at the CLI's widths (wganvae,
    bfloat16, batch 8; BigGAN over 2 classes): 5 steps after 2, host clock;
    the peak memory above what was allocated before the trainer was made,
    and above the training state (the activations); 3 steps under
    ``torch.profiler`` (device busy time by category, idle share)."""
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    out = {}
    for name, model in (("sagan", {"arch": "sagan", "step_channels": 32}),
                        ("biggan_remat_off", {"arch": "biggan", "num_classes": 2}),
                        ("biggan_remat_on", {"arch": "biggan", "num_classes": 2, "remat": True})):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cfg = GANConfig(model=GANModelConfig(**{**model, **SN_FULL_KEYS}), vae=vae_cfg)
        tr = GANTrainer(cfg, vae_sd, device=dev)
        st = tr.init_state()
        batch = {**random_batch(gen, cfg.batch_size, cfg, dev, size=cfg.model.out_size),
                 "labels": torch.randint(0, 2, (cfg.batch_size,), generator=gen, device=dev)}
        for _ in range(2):
            tr.train_step(st, batch)
        torch.cuda.synchronize()
        state_bytes = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            metrics = tr.train_step(st, batch)[1]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 5
        peak = torch.cuda.max_memory_allocated() - base
        check(all(math.isfinite(float(v)) for v in metrics.values()), f"{name} step: {metrics}")
        out[name] = {"step_ms_b8": step_ms, "peak_gib": peak / 2**30, "state_gib": state_bytes / 2**30,
                     "activation_peak_gib": (peak - state_bytes) / 2**30,
                     "g_params": sum(p.numel() for p in st.generator.parameters()),
                     "d_params": sum(p.numel() for p in st.discriminator.parameters()),
                     "profile_b8": profile_training(lambda: tr.train_step(st, batch))}
        del tr, st, batch
    print("SAGAN and BigGAN (remat off / on) at batch 8: " + json.dumps(
        {k: {x: y for x, y in v.items() if x != "profile_b8"} | {
            "device_busy_ms": v["profile_b8"].get("device_busy_ms_per_step"),
            "device_idle_share": v["profile_b8"].get("device_idle_share")} for k, v in out.items()}))
    return out


def sn_workspace(tmp, vae_cfg, vae_sd, rng):
    """Phase 8's corpus written again, its expression split over two tissue
    CSVs (half the slides each) so BigGAN has 2 classes; the VAE as a ``.pt``
    with its ``scaler.npz`` and as a JAX-format ``model_best.ckpt`` bundling
    the same scaler; the GAN and VAE JSON configs."""
    from rnagan_tpu_torch import convert
    from rnagan_tpu_torch.core.checkpoint import SCALER_NAME, save_bundle, save_state_dict
    from rnagan_tpu_torch.data.rna import RNATable, Scaler, log_transform

    config, names = write_corpus(tmp, rng)
    with open(config) as f:
        (csv,) = json.load(f)["path_csv"]
    with open(csv) as f:
        header, *rows = f.read().splitlines()
    half = len(rows) // 2
    csvs = []
    for t, part in enumerate((rows[:half], rows[half:])):
        csvs.append(os.path.join(tmp, f"tissue{t}.csv"))
        with open(csvs[-1], "w") as f:
            f.write("\n".join([header, *part]) + "\n")
    gan_json = os.path.join(tmp, "gan2.json")
    with open(gan_json, "w") as f:
        json.dump({"path_csv": csvs, "patch_data_path": [tmp, tmp], **DATA_CONFIG_KEYS}, f)
    vae_dir = os.path.join(tmp, "vae")
    pt, ckpt = os.path.join(vae_dir, "model_dict_best.pt"), os.path.join(vae_dir, "model_best.ckpt")
    scaler = Scaler.fit(log_transform(RNATable.read_csv(csv).values), "standard")
    save_state_dict(pt, vae_sd)
    scaler.save(os.path.join(vae_dir, SCALER_NAME))
    save_bundle(ckpt, {**convert.betavae_variables_to_jax(vae_cfg, vae_sd), "scaler": scaler.state_dict()},
                {"config": "betavae"})
    vae_json = os.path.join(tmp, "vae.json")
    with open(vae_json, "w") as f:
        json.dump({"path_csv": csvs, "rna_features": vae_cfg.rna_features, "z_dim": vae_cfg.z_dim,
                   "encoder_dims": list(vae_cfg.encoder_dims), "decoder_dims": list(vae_cfg.decoder_dims)}, f)
    return {"gan_json": gan_json, "vae_json": vae_json, "csvs": csvs, "names": names, "pt": pt, "ckpt": ckpt}


def sn_gan_train(arch, ws, tmp, dev):
    """``cli.main gan-train --gan_type arch`` for one epoch of the corpus
    (wganvae, the CLI's widths, bfloat16, batch 8; BigGAN over 2 classes),
    the K1 and K3 counters set to 0 just before it and read just after: 2
    launches each a step; peak memory above what earlier phases hold."""
    from rnagan_tpu_torch.cli import gan_train
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.kernels.infusion import infused_noise

    model_dir = os.path.join(tmp, arch)
    steps = -(-DATA_SLIDES * DATA_TILES // 8)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_adam.launches = infused_noise.launches = 0
    res, main_s = dispatch(["gan-train", "--config", ws["gan_json"], "--gan_type", arch, "--device", str(dev),
                            "--num_epochs", "1", "--num_patches", str(DATA_TILES), "--vae_checkpoint", ws["pt"],
                            "--model_dir", model_dir, "--image_dir", os.path.join(tmp, f"{arch}_images")],
                           gan_train)
    launches = {"fused_adam": fused_adam.launches, "infused_noise": infused_noise.launches}
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    epoch = res["history"][-1]
    print(f"gan-train --gan_type {arch}: {steps} steps, {epoch['step_ms_mean']:.2f} ms a step, main "
          f"{main_s:.3f} s, peak {peak_gib:.2f} GiB above earlier phases; launches {launches}")
    check(launches == {"fused_adam": 2 * steps, "infused_noise": 2 * steps},
          f"gan-train {arch} launched {launches} in {steps} steps, expected 2 a step each")
    check(all(math.isfinite(v) for v in epoch.values()), f"gan-train {arch} epoch metrics {epoch}")
    check(os.path.exists(os.path.join(model_dir, "gan_last.model")), f"gan-train {arch} wrote no bundle")
    return os.path.join(model_dir, "gan_last.model"), res["history"], {
        "main_s": main_s, "launches": launches, "steps": steps, "epoch": epoch,
        "step_ms_mean": epoch["step_ms_mean"], "peak_gib": peak_gib}


def sn_clis(ws, bundles, histories, tmp, dev):
    """The other CLIs through ``cli.main``: ``generate`` and ``fid`` on the
    BigGAN bundle (FID finite), ``representation`` for 2 patients on the
    SAGAN bundle, ``sample`` from the ``.pt`` and from the JAX-format VAE
    (equal for one seed), ``interpolate`` on the two-CSV table, and
    ``metrics`` on a JSONL of the two runs' epochs."""
    import io
    import pickle

    import numpy as np

    from rnagan_tpu_torch.cli import fid, generate, representation, sample
    from rnagan_tpu_torch.core.metrics import MetricsLogger

    d, out = str(dev), {}
    vae_common = ["--vae", ws["pt"], "--device", d, "--config", ws["gan_json"]]
    imgs, out["generate_s"] = dispatch(["generate", *vae_common, "--checkpoint", bundles["biggan"],
                                        "--gan_type", "biggan", "--rna_file", ws["csvs"][0], "--random_patient",
                                        "--sample_size", "16", "--save_path", os.path.join(tmp, "gen.png")],
                                       generate)
    check(tuple(imgs.shape[:1] + imgs.shape[3:]) == (16, 3) and bool(torch.isfinite(imgs).all()),
          f"generate: {tuple(imgs.shape)}")
    (fid_mean, _), out["fid_s"] = dispatch(["fid", *vae_common, "--checkpoint", bundles["biggan"],
                                            "--gan_type", "biggan", "--patient1", ws["names"][0],
                                            "--num_images", "64", "--repetitions", "1", "--batch_size", "32"], fid)
    check(math.isfinite(fid_mean), f"fid on the BigGAN bundle: {fid_mean}")
    out["fid"] = fid_mean
    reps_dir = os.path.join(tmp, "reps")
    reps, out["representation_s"] = dispatch(
        ["representation", *vae_common, "--checkpoint", bundles["sagan"], "--checkpoint2", bundles["sagan"],
         "--gan_type", "sagan", "--max_patients", "2", "--tiles_per_patient", "32",
         "--num_patches", str(DATA_TILES), "--save_dir", reps_dir], representation)
    check(all(v.shape == (2, 2048) and np.isfinite(v).all() for v in reps.values())
          and all(os.path.exists(os.path.join(reps_dir, f"representations_{k}.npy")) for k in reps),
          "representation: shapes, values or files")
    expr = []
    for ckpt in (ws["pt"], ws["ckpt"]):
        e, t = dispatch(["sample", "--config", ws["vae_json"], "--checkpoint", ckpt, "--num_samples", "16",
                         "--seed", "3", "--save_path", os.path.join(tmp, "samples.pkl"), "--device", d], sample)
        expr.append(e)
    out["sample_s"] = t
    check(expr[0].shape[0] == 16 and np.isfinite(expr[0]).all() and np.array_equal(*expr),
          "sample: the .pt and the JAX-format VAE differ for one seed")
    interp = os.path.join(tmp, "interp.pkl")
    _, out["interpolate_s"] = dispatch(["interpolate", "--config", ws["vae_json"], "--checkpoint", ws["pt"],
                                        "--save_path", interp, "--device", d])
    with open(interp, "rb") as f:
        report = pickle.load(f)
    check(sorted(report["difference_vectors"]) == [(0, 1), (1, 0)], f"interpolate: {list(report)}")
    jsonl = os.path.join(tmp, "logs")
    logger = MetricsLogger(log_dir=jsonl, run_name="gan")
    for arch, history in histories.items():
        for epoch, means in enumerate(history):
            logger.scalars(arch, means, epoch)
    logger.close()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dispatch(["metrics", os.path.join(jsonl, "gan.jsonl")])
        dispatch(["metrics", os.path.join(jsonl, "gan.jsonl"), "--tag", "biggan", "--metric", "step_ms_mean"])
    shown = buf.getvalue()
    print(shown, end="")
    check("sagan" in shown and "biggan/step_ms_mean" in shown, "metrics printed neither run")
    print("CLIs through cli.main: " + json.dumps(out))
    return out


def attention_gans(dev, gen, vae_cfg, vae_sd):
    """Phase 9: small SAGAN and BigGAN steps card against CPU (BigGAN
    conditional and not, remat bit-equal to plain), the SN sigma check, the
    steps at batch 8 (remat's cost), ``gan-train`` of both archs at the CLI's widths
    through ``cli.main``, and the other CLIs on their bundles."""
    import tempfile

    import numpy as np

    out = {}
    torch.backends.cudnn.deterministic = True
    out["small_vs_cpu"] = {name: train_small_matches_cpu(dev, gen, arch, remat_check=arch == "biggan",
                                                         attn_size=16, embed_dim=8, **kw)
                           for name, (arch, kw) in SN_SMALL.items()}
    out["sn_sigma"] = sn_sigma_check(dev, gen)
    print("SAGAN and BigGAN small steps card vs CPU: " + json.dumps(out))
    torch.backends.cudnn.deterministic = False
    out["steps_b8"] = sn_step_costs(dev, gen, vae_cfg, vae_sd)
    with tempfile.TemporaryDirectory() as tmp:
        ws = sn_workspace(tmp, vae_cfg, vae_sd, np.random.RandomState(SEED + 9))
        bundles, histories = {}, {}
        for arch in ("sagan", "biggan"):
            bundles[arch], histories[arch], out[f"gan_train_{arch}"] = sn_gan_train(arch, ws, tmp, dev)
        out["clis"] = sn_clis(ws, bundles, histories, tmp, dev)
    return out


# ------------------------------------- the ResNet family: ML, SimCLR, fusion

#: the phase's full-width sizes: the CV corpus (tiles, side), the fusion bags
#: (count, side); a CPU rehearsal shrinks them
ML_TILES, ML_SIZE = 512, 224
FUSION_BAGS, FUSION_SIDE = 8, 256
#: MLConfig / SSLConfig / FusionConfig fields beside their defaults, and the
#: SimCLR and fusion backbone (None: ResNet50): none, so full width
ML_KEYS, SSL_KEYS, FUSION_KEYS = {}, {}, {}
BACKBONE = None
#: the tile side of the small card-against-CPU steps: at 64 the last stage's
#: BatchNorm normalizes 2x2 maps, at 32 a 1x1 map of 8 (16 views) values, which
#: amplifies cuDNN's and the CPU's rounding past the CPU tests' bounds
SMALL_SIDE = 64
#: AdamW of MLConfig(): K3's decoupled-decay path at the classifier's rate
ADAMW_HP = dict(lr=3e-5, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
#: group -> (rtol, share of the scale tensor's largest value): the CPU tests'
#: bounds (tests/test_torch_port_resnet.py, test_torch_port_ssl_fusion.py)
RESNET_TOL = {"params": (1e-5, 1e-6), "stats": (1e-5, 1e-6), "moments": (1e-5, 1e-5)}


def resnet_shapes(arch, **kw):
    from rnagan_tpu_torch.models.resnet import ARCHS

    return [tuple(p.shape) for p in ARCHS[arch](device="meta", **kw).parameters()]


def k3_adamw_cases():
    """(name, the parameter shapes one launch takes, AdamW's rate and decay)
    of every AdamW step that phase 10 drives at full width: the classifier
    (``MLConfig``: ResNet50 at 2 classes, and ``--arch resnet152``), SimCLR
    (``SSLConfig``: ResNet50 + the projection) and fusion (``FusionConfig``:
    the trainable tensors only, the RNA encoder's 19,198 x 6,000 kernel among
    them, decay 0: K3's no-decay instantiation with a table of more than 64
    rows)."""
    from rnagan_tpu_torch.core.config import VAEModelConfig
    from rnagan_tpu_torch.models.fusion import FusionModel
    from rnagan_tpu_torch.models.resnet import ARCHS
    from rnagan_tpu_torch.train.fusion_trainer import FusionConfig, trainable_names
    from rnagan_tpu_torch.train.ssl_trainer import SimCLRModel, SSLConfig

    ssl, fusion = SSLConfig(**SSL_KEYS), FusionConfig(**FUSION_KEYS)
    backbone = BACKBONE or ARCHS["resnet50"]
    simclr = SimCLRModel(backbone(num_classes=0, device="meta"), ssl.projection_hidden, ssl.projection_dim,
                         device="meta")
    fused = FusionModel(backbone(num_classes=0, device="meta"), VAEModelConfig().rna_features,
                        fusion.rna_hidden_dims, fusion.num_classes, device="meta")
    trainable = set(trainable_names(fused, fusion.freeze_backbone_early))
    return (("resnet50", resnet_shapes("resnet50", num_classes=2), ADAMW_HP),
            ("resnet152", resnet_shapes("resnet152", num_classes=2), ADAMW_HP),
            ("simclr", [tuple(p.shape) for p in simclr.parameters()],
             ADAMW_HP | {"lr": ssl.lr, "wd": ssl.weight_decay}),
            ("fusion", [tuple(p.shape) for n, p in fused.named_parameters() if n in trainable],
             ADAMW_HP | {"lr": fusion.lr, "wd": fusion.weight_decay}))


def check_k3_adamw(dev, gen):
    """K3 as AdamW against its plain version at the shapes, rate and decay of
    each of ``k3_adamw_cases``, one launch each, float32 mu. Bit-equal."""
    from rnagan_tpu_torch.kernels.fused_adam import adam_update_plain, fused_adam

    out = {}
    for name, shapes, hp in k3_adamw_cases():
        c1, c2 = adam_corrections(6, hp["b1"], hp["b2"])
        a = adam_inputs(shapes, dev, gen, torch.float32)
        b = [[t.clone() for t in ts] for ts in a]
        before = fused_adam.launches
        fused_adam(*a, c1=c1, c2=c2, **hp)
        check(fused_adam.launches == before + 1, f"K3 AdamW at {name}'s {len(shapes)} tensors: not one launch")
        adam_update_plain(*b, c1, c2, **hp)
        torch.cuda.synchronize()
        worst = {m: max(ulps(x, y) for x, y in zip(xs, ys))
                 for m, xs, ys in zip(("p", "mu", "nu"), (a[0], a[2], a[3]), (b[0], b[2], b[3]))}
        err = max(float((x - y).abs().max()) for xs, ys in zip(a, b) for x, y in zip(xs, ys))
        check(max(worst.values()) == 0, f"K3 AdamW at {name}'s shapes differs from its plain version: {worst} ulp")
        out[name] = {"tensors": len(shapes), "params": sum(math.prod(s) for s in shapes), "lr": hp["lr"],
                     "wd": hp["wd"], "ulps": worst, "max_abs_err": err}
        del a, b
        torch.cuda.empty_cache()
    print(f"K3 AdamW vs plain, one launch each: {json.dumps(out)}")
    return out


def k3_adamw_timings(shapes, dev, gen):
    """K3 with decay through its wrapper and replayed from a CUDA graph, its
    plain version, and ``torch.optim.AdamW(fused=True)`` as the yardstick."""
    from rnagan_tpu_torch.kernels.fused_adam import adam_update_plain, fused_adam

    c1, c2 = adam_corrections(6, ADAMW_HP["b1"], ADAMW_HP["b2"])
    a = adam_inputs(shapes, dev, gen, torch.float32)
    params = sum(math.prod(s) for s in shapes)
    call = lambda: fused_adam(*a, c1=c1, c2=c2, **ADAMW_HP)  # noqa: E731
    ps = [torch.nn.Parameter(t.clone()) for t in a[0]]
    for p, g in zip(ps, a[1]):
        p.grad = g
    library = torch.optim.AdamW(ps, lr=ADAMW_HP["lr"], betas=(ADAMW_HP["b1"], ADAMW_HP["b2"]),
                                eps=ADAMW_HP["eps"], weight_decay=ADAMW_HP["wd"], fused=True)
    ms_bound, by = bound_ms(28 * params, 13 * params)  # read p, g, mu, nu; write p, mu, nu
    out = {"params": params, "tensors": len(shapes), "ms": time_ms(call, iters=20),
           "device_ms": graph_ms(call, reps=10, iters=5),
           "plain_ms": time_ms(lambda: adam_update_plain(*a, c1, c2, **ADAMW_HP), iters=5),
           "library_ms": time_ms(library.step, iters=10), "bound_ms": ms_bound, "bound_by": by}
    del a, ps, library
    return out


def resnet_state_to(state, dev):
    """A copy of an ML, SimCLR or fusion training state on ``dev``."""
    st = copy.deepcopy(state)
    st.model.to(dev)
    st.opt.mu, st.opt.nu = [t.to(dev) for t in st.opt.mu], [t.to(dev) for t in st.opt.nu]
    return st


def resnet_state_excess(a, b, names, kernels=None, lr=0.0):
    """The largest ratio of a difference between two states (``a`` on the
    card, ``b`` on the CPU) to its allowance under ``RESNET_TOL``, and where.
    ``kernels`` maps each Dense bias ahead of a train-mode BatchNorm to its
    kernel (the fusion model's ``pre_norm_biases()``, which the CPU tests
    use too). Such a bias's true gradient is 0; what it gets is rounding
    noise of the sums behind its kernel's, which Adam normalizes into moves
    of up to ``lr`` either way on each device. So its moments are held to
    the kernel's scale, as the CPU tests hold them, and the bias to that
    scale plus ``2 * lr``: about the bias's own size after 6 steps, so the
    bias itself is in effect not compared, only its moments are."""
    kernels = kernels or {}
    sa, sb = a.model.state_dict(), b.model.state_dict()

    def ratio(group, x, y, ref, noise=0.0):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        rtol, share = RESNET_TOL[group]
        allow = rtol * y.abs() + share * float(ref.detach().float().abs().max()) + noise + 1e-30
        return float(((x - y).abs() / allow).max())

    found = [(ratio("stats" if "running_" in k else "params", sa[k], y, sb[kernels.get(k, k)],
                    2 * lr if k in kernels else 0.0), k)
             for k, y in sb.items() if not k.endswith("num_batches_tracked")]
    for moment, xs, ys in (("mu", a.opt.mu, b.opt.mu), ("nu", a.opt.nu, b.opt.nu)):
        pool = dict(zip(names, ys))
        found += [(ratio("moments", x, y, pool[kernels.get(name, name)]), f"{moment} {name}")
                  for name, x, y in zip(names, xs, ys, strict=True)]
    return max(found, key=lambda rw: rw[0])


def resnet_small_matches_cpu(dev):
    """Small configurations of the three trainers (a BasicBlock ResNet of one
    block a stage, ``SMALL_SIDE`` tiles, float32, TF32 off, cuDNN
    deterministic), one step each on the card against the same step on the
    CPU from one state with the same draws: the state of 5 steps on the CPU,
    each on a batch of its own (as the CPU tests start from a JAX state of 5
    steps: the moments at the gradients' scale, the loss not yet fitted),
    within the CPU tests' bounds (``RESNET_TOL``), one K3 launch a card step;
    the fusion step's frozen parameters bit-unchanged on the card."""
    import functools

    import numpy as np

    from rnagan_tpu_torch.core.config import MLConfig
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.models.resnet import BasicBlock, ResNet
    from rnagan_tpu_torch.train.fusion_trainer import FusionConfig, FusionTrainer, trainable_names
    from rnagan_tpu_torch.train.ml_experiment import TileClassifierTrainer
    from rnagan_tpu_torch.train.ssl_trainer import SimCLRTrainer, SSLConfig, draw_view

    tiny = functools.partial(ResNet, BasicBlock, (1, 1, 1, 1), compute_dtype="float32")
    rng = np.random.RandomState(SEED + 10)
    cpu_gen = torch.Generator().manual_seed(SEED + 10)
    n, side, genes = 8, SMALL_SIDE, 128
    labels = np.arange(n) % 2
    mask = np.r_[np.ones(n - 1), 0.0].astype(np.float32)
    # six batches: five to reach the compared state, the sixth for the compared step
    images = [rng.rand(n, side, side, 3).astype(np.float32) for _ in range(6)]
    bags = [rng.randint(0, 256, (4, 2, side, side, 3)).astype(np.uint8) for _ in range(6)]
    rna = [rng.randn(4, genes).astype(np.float32) for _ in range(6)]
    cases = {
        "ml": (lambda d: TileClassifierTrainer(MLConfig(batch_size=n, image_size=side),
                                               model=functools.partial(tiny, num_classes=2), device=d),
               lambda tr: tr.init_state(),
               {"flip_h": rng.rand(n) < 0.5, "flip_v": rng.rand(n) < 0.5},
               lambda tr, st, k, draws: tr.train_step(st, images[k], labels, mask, draws=draws)),
        "ssl": (lambda d: SimCLRTrainer(SSLConfig(batch_size=n, image_size=side, projection_hidden=64,
                                                  projection_dim=32), backbone=tiny, device=d),
                lambda tr: tr.init_state(),
                {v: draw_view(n, 0.6, cpu_gen, "cpu") for v in "ab"},
                lambda tr, st, k, draws: tr.train_step(st, images[k], draws=draws)),
        "fusion": (lambda d: FusionTrainer(FusionConfig(rna_hidden_dims=(64, 32)), backbone=tiny, device=d),
                   lambda tr: tr.init_state(bags[0].shape[1:], genes),
                   {"keep": rng.rand(4, genes) < 0.5},
                   lambda tr, st, k, draws: tr.train_step(st, bags[k], rna[k], labels[:4], mask[-4:],
                                                          draws=draws)),
    }
    out = {}
    for name, (make, init, draws, step) in cases.items():
        cpu, card = make("cpu"), make(dev)
        s_cpu = init(cpu)
        for k in range(5):
            step(cpu, s_cpu, k, None)  # the trainer's own draws
        s_card = resnet_state_to(s_cpu, dev)
        frozen = {k: p.detach().clone() for k, p in s_card.model.named_parameters() if not p.requires_grad}
        _, m_cpu = step(cpu, s_cpu, 5, draws)
        before = fused_adam.launches
        _, m_card = step(card, s_card, 5, draws)
        launches = fused_adam.launches - before
        check(launches == 1, f"small {name} step on the card launched K3 {launches} times")
        if name == "fusion":
            names, kernels = trainable_names(s_cpu.model, True), s_cpu.model.pre_norm_biases()
        else:
            names, kernels = [k for k, _ in s_cpu.model.named_parameters()], {}
        excess, where = resnet_state_excess(s_card, s_cpu, names, kernels, lr=cpu.cfg.lr)
        for k in m_cpu:
            a, b = float(m_cpu[k]), float(m_card[k])
            check(abs(a - b) <= 1e-5 * abs(a) + 1e-6, f"small {name} step {k}: CPU {a}, card {b}")
        check(excess <= 1.0, f"small {name} step: card vs CPU state at {excess} x its tolerance ({where})")
        unchanged = all(torch.equal(p, frozen[k]) for k, p in s_card.model.named_parameters() if k in frozen)
        check(unchanged, f"small {name} step moved a frozen parameter on the card")
        out[name] = {"state_excess": excess, "worst": where, "frozen_tensors": len(frozen), "launches": launches,
                     "metrics_card": {k: float(v) for k, v in m_card.items()}}
    print("ResNet family small steps card vs CPU: " + json.dumps(out))
    return out


def drawn_tiles(gen, n, side, dev):
    """``n`` tiles in [0, 1], NHWC, two classes (alternating) apart by a
    shift of the first channel: labels and the float tiles on ``dev``."""
    labels = torch.arange(n, device=dev) % 2
    x = torch.rand(n, side, side, 3, generator=gen, device=dev) * 0.8
    x[..., 0] += 0.2 * labels[:, None, None].float()
    return x, labels


def step_costs(step, batch_images, flop_step=None):
    """A training step's device time (CUDA events over 10 steps after 3), peak
    memory above the state, FLOPs (``FlopCounterMode`` over one step: convs
    and matmuls, forward and backward) and 3 profiled steps."""
    from torch.utils.flop_counter import FlopCounterMode

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step, iters=10, warmup=0)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    with FlopCounterMode(display=False) as fc:
        (flop_step or step)()
    flops = fc.get_total_flops()
    return {"step_ms": ms, "images_per_s": batch_images / ms * 1e3, "step_tflop": flops / 1e12,
            "tflop_per_s": flops / ms / 1e9, "peak_gib_above_state": peak,
            "profile": profile_training(step)}


def ml_full_width(dev, gen):
    """``MLConfig()`` (ResNet50, 224x224, 2 classes, batch 64, bfloat16,
    AdamW through K3): ``run_cv_experiment`` with 2 folds of 1 epoch over
    ``ML_TILES`` drawn tiles, the K3 counter set to 0 before and read after
    (one launch a train step); ``fit_resident`` for one epoch on uint8 tiles
    on the card; then the step's costs."""
    from rnagan_tpu_torch.core.config import MLConfig
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.train import ml_experiment as ml

    cfg = MLConfig(folds=2, num_epochs=1, **ML_KEYS)
    x, y = drawn_tiles(gen, ML_TILES, ML_SIZE, dev)
    images, labels = x.cpu().numpy(), y.cpu().numpy()
    out = {"tiles": ML_TILES, "side": ML_SIZE, "arch": cfg.arch, "batch": cfg.batch_size}
    steps = sum(-(-len(tr_idx) // cfg.batch_size) for tr_idx, _ in ml.stratified_folds(labels, cfg.folds, cfg.seed))
    torch.cuda.synchronize()
    fused_adam.launches = 0
    t0 = time.perf_counter()
    with collected(ml.TileClassifierTrainer, "fit") as fits:
        res = ml.run_cv_experiment(images, labels, cfg, device=dev)
    torch.cuda.synchronize()
    out["cv_s"], out["cv_launches"], out["cv_steps"] = time.perf_counter() - t0, fused_adam.launches, steps
    out["cv"] = res
    history = [h for _, r in fits for h in r["history"]]
    out["cv_history"] = history
    check(out["cv_launches"] == steps, f"run_cv_experiment launched K3 {out['cv_launches']} times in {steps} steps")
    check(len(history) == cfg.folds and all(math.isfinite(h["loss"]) for h in history), f"CV losses {history}")
    del images

    tr = ml.TileClassifierTrainer(cfg, device=dev)
    u8 = (x * 255).to(torch.uint8)
    n_train = ML_TILES * 3 // 4
    fused_adam.launches = 0
    t0 = time.perf_counter()
    st, res = tr.fit_resident(u8[:n_train], y[:n_train], u8[n_train:], y[n_train:].cpu().numpy())
    torch.cuda.synchronize()
    out["resident_s"], out["resident_launches"] = time.perf_counter() - t0, fused_adam.launches
    out["resident_history"] = res["history"]
    check(out["resident_launches"] == n_train // cfg.batch_size,
          f"fit_resident launched K3 {out['resident_launches']} times in {n_train // cfg.batch_size} steps")
    check(math.isfinite(res["history"][0]["loss"]), f"fit_resident loss {res['history']}")
    del u8

    xb, yb = x[:cfg.batch_size], y[:cfg.batch_size]
    ones = torch.ones(cfg.batch_size, device=dev)
    out.update(step_costs(lambda: tr.train_step(st, xb, yb, ones), cfg.batch_size))
    out["params"] = sum(p.numel() for p in st.model.parameters())
    out["tensors"] = len(st.opt.mu)
    del st, tr, x, y
    return out


def ssl_full_width(dev, gen):
    """``SSLConfig()`` (ResNet50 + a 512 -> 128 projection, 224x224, batch
    256 of 2 views each, temperature 0.5, AdamW at 1e-3 and 1e-6): 3 warm-up steps, then 5 with the K3 counter set to 0 before them
    and read after (host clock, one synchronize); the step's costs; the
    backbone handed to a ``TileClassifierTrainer`` that takes a step."""
    from rnagan_tpu_torch.core.config import MLConfig
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.train.ml_experiment import TileClassifierTrainer
    from rnagan_tpu_torch.train.ssl_trainer import SimCLRTrainer, SSLConfig

    cfg = SSLConfig(**SSL_KEYS)
    tr = SimCLRTrainer(cfg, backbone=BACKBONE, device=dev)
    st = tr.init_state()
    x, _ = drawn_tiles(gen, cfg.batch_size, cfg.image_size, dev)
    for _ in range(3):
        tr.train_step(st, x)
    torch.cuda.synchronize()
    fused_adam.launches = 0
    t0 = time.perf_counter()
    metrics = [tr.train_step(st, x)[1] for _ in range(5)]
    torch.cuda.synchronize()
    out = {"batch": cfg.batch_size, "views": 2 * cfg.batch_size, "side": cfg.image_size,
           "step_ms_host": (time.perf_counter() - t0) * 1e3 / 5, "launches": fused_adam.launches,
           "metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
           "params": sum(p.numel() for p in st.model.parameters()), "tensors": len(st.opt.mu)}
    check(out["launches"] == 5, f"5 SimCLR steps launched K3 {out['launches']} times")
    check(all(math.isfinite(m["loss"]) for m in out["metrics"]), f"SimCLR losses {out['metrics']}")
    out.update(step_costs(lambda: tr.train_step(st, x), 2 * cfg.batch_size))
    bv = tr.backbone_variables(st)
    del x
    ml_cfg = MLConfig(batch_size=8, **{k: v for k, v in ML_KEYS.items() if k != "batch_size"})
    cls = TileClassifierTrainer(ml_cfg, backbone_variables=bv, device=dev)
    cst = cls.init_state()
    check(all(torch.equal(cst.model.state_dict()[k], v) for k, v in bv.items()), "the backbone handoff")
    xs, ys = drawn_tiles(gen, 8, ml_cfg.image_size, dev)
    _, m = cls.train_step(cst, xs, ys, torch.ones(8, device=dev))
    out["handoff_loss"] = float(m["loss"])
    check(math.isfinite(out["handoff_loss"]), "the classifier's step on the SimCLR backbone")
    del st, tr, cls, cst, bv
    return out


def fusion_full_width(dev, gen):
    """``FusionConfig()``: the ResNet50 backbone (conv1 .. layer2 frozen) +
    ``RNAEncoder`` (6000, 4000, 2048) over 19,198 genes, batch 4 bags x 40
    tiles of ``FUSION_SIDE``, drawn; ``fit`` for 2 epochs of ``FUSION_BAGS``
    bags with the K3 counter set to 0 before and read after (one launch a
    step, over the trainable tensors only); frozen parameters bit-unchanged
    and the frozen stages' BatchNorm statistics moved; the step's costs."""
    from rnagan_tpu_torch.core.config import VAEModelConfig
    from rnagan_tpu_torch.data.patches import BagData
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.train.fusion_trainer import FusionConfig, FusionTrainer

    cfg = FusionConfig(**FUSION_KEYS)
    genes = VAEModelConfig().rna_features
    tr = FusionTrainer(cfg, backbone=BACKBONE, device=dev)
    bags = torch.randint(0, 256, (FUSION_BAGS, cfg.bag_size, FUSION_SIDE, FUSION_SIDE, 3), generator=gen,
                         device=dev, dtype=torch.uint8).cpu().numpy()
    labels = (torch.arange(FUSION_BAGS) % 2).numpy().astype("int32")
    slide_idx = (torch.arange(FUSION_BAGS) // 2).numpy().astype("int32")
    rna = torch.randn(FUSION_BAGS // 2, genes, generator=gen, device=dev).cpu().numpy()
    data = BagData(bags, labels, slide_idx, [f"S{i}" for i in range(FUSION_BAGS // 2)], rna)
    st = tr.init_state(bags.shape[1:], genes)
    frozen = {k: p.detach().clone() for k, p in st.model.named_parameters() if not p.requires_grad}
    frozen_stats = {k: v.clone() for k, v in st.model.state_dict().items()
                    if k.startswith(("backbone.bn1.", "backbone.layer1.", "backbone.layer2.")) and "running_" in k}
    steps = 2 * -(-FUSION_BAGS // cfg.batch_size)
    torch.cuda.synchronize()
    fused_adam.launches = 0
    t0 = time.perf_counter()
    st, res = tr.fit(data, num_epochs=2, state=st)
    torch.cuda.synchronize()
    out = {"bags": FUSION_BAGS, "bag_size": cfg.bag_size, "side": FUSION_SIDE, "genes": genes,
           "fit_s": time.perf_counter() - t0, "launches": fused_adam.launches, "steps": steps,
           "history": res["history"], "trainable_tensors": len(st.opt.mu), "frozen_tensors": len(frozen),
           "params": sum(p.numel() for p in st.model.parameters()),
           "trainable_params": sum(m.numel() for m in st.opt.mu)}
    print(f"fusion: {out['trainable_tensors']} trainable tensors in K3's table, {out['frozen_tensors']} frozen")
    check(out["launches"] == steps, f"fusion fit launched K3 {out['launches']} times in {steps} steps")
    check(all(math.isfinite(h["loss"]) for h in res["history"]), f"fusion losses {res['history']}")
    moved = [k for k, p in st.model.named_parameters() if k in frozen and not torch.equal(p, frozen[k])]
    check(not moved, f"fusion fit moved frozen parameters {moved[:3]}")
    sd = st.model.state_dict()
    still = [k for k, v in frozen_stats.items() if torch.equal(sd[k], v)]
    check(not still, f"frozen stages' BatchNorm statistics did not move: {still[:3]}")
    xb, rb = bags[:cfg.batch_size], rna[slide_idx[:cfg.batch_size]]
    yb, mb = labels[:cfg.batch_size], torch.ones(cfg.batch_size).numpy()
    out.update(step_costs(lambda: tr.train_step(st, xb, rb, yb, mb), cfg.batch_size * cfg.bag_size))
    del st, tr, data, bags
    return out


def resnet_family(dev, gen):
    """Phase 10: K3's AdamW against its plain version, the small trainers
    card against CPU, and the three trainers at full width."""
    out = {}
    out["k3_adamw_check"] = check_k3_adamw(dev, gen)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out["small_vs_cpu"] = resnet_small_matches_cpu(dev)
    torch.backends.cudnn.deterministic = False
    for name, fn in (("ml", ml_full_width), ("ssl", ssl_full_width), ("fusion", fusion_full_width)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = fn(dev, gen)
        out[name]["phase_s"] = time.perf_counter() - t0
        print(f"{name} at full width: " + json.dumps(
            {k: v for k, v in out[name].items() if k not in ("profile", "cv_history", "history", "metrics")}
            | {"device_busy_ms": out[name]["profile"].get("device_busy_ms_per_step"),
               "device_idle_share": out[name]["profile"].get("device_idle_share")}))
    gc.collect()
    torch.cuda.empty_cache()
    out["k3_resnet50"] = k3_adamw_timings(resnet_shapes("resnet50", num_classes=2), dev, gen)
    return out


def small_config_matches_cpu(dev):
    """A small configuration through the Synthesizer on the card and on the
    CPU (whose plain versions the CPU tests hold against the JAX package)."""
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig
    from rnagan_tpu_torch.eval.generate import Synthesizer
    from rnagan_tpu_torch.models.betavae import BetaVAE
    from rnagan_tpu_torch.models.dcgan import DCGANGenerator

    cfg = GANConfig(model=GANModelConfig(out_size=64, encoding_dims=64, step_channels=8,
                                         compute_dtype="float32"),
                    vae=VAEModelConfig(rna_features=256, z_dim=64, encoder_dims=(128, 96, 64),
                                       decoder_dims=(96, 128)))
    gen = torch.Generator().manual_seed(SEED)
    vae, g = BetaVAE(cfg.vae, seed=3), DCGANGenerator(cfg.model, seed=4)
    randomize(vae, gen)
    randomize(g, gen)
    gene = torch.randn(8, 256, generator=gen)
    u = (torch.rand(8, 64, generator=gen) * 2 - 1) * 0.3
    outs = [Synthesizer(cfg, vae.state_dict(), g.state_dict(), device=d).synthesize(gene, u=u).cpu()
            for d in (dev, "cpu")]
    worst, share = uint8_diff(*outs)
    check(worst <= 1 and share < 0.005, f"small config: card vs CPU {worst} levels on {share}")
    return worst, share


# ------------------------------------------------------------- phase 12: the mesh

#: K1's group mode: (global rows, columns) split over the ranks
K1_GROUP_SHAPES = ((128, 2048), (8, 2048))
#: phase 12's small GAN (the CPU mesh tests' sizes) and its steps
MESH_SMALL_STEPS = 3
#: full-width GANConfig() steps a rank takes: warm-up, then counted and timed
MESH_GAN_STEPS = (1, 3)
#: the classifier's ranks may differ from one rank by this many times the
#: change that reordering the batch makes to one rank's step (``reorder_floor``)
REORDER_FACTOR = 3.0


def mesh_layout():
    """(ranks, backend): one rank a card over NCCL on two or more cards; two
    ranks on the one card over gloo (NCCL refuses two ranks on one device)."""
    cards = torch.cuda.device_count()
    return (cards, "nccl") if cards >= 2 else (2, "gloo")


def mesh_small_config():
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig

    return GANConfig(model=GANModelConfig(encoding_dims=16, out_size=32, step_channels=8, compute_dtype="float32"),
                     vae=VAEModelConfig(rna_features=20, z_dim=16, encoder_dims=(24, 16), decoder_dims=(24,)),
                     batch_size=16, seed=7)


def mesh_small_inputs():
    """The small GAN's frozen VAE and batches, from a fixed seed on the CPU."""
    from rnagan_tpu_torch.models.betavae import BetaVAE

    cfg = mesh_small_config()
    gen = torch.Generator().manual_seed(SEED + 12)
    batches = [{"image": torch.rand(16, 32, 32, 3, generator=gen) * 2 - 1,
                "rna_data": torch.randn(16, 20, generator=gen)} for _ in range(MESH_SMALL_STEPS)]
    return BetaVAE(cfg.vae, seed=3).state_dict(), batches


def mesh_small_steps(dev):
    """``MESH_SMALL_STEPS`` steps of the small wganvae GAN from its seeded
    init with Adam's moments as at step 5 (``warm_adam``: from zero moments
    Adam's first steps are sign(g) * lr, and a gradient near 0 flips sign on
    an ulp), every draw made by the trainer: the metrics and G's first kernel."""
    from rnagan_tpu_torch.parallel.mesh import shard_batch
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    vae_sd, batches = mesh_small_inputs()
    tr = GANTrainer(mesh_small_config(), vae_sd, device=dev)
    st = tr.init_state()
    warm_adam(st, torch.Generator(device=tr.device).manual_seed(SEED + 16))
    metrics = []
    for batch in batches:
        st, met = tr.train_step(st, {k: v.to(tr.device) for k, v in shard_batch(batch, tr.mesh).items()})
        metrics.append({k: float(v) for k, v in met.items()})
    return {"metrics": metrics, "g0": st.generator.model[0][0].weight.detach().cpu()}


def mesh_ml_inputs(order=None):
    """One global batch of ``MLConfig()`` (64 tiles of 224x224, a padded
    row) with its flips, from a fixed seed on the CPU; ``order`` permutes
    its rows (the same step, its sums taken in another order)."""
    from rnagan_tpu_torch.core.config import MLConfig

    cfg = MLConfig()
    gen = torch.Generator().manual_seed(SEED + 13)
    x, labels = drawn_tiles(gen, cfg.batch_size, cfg.image_size, "cpu")
    mask = torch.ones(cfg.batch_size)
    mask[-1] = 0.0
    draws = {"flip_h": torch.rand(cfg.batch_size, generator=gen) < 0.5,
             "flip_v": torch.rand(cfg.batch_size, generator=gen) < 0.5}
    if order is not None:
        x, labels, mask = x[order], labels[order], mask[order]
        draws = {k: v[order] for k, v in draws.items()}
    return cfg, x, labels, mask, draws


def mesh_ml_step(dev, order=None):
    """One ``MLConfig()`` classifier step (ResNet50 at float32, TF32 off) on
    this rank's rows, from the seeded init with AdamW's moments as at step 5
    (``warm_moments``), on ``mesh_ml_inputs(order)``: the global loss and
    accuracy, K3's launches, and the parameters after the step."""
    import functools

    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.models.resnet import resnet50
    from rnagan_tpu_torch.parallel.mesh import shard_batch
    from rnagan_tpu_torch.train.ml_experiment import TileClassifierTrainer

    cfg, x, labels, mask, draws = mesh_ml_inputs(order)
    tr = TileClassifierTrainer(cfg, model=functools.partial(resnet50, num_classes=2, compute_dtype="float32"),
                               device=dev)
    st = tr.init_state()
    warm_moments(st.opt, torch.Generator(device=tr.device).manual_seed(SEED + 17))
    st.step = 5
    x, labels, mask = (t.to(tr.device) for t in shard_batch((x, labels, mask), tr.mesh))
    before = fused_adam.launches
    st, met = tr.train_step(st, x, labels, mask, draws)
    torch.cuda.synchronize()
    params = [p.detach() for p in st.model.parameters()]
    return {k: float(v) for k, v in met.items()} | {"k3_launches": fused_adam.launches - before}, params


def reorder_floor(dev, ref):
    """Per parameter tensor, the largest change that reordering the global
    batch's rows (a seeded permutation, the reversal) makes to a one-rank
    classifier step's result ``ref``: the same step, its sums taken in
    another order. At random init ResNet50's 53 float32 BatchNorms (flax's
    ``E[x^2] - E[x]^2``) make that step ill-conditioned: reordering alone
    moves its BatchNorm biases' gradients by a few per cent of their largest."""
    from rnagan_tpu_torch.core.config import MLConfig

    n = MLConfig().batch_size
    floor = [torch.zeros((), device=dev) for _ in ref]
    shuffled = torch.randperm(n, generator=torch.Generator().manual_seed(SEED + 18))
    for order in (shuffled, torch.arange(n - 1, -1, -1)):
        _, params = mesh_ml_step(dev, order)
        floor = [torch.maximum(f, (p - r).abs().max()) for f, p, r in zip(floor, params, ref)]
    return floor


def params_excess_over(got, ref, floor):
    """The largest ``|got - ref|`` over its allowance, ``1e-5 |ref| + 1e-6 max
    |ref|`` (the CPU mesh tests' bound, ``tests/test_torch_port_mesh_resnet.py::
    _assert_steps_agree``) plus ``REORDER_FACTOR`` times the tensor's
    ``reorder_floor``, over lists of parameters: above 1 fails."""
    check(len(got) == len(ref) == len(floor), f"{len(got)} parameters against {len(ref)}")
    worst = 0.0
    for g, r, f in zip(got, ref, floor):
        allow = 1e-5 * r.abs() + 1e-6 * float(r.abs().max()) + REORDER_FACTOR * f + 1e-30
        worst = max(worst, float(((g.to(r.device) - r).abs() / allow).max()))
    return worst


def k1_group_inputs(n, d):
    gen = torch.Generator().manual_seed(SEED + n)
    return torch.randn(n, d, generator=gen) * 3, (torch.rand(n, d, generator=gen) * 2 - 1) * 0.3


def k1_group_times(dev, group, mesh, n, d):
    """K1's group mode on this rank's rows of a seeded (n, d) global batch:
    the wrapper with its two all-reduces, the three launches alone (from a
    CUDA graph) and the plain version, in ms, and the bound of the launches."""
    from rnagan_tpu_torch.kernels import _build
    from rnagan_tpu_torch.kernels.infusion import infused_noise, infused_noise_group_plain
    from rnagan_tpu_torch.parallel.mesh import local_rows

    z, _ = k1_group_inputs(n, d)
    rows = local_rows(n, mesh)
    zl, m = z[rows].to(dev).contiguous(), rows.stop - rows.start
    lib = _build.library()
    buf, sums, sq = torch.empty(m, d, device=dev), torch.zeros(d + 1, device=dev), torch.zeros(d, device=dev)
    sums[d] = float(n)

    def three_launches():  # the kernel's work without the all-reduces between
        stream = torch.cuda.current_stream().cuda_stream
        for phase in range(3):
            _build.check("group", lib.rnagan_infused_noise_group(
                zl.data_ptr(), d, None, buf.data_ptr(), sums.data_ptr(), sq.data_ptr(), m, d, rows.start, 3,
                0.3, phase, stream))

    out = {"rows_a_rank": m,
           "ms": time_ms(lambda: infused_noise(zl, m, seed=3, group=group, row0=rows.start), iters=20),
           "device_ms": graph_ms(three_launches),  # replayed from a CUDA graph: no host time between launches
           "plain_ms": time_ms(lambda: infused_noise_group_plain(zl, m, group, seed=3, row0=rows.start),
                               iters=20)}
    # this rank's work: z in, out, the three (D,) buffers; ~10 operations an element
    out["bound_ms"], out["bound_by"] = bound_ms(2 * m * d * 4 + 3 * d * 4, 10 * m * d)
    return out


def k1_group_rank(dev, group):
    """K1's group mode on this rank's rows of each ``K1_GROUP_SHAPES`` batch,
    seeded and from given uniforms, against its plain version (gated at 1e-6
    of max |out|); its outputs (the caller holds their concatenation against
    the one-pass kernel on the whole batch); and its times at each shape."""
    from rnagan_tpu_torch.kernels.infusion import infused_noise, infused_noise_group_plain
    from rnagan_tpu_torch.parallel.mesh import local_rows, make_mesh

    mesh = make_mesh(device=dev)
    out = {"outputs": {}, "max_abs_err": {}, "times": {}}
    for n, d in K1_GROUP_SHAPES:
        z, u = k1_group_inputs(n, d)
        rows = local_rows(n, mesh)
        zl, ul, m = z[rows].to(dev), u[rows].to(dev), rows.stop - rows.start
        got = {"seed": infused_noise(zl, m, seed=3, group=group, row0=rows.start),
               "u": infused_noise(zl, m, u=ul, group=group, row0=rows.start)}
        plain = {"seed": infused_noise_group_plain(zl, m, group, seed=3, row0=rows.start),
                 "u": infused_noise_group_plain(zl, m, group, u=ul, row0=rows.start)}
        for k in got:
            err = float((got[k] - plain[k]).abs().max())
            scale = float(plain[k].abs().max())
            check(err <= 1e-6 * scale, f"K1 group {k} at {n}x{d}: {err} against its plain version ({scale})")
            out["max_abs_err"][f"{n}x{d},{k}"] = err
        out["outputs"][f"{n}x{d}"] = {k: v.cpu() for k, v in got.items()}
        out["times"][f"{n}x{d}"] = k1_group_times(dev, group, mesh, n, d)
    return out


class _AllReduceBytes:
    """Counts the bytes ``torch.distributed.all_reduce`` sends from this rank
    (every collective of the port's steps goes through it)."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.inner, self.bytes = dist, dist.all_reduce, 0

    def __enter__(self):
        def counted(tensor, *args, **kwargs):
            self.bytes += tensor.numel() * tensor.element_size()
            return self.inner(tensor, *args, **kwargs)

        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.inner


def replicas_equal(flat, group=None):
    """Whether every rank's ``flat`` is bit-equal to rank 0's (a broadcast of
    rank 0's copy, each rank's verdict summed over the group)."""
    import torch.distributed as dist

    ref = flat.clone()
    dist.broadcast(ref, src=0, group=group)
    bad = torch.tensor([0.0 if torch.equal(ref, flat) else 1.0], device=flat.device)
    dist.all_reduce(bad, group=group)
    return float(bad) == 0.0


def mesh_gan_full_width(dev):
    """``GANConfig()`` (wganvae, bfloat16) at full width, global batch 8 split
    over the ranks: the K1 group-mode, one-pass and K3 launch counters set to 0
    before the counted steps and read after (the main path of this phase),
    the step time and the bytes all-reduced a step, finite losses, and every
    rank's parameters bit-equal to rank 0's."""
    from rnagan_tpu_torch.core.config import GANConfig, VAEModelConfig
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.kernels.infusion import infused_noise
    from rnagan_tpu_torch.models.betavae import BetaVAE
    from rnagan_tpu_torch.parallel.mesh import shard_batch
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    cfg = GANConfig()
    tr = GANTrainer(cfg, BetaVAE(VAEModelConfig(), seed=SEED, device=dev).state_dict(), device=dev)
    st = tr.init_state()
    gen = torch.Generator().manual_seed(SEED + 14)
    batches = [shard_batch(random_batch(gen, cfg.batch_size, cfg, "cpu"), tr.mesh)
               for _ in range(sum(MESH_GAN_STEPS))]
    batches = [{k: v.to(tr.device) for k, v in b.items()} for b in batches]
    for b in batches[:MESH_GAN_STEPS[0]]:
        tr.train_step(st, b)
    torch.cuda.synchronize()
    infused_noise.launches = infused_noise.group_launches = fused_adam.launches = 0
    with _AllReduceBytes() as reduced:
        t0 = time.perf_counter()
        metrics = [tr.train_step(st, b)[1] for b in batches[MESH_GAN_STEPS[0]:]]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / MESH_GAN_STEPS[1]
    steps = MESH_GAN_STEPS[1]
    launches = {"infused_noise_group": infused_noise.group_launches, "infused_noise": infused_noise.launches,
                "fused_adam": fused_adam.launches}
    check(launches == {"infused_noise_group": 6 * steps, "infused_noise": 0, "fused_adam": 2 * steps},
          f"mesh GAN launches {launches} in {steps} steps: expected K1's group kernel 3 a call, 2 calls a "
          "step, and K3 2 a step")
    last = {k: float(v) for k, v in metrics[-1].items()}
    check(all(math.isfinite(float(v)) for m in metrics for v in m.values()), f"mesh GAN losses: {last}")
    flat = torch.cat([p.detach().reshape(-1) for p in (*st.generator.parameters(), *st.discriminator.parameters())])
    equal = replicas_equal(flat)
    check(equal, "mesh GAN: a rank's parameters differ from rank 0's")
    return {"step_ms": step_ms, "all_reduce_bytes_per_step": reduced.bytes / steps, "launches": launches,
            "rows_a_rank": cfg.batch_size // tr.mesh.data, "last_metrics": last, "replicas_bit_equal": equal,
            "params": flat.numel()}


def _shard_rows(model, name):
    """The rows of a one-device tensor that a model-split parameter or buffer
    ``name`` of ``model`` holds (all of them when its module is not split)."""
    owner = model.get_submodule(name.rpartition(".")[0]) if "." in name else model
    split = getattr(owner, "model_split", None)
    if split is None:
        return slice(None)
    j, size = split
    k = getattr(owner, "out_features", None) or owner.num_features
    return slice(j * k, (j + 1) * k)


def mesh_vae_grid(dev):
    """``VAEConfig()`` at full width on a (ranks/2 x 2) grid, (1 x 2) on one
    card: every Linear whose width divides 2 split column-wise. One step on
    the global batch of 128 (float32, TF32 off, given dropout mask and eps,
    Adam moments as at step 5) against a one-rank step of the same state in
    this process: each rank's shards within the VAE phase's bounds
    (``VAE_TOL``) of their rows of the one-rank state, and the gathered
    state_dict against the one-rank one; one K3 launch a rank."""
    from rnagan_tpu_torch.core.config import MeshConfig, VAEConfig
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.parallel.mesh import Mesh, local_rows
    from rnagan_tpu_torch.train.vae_trainer import VAETrainer

    one_cfg = MeshConfig(data=1, model=1)
    one = VAETrainer(VAEConfig(mesh=one_cfg), mesh=Mesh(one_cfg, 1, 0, 1, 1, 0, 0, None, None, torch.device(dev)))
    grid = VAETrainer(VAEConfig(mesh=MeshConfig(model=2)), device=dev)
    s1, s2 = one.init_state(), grid.init_state()
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    for mu, nu in zip(s1.opt.rule.mu, s1.opt.rule.nu):
        mu.copy_(torch.randn(mu.shape, generator=gen, device=dev) * 1e-3)
        nu.copy_((torch.rand(nu.shape, generator=gen, device=dev) + 0.5) * 1e-2)
    names = [n for n, _ in s2.model.named_parameters()]
    for name, mu2, nu2, mu1, nu1 in zip(names, s2.opt.rule.mu, s2.opt.rule.nu, s1.opt.rule.mu, s1.opt.rule.nu):
        rows = _shard_rows(s2.model, name)
        mu2.copy_(mu1[rows])
        nu2.copy_(nu1[rows])
    for s in (s1, s2):
        s.opt.count = s.opt.rule.count = s.step = 5
    m = VAEConfig().model
    x = torch.randn(128, m.rna_features, generator=gen, device=dev)
    mask = torch.ones(128, device=dev)
    draws = {"keep": torch.rand(128, m.rna_features, generator=gen, device=dev) < 0.5,
             "eps": torch.randn(128, m.z_dim, generator=gen, device=dev)}
    _, l1 = one.train_step(s1, x, mask, draws)
    before = fused_adam.launches
    rows = local_rows(len(x), grid.mesh)
    _, l2 = grid.train_step(s2, x[rows], mask[rows], draws)
    torch.cuda.synchronize()
    launches = fused_adam.launches - before
    check(launches == 1, f"VAE grid step launched K3 {launches} times")
    worst = 0.0
    full1 = dict(s1.model.named_parameters()) | dict(s1.model.named_buffers())
    groups = [("params", n, t) for n, t in s2.model.named_parameters()] + [
        ("stats", n, t) for n, t in s2.model.named_buffers() if "running" in n]
    groups += [("moments", n, t) for n, t in zip(names, s2.opt.rule.mu)]
    ref_mu = dict(zip([n for n, _ in s1.model.named_parameters()], s1.opt.rule.mu))
    for group, name, t in groups:
        y = (ref_mu[name] if group == "moments" else full1[name])[_shard_rows(s2.model, name)].detach()
        rtol, share = VAE_TOL[group]
        allow = rtol * y.abs() + share * float(y.abs().max()) + 1e-30
        worst = max(worst, float(((t.detach() - y).abs() / allow).max()))
    check(worst <= 1.0, f"VAE grid step: shards at {worst} x their tolerance of the one-rank step")
    gathered = grid.full_state_dict(s2)
    ref_sd = s1.model.state_dict()
    gathered_worst = 0.0
    for k, v in gathered.items():
        y = ref_sd[k].float()
        allow = 1e-5 * y.abs() + 1e-6 * float(y.abs().max()) + 1e-30
        gathered_worst = max(gathered_worst, float(((v.float() - y).abs() / allow).max()))
    check(gathered_worst <= 1.0, f"VAE grid: gathered state at {gathered_worst} x its tolerance")
    loss_diff = max(abs(float(l1[k]) - float(l2[k])) / abs(float(l1[k])) for k in l1)
    check(loss_diff <= 1e-5, f"VAE grid losses {loss_diff} relative from the one-rank step")
    first = tuple(s2.model.encoder.encoder[1][0].weight.shape)
    return {"state_excess": worst, "gathered_excess": gathered_worst, "loss_max_rel_diff": loss_diff,
            "first_linear_shard": first, "k3_launches": launches}


def mesh_rank(rank, world):
    """Phase 12 on one rank (``parallel.launch.spawn``): K1's group mode, the
    small GAN, the full-width GAN, the VAE grid and the classifier step."""
    import torch.distributed as dist

    from rnagan_tpu_torch.parallel.mesh import make_mesh

    dev = make_mesh(device="cuda").device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {"device": str(dev)}
    t0 = time.perf_counter()
    out["k1_group"] = k1_group_rank(dev, dist.group.WORLD)
    out["small_gan"] = mesh_small_steps(dev)
    out["times_s"] = {"k1_and_small": time.perf_counter() - t0}
    torch.backends.cudnn.deterministic = False
    t0 = time.perf_counter()
    out["gan_full_width"] = mesh_gan_full_width(dev)
    out["times_s"]["gan_full_width"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    out["vae_grid"] = mesh_vae_grid(dev)
    out["times_s"]["vae_grid"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["ml"], params = mesh_ml_step(dev)
    out["ml"]["replicas_bit_equal"] = replicas_equal(torch.cat([p.reshape(-1) for p in params]))
    if rank == 0:  # the caller holds them against a one-rank step
        out["ml_params"] = [p.cpu() for p in params]
    out["times_s"]["ml"] = time.perf_counter() - t0
    return out


def mesh_phase(dev):
    """Phase 12: the mesh on the card. ``mesh_layout``'s ranks run
    ``mesh_rank``; this process runs the one-rank references on ``dev`` (the
    one-pass K1 on each whole batch, the small GAN's steps, the classifier's
    step) and holds the ranks against them: K1's group outputs concatenated
    within 1e-6 of max |out|, the small GAN at the CPU mesh tests'
    tolerances (metrics rtol 5e-3, atol 2e-5 growing tenfold a step; G's
    first kernel 5e-4), the classifier's loss 1e-5 relative (the CPU
    tests' bound) and its parameters after the step within the CPU tests'
    bound plus ``REORDER_FACTOR`` times what reordering the batch changes
    in one rank's step (``params_excess_over``)."""
    from rnagan_tpu_torch.kernels.infusion import infused_noise
    from rnagan_tpu_torch.parallel.launch import spawn

    world, backend = mesh_layout()
    where = f"{world} ranks on cuda:0 over gloo" if backend == "gloo" else f"{world} ranks, one a card, over nccl"
    print(f"phase 12: the mesh on the card: {where}" + (
        " (one card: every collective goes through the host, so these times say nothing of multi-card "
        "scaling)" if backend == "gloo" else ""))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # as in the ranks
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.perf_counter()
    ranks = spawn(mesh_rank, world, backend=backend, timeout=600)
    spawn_s = time.perf_counter() - t0
    print(f"phase 12 ranks done in {spawn_s:.1f} s; rank 0: " + json.dumps(
        {k: v for k, v in ranks[0].items() if k not in ("k1_group", "small_gan", "ml_params")}
        | {"k1_group": {k: v for k, v in ranks[0]["k1_group"].items() if k != "outputs"}}))
    out = {"ranks": world, "backend": backend, "spawned_world_s": spawn_s,
           "times_s_rank0": ranks[0]["times_s"]}
    k1 = {}
    for n, d in K1_GROUP_SHAPES:
        z, u = k1_group_inputs(n, d)
        ref = {"seed": infused_noise(z.to(dev), n, seed=3), "u": infused_noise(z.to(dev), n, u=u.to(dev))}
        for k, r in ref.items():
            got = torch.cat([o["k1_group"]["outputs"][f"{n}x{d}"][k] for o in ranks]).to(dev)
            err, scale = float((got - r).abs().max()), float(r.abs().max())
            check(err <= 1e-6 * scale, f"K1 group {k} at {n}x{d}: {err} from the one-pass kernel ({scale})")
            k1[f"{n}x{d},{k}"] = err
    out["k1_group"] = {"vs_one_pass_max_abs_err": k1,
                       "vs_plain_max_abs_err": max(max(o["k1_group"]["max_abs_err"].values()) for o in ranks),
                       "times": ranks[0]["k1_group"]["times"]}
    ref = mesh_small_steps(dev)
    for step, (a, b) in enumerate(zip(ref["metrics"], ranks[0]["small_gan"]["metrics"])):
        for k in a:
            check(abs(a[k] - b[k]) <= 5e-3 * abs(a[k]) + 2e-5 * 10**step,
                  f"mesh small GAN step {step} {k}: world 1 {a[k]}, world {world} {b[k]}")
    g0_diff = float((ranks[0]["small_gan"]["g0"] - ref["g0"]).abs().max())
    check(g0_diff <= 5e-4, f"mesh small GAN: G's first kernel {g0_diff} from world 1")
    check(all(o["small_gan"]["metrics"] == ranks[0]["small_gan"]["metrics"] for o in ranks),
          "mesh small GAN: the ranks' metrics differ")
    out["small_gan"] = {"g0_max_abs_diff": g0_diff, "metrics_world1": ref["metrics"],
                        "metrics_mesh": ranks[0]["small_gan"]["metrics"]}
    out["gan_full_width"] = ranks[0]["gan_full_width"]
    out["vae_grid"] = [o["vae_grid"] for o in ranks]
    ml_ref, ref_params = mesh_ml_step(dev)
    ml = ranks[0]["ml"]
    loss_diff = abs(ml["loss"] - ml_ref["loss"]) / abs(ml_ref["loss"])
    check(loss_diff <= 1e-5, f"mesh classifier loss {ml['loss']} vs world 1 {ml_ref['loss']}")
    params_excess = params_excess_over(ranks[0]["ml_params"], ref_params, reorder_floor(dev, ref_params))
    check(params_excess <= 1.0, f"mesh classifier: parameters after the step at {params_excess} x their "
          "tolerance of world 1's")
    check(all(o["ml"]["replicas_bit_equal"] and o["ml"]["k3_launches"] == 1 for o in ranks),
          "mesh classifier: replicas differ or K3 did not launch once")
    out["ml"] = {"loss_rel_diff": loss_diff, "params_excess": params_excess, "world1": ml_ref, "mesh": ml}
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 12 done in {out['phase_s']:.1f} s: " + json.dumps(out))
    return out


# ------------------------------------ phase 13: the synthetic corpus and export

#: phase 13's corpus: ``SyntheticCorpus`` at the quality run's widths (19,198
#: genes, 256x256 tiles), its scale cut from 200 slides x 600 tiles
SYN_SLIDES, SYN_TILES, SYN_GENES, SYN_SIZE, SYN_BATCH = 16, 64, 19198, 256, 32
#: the quality run, cut: VAE pre-train epochs, GAN steps of its one epoch
#: (of 32), FID images a side (of 512)
QUALITY_VAE_EPOCHS, QUALITY_STEPS, QUALITY_FID_N = 2, 16, 128
#: the quality run's knobs never run on the card before (ROADMAP A22), as
#: small steps against the CPU: (arch, GANConfig fields, GANModelConfig fields, steps)
A22_CASES = (("dcgan", {"compat_reference_gp": True}, {}, 1),
             ("dcgan", {"n_critic": 2}, {}, 2),
             ("dcgan", {"g_ema_decay": 0.999}, {}, 1),
             ("dcgan", {}, {"critic": "projection"}, 1),
             ("dcgan_up", {}, {"out_size": 64}, 1),
             ("condgan", {}, {"out_size": 64}, 1))


def tool(name):
    """``tools/<name>.py``, imported from the checkout (the tools import one
    another by name, so their directory goes on the path)."""
    import importlib

    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def render_card_vs_cpu(dev):
    """The corpus on the card and on the CPU: the same Philox words for a
    batch's tiles and the same batch ids, pixels within 1e-5; the render's
    device time (CUDA events) at batch 32 and 64, its host time to enqueue,
    its launches and device busy share (profiler) and its peak memory."""
    from rnagan_tpu_torch.data import synthetic as syn

    t0 = time.perf_counter()
    card = syn.SyntheticCorpus(SYN_SLIDES, SYN_TILES, SYN_GENES, SYN_SIZE, device=dev)
    cpu = syn.SyntheticCorpus(SYN_SLIDES, SYN_TILES, SYN_GENES, SYN_SIZE, device="cpu")
    torch.cuda.synchronize()
    out = {"corpora_s": time.perf_counter() - t0}
    sl, ti = cpu.batch_ids(SEED, SYN_BATCH)
    sl_card, ti_card = card.batch_ids(SEED, SYN_BATCH)
    check(torch.equal(sl_card.cpu(), sl) and torch.equal(ti_card.cpu(), ti), "batch ids differ card vs CPU")
    sl, ti = sl[0], ti[0]
    ids = ti + sl * cpu.id_stride
    slots = [(slot, math.prod(shape) + math.prod(shape) % 2)
             for slot, shape, _ in syn.tile_draw_spec(SYN_SIZE, 96).values()]
    words_card = syn.philox_words(card.seed, syn.STREAM_RENDER, ids.to(dev), slots)
    words_cpu = syn.philox_words(cpu.seed, syn.STREAM_RENDER, ids, slots)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(words_card, words_cpu)), "Philox words differ card vs CPU")
    del words_card, words_cpu
    tiles_card = card.render(sl, ti)
    t0 = time.perf_counter()
    tiles_cpu = cpu.render(sl, ti)
    out["cpu_render_s_b32"] = time.perf_counter() - t0
    err = float((tiles_card.cpu() - tiles_cpu).abs().max())
    check(tiles_card.shape == (SYN_BATCH, SYN_SIZE, SYN_SIZE, 3) and err <= 1e-5,
          f"card render vs CPU: {err} (shape {tuple(tiles_card.shape)})")
    out.update(pixels_max_abs_err=err,
               latents_max_abs_diff=float((card.slides.s.cpu() - cpu.slides.s).abs().max()),
               expression_max_rel_diff=float(((card.expression.cpu() - cpu.expression).abs()
                                              / cpu.expression.abs().clamp(min=1e-6)).max()))
    del tiles_cpu, cpu
    sl64, ti64 = (t[0] for t in card.batch_ids(SEED + 1, 64))
    out["ms_b32"] = time_ms(lambda: card.render(sl, ti), iters=10)
    out["ms_b64"] = time_ms(lambda: card.render(sl64, ti64), iters=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        card.render(sl, ti)
    out["host_enqueue_ms_b32"] = (time.perf_counter() - t0) * 1e3 / 5
    torch.cuda.synchronize()
    prof = profile_training(lambda: card.render(sl, ti), steps=3)
    out["profile_b32"] = {k: prof.get(k) for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                                                   "device_idle_share", "launches_per_step")}
    for n, (s, t) in ((32, (sl, ti)), (64, (sl64, ti64))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        card.render(s, t)
        torch.cuda.synchronize()
        out[f"peak_mib_b{n}"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"phase 13 render: {json.dumps(out)}")
    return out


def quality_run_cut(dev, tmp, render_ms):
    """``tools/quality_run_torch.py``'s functions at full width, cut: the
    corpus, the expression normalized on the host, the full-width beta-VAE
    (bfloat16) pre-trained ``QUALITY_VAE_EPOCHS`` epochs, then for wganvae
    and wgan a ``GANConfig`` ``dcgan`` at 256x256, batch 32, through
    ``GANTrainer.fit``: 2 warm-up steps, then one epoch of ``QUALITY_STEPS``
    steps with the FID probe (``QUALITY_FID_N`` images a side) as its
    ``eval_fn``, the K1 and K3 counters set to 0 before it and read when the
    probe starts. wganvae launches K1 and K3 twice a step (D and G stages),
    wgan K3 twice and K1 never. Returns the records and the wganvae trainer
    and state."""
    from rnagan_tpu_torch.kernels.fused_adam import fused_adam
    from rnagan_tpu_torch.kernels.infusion import infused_noise
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    q = tool("quality_run_torch")

    def args_for(loss_type):
        return q.parse_args(["--loss_type", loss_type, "--slides", str(SYN_SLIDES), "--tiles_per_slide",
                             str(SYN_TILES), "--genes", str(SYN_GENES), "--size", str(SYN_SIZE), "--batch",
                             str(SYN_BATCH), "--vae_epochs", str(QUALITY_VAE_EPOCHS), "--fid_n",
                             str(QUALITY_FID_N), "--fid_batch", "64", "--epochs", "1", "--no_ckpt",
                             "--workdir", tmp, "--device", str(dev)])

    out = {"cuts": {"slides": f"{SYN_SLIDES} of 200", "tiles_per_slide": f"{SYN_TILES} of 600",
                    "vae_epochs": f"{QUALITY_VAE_EPOCHS} of 200", "epochs": "1 of 24 (wganvae) / 39 (wgan)",
                    "steps_per_epoch": f"{QUALITY_STEPS} of {SYN_SLIDES * SYN_TILES // SYN_BATCH}",
                    "fid_n": f"{QUALITY_FID_N} of 512"}}
    args = args_for("wganvae")
    t0 = time.perf_counter()
    corpus = q.build_corpus(args, dev)
    expr_norm, _ = q.normalized_expression(corpus)
    out["corpus_and_normalization_s"] = time.perf_counter() - t0
    vae_sd, vae_cfg, out["vae_pretrain_s"] = q.train_vae(args, expr_norm, dev)
    check(vae_cfg.rna_features == SYN_GENES and vae_cfg.compute_dtype == "bfloat16", f"VAE config {vae_cfg}")
    kept = None
    for loss_type in ("wganvae", "wgan"):
        a = args_for(loss_type)
        cfg = q.make_config(a, vae_cfg)
        tr = GANTrainer(cfg, vae_sd if loss_type == "wganvae" else None, device=dev)
        expr_dev = torch.as_tensor(expr_norm).to(dev) if loss_type == "wganvae" else None
        t0 = time.perf_counter()
        probe = q.make_fid_probe(tr, corpus, expr_dev, a)
        torch.cuda.synchronize()
        rec = {"fid_setup_s": time.perf_counter() - t0, "fid_floor_real_vs_real": probe.floor}
        state, _ = tr.fit(lambda _e: corpus.batches(1000, a.batch, 2, cfg.seed, expr_dev), num_epochs=1,
                          state=tr.init_state())  # warm-up: cuDNN's first calls
        seen = {}

        def fid_probe(_epoch, st, _tr, probe=probe):
            torch.cuda.synchronize()
            seen["train"] = {"infused_noise": infused_noise.launches, "fused_adam": fused_adam.launches}
            t1 = time.perf_counter()
            fid = probe(st, 0)
            torch.cuda.synchronize()
            seen["fid_s"] = time.perf_counter() - t1
            seen["probe"] = {"infused_noise": infused_noise.launches - seen["train"]["infused_noise"]}
            return {"fid": fid}

        torch.cuda.synchronize()
        infused_noise.launches = fused_adam.launches = 0
        state, res = tr.fit(lambda _e: corpus.batches(0, a.batch, QUALITY_STEPS, cfg.seed, expr_dev),
                            num_epochs=1, state=state, eval_fn=fid_probe, eval_every=1, keep_best_metric="fid")
        rec.update(q.epoch_record(res["history"][0], 0, QUALITY_STEPS, seen["fid_s"]))
        per_step = 2 if loss_type == "wganvae" else 0
        want = {"infused_noise": per_step * QUALITY_STEPS, "fused_adam": 2 * QUALITY_STEPS}
        check(seen["train"] == want, f"quality run {loss_type}: launches {seen['train']}, expected {want}")
        if loss_type == "wgan":
            check(seen["probe"]["infused_noise"] == 0, f"wgan FID probe launched K1 {seen['probe']}")
        values = [rec["d_loss"], rec["g_loss"], rec["gp"], rec["fid"], probe.floor]
        check(all(math.isfinite(v) for v in values) and "best" in res, f"quality run {loss_type}: {rec}")
        check(state.step == 2 + QUALITY_STEPS, f"quality run {loss_type}: step {state.step}")
        rec.update(launches=seen["train"], probe_launches=seen["probe"], render_ms_b32=render_ms,
                   render_share_of_step=render_ms / rec["step_ms"])
        out[loss_type] = rec
        print(f"phase 13 quality run, {loss_type}: " + json.dumps(rec))
        if loss_type == "wganvae":
            kept = (tr, state)
        del probe, res
        torch.cuda.empty_cache()
    return out, kept


def export_round_trip(dev, tr, state, tmp):
    """The quality run's wganvae state through ``state_to_jax`` ->
    ``save_bundle`` -> ``load_bundle`` -> ``state_from_jax``: every tensor,
    count and the step bit-equal. Then ``cli/export_torch.py`` from that
    bundle to a torchgan ``.model`` and from the ``.model`` back to a
    native bundle: G's eval output on fixed noise from each, loaded through
    ``GANTrainer.load_model``, equal to the state's."""
    from types import SimpleNamespace

    from rnagan_tpu_torch.cli import export_torch
    from rnagan_tpu_torch.cli.generate import _load_trainer
    from rnagan_tpu_torch.core.checkpoint import load_bundle, save_bundle

    out = {}
    native = os.path.join(tmp, "gan_state.msgpack")
    t0 = time.perf_counter()
    save_bundle(native, tr.state_to_jax(state), {"epoch": 0})
    out["state_to_jax_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = tr.state_from_jax(load_bundle(native)[0])
    out["load_state_from_jax_s"] = time.perf_counter() - t0
    unequal = [group for group, x, y in state_pairs(state, back) if not torch.equal(x, y.to(x.device))]
    check(not unequal and back.step == state.step and back.g_opt.count == state.g_opt.count
          and back.d_opt.count == state.d_opt.count,
          f"native round trip: {len(unequal)} tensors differ ({sorted(set(unequal))}), step {back.step}")
    out["bundle_mib"] = os.path.getsize(native) / 2**20
    del back
    m = tr.cfg.model
    config = os.path.join(tmp, "export.json")
    cfg_json = {"img_size": m.out_size, "encoding_dims": m.encoding_dims, "step_channels": m.step_channels,
                "compute_dtype": m.compute_dtype}
    with open(config, "w") as f:
        json.dump(cfg_json, f)
    torchgan, native_again = os.path.join(tmp, "gan.model"), os.path.join(tmp, "gan_again.msgpack")
    t0 = time.perf_counter()
    export_torch.main(["--config", config, "--checkpoint", native, "--out", torchgan, "--device", str(dev)])
    export_torch.main(["--config", config, "--checkpoint", torchgan, "--out", native_again, "--to_native",
                       "--device", str(dev)])
    out["export_torch_both_s"] = time.perf_counter() - t0
    noise = torch.randn(8, m.encoding_dims, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)

    @torch.no_grad()
    def g_out(st):
        return st.generator.forward_stats(noise, st.g_stats, False)[0]

    g_out(state)  # cuDNN's first call may choose other algorithms than later ones
    ref = g_out(state)
    args = SimpleNamespace(gan_type=None, seed=99, device=str(dev))
    for name, path in (("torchgan", torchgan), ("native", native_again)):
        _, st = _load_trainer(cfg_json, path, None, args)
        diff = float((g_out(st) - ref).abs().max())
        check(diff == 0.0 and st.step == state.step, f"export_torch {name}: G's output moved by {diff}")
        out[f"{name}_g_output_max_abs_diff"] = diff
        del st
        torch.cuda.empty_cache()
    return out


def synthetic_and_export(dev):
    """Phase 13: the render card against CPU, the quality run at full width
    (cut), the export round trip, and the A22 knobs as small steps."""
    import tempfile

    t0 = time.perf_counter()
    out = {"render": render_card_vs_cpu(dev)}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    with tempfile.TemporaryDirectory() as tmp:
        out["quality_run"], (tr, state) = quality_run_cut(dev, tmp, out["render"]["ms_b32"])
        torch.backends.cudnn.deterministic = True
        out["export"] = export_round_trip(dev, tr, state, tmp)
        del tr, state
    torch.cuda.empty_cache()
    out["a22_small_vs_cpu"] = {
        " ".join(str(p) for p in (arch, ck or "", mk or "") if p): train_small_matches_cpu(
            dev, None, arch, cfg_kw=ck, steps=steps, **mk) for arch, ck, mk, steps in A22_CASES}
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------- phase 14: the experiment tools

#: phase 14's corpus flags: phase 13's corpus (16 slides x 64 tiles, 19,198
#: genes, 256x256), cut from the tools' 200 (100) slides x 600 (300) tiles
TOOL_CORPUS = ["--slides", "16", "--tiles_per_slide", "64", "--genes", "19198", "--size", "256"]
#: A26: patients and tiles a patient (of 50 x 64), the panel's patients and noise columns (6 x 5)
REP_PATIENTS, REP_TILES, PANEL_PATIENTS, PANEL_COLS = 4, 16, 4, 5
#: A27: the CV's cut (of 25 + 10 tiles a slide, 5 folds x 40 epochs at batch 64)
ML_ARGS = ["--tiles_per_slide_cls", "8", "--test_tiles_per_slide", "4", "--folds", "2", "--epochs", "1",
           "--batch", "64"]
#: A28: the LMDB corpus (of 200 slides x 600 tiles) and the data-plane run's cut
LMDB_ARGS = ["--slides", "4", "--tiles_per_slide", "64", "--genes", "19198", "--size", "256", "--batch", "64"]
DATA_PLANE_ARGS = ["--epochs", "1", "--batch", "32", "--max_patches_total", "64", "--vae_epochs", "2",
                   "--host_probe_batches", "8", "--resident_steps", "8", "--overlap_ab", "4"]


def flag(argv, name):
    return int(argv[argv.index(name) + 1])


class Launches:
    """K1's and K3's launch counters set to 0 on entry and read on exit."""

    def __enter__(self):
        from rnagan_tpu_torch.kernels.fused_adam import fused_adam
        from rnagan_tpu_torch.kernels.infusion import infused_noise

        self._k = {"infused_noise": infused_noise, "fused_adam": fused_adam}
        torch.cuda.synchronize()
        for k in self._k.values():
            k.launches = 0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.counts = {name: k.launches for name, k in self._k.items()}


def tools_workdir(dev, tmp, gen):
    """What a quality run leaves in its workdir, at full width: the beta-VAE
    (``VAEModelConfig()`` widths, bfloat16) as ``vae_pretrain.pt`` and the
    ``wganvae_proj``, ``wganvae`` and ``wgan`` bundles of ``GANModelConfig()``
    through ``GANTrainer.save_model``, from init states whose generators
    are redrawn at O(1) activations (``randomize``: DCGAN's init gives
    tiles of one grey level, which no patient's z could move)."""
    from rnagan_tpu_torch.core.checkpoint import save_state_dict
    from rnagan_tpu_torch.models.betavae import BetaVAE
    from rnagan_tpu_torch.train.gan_trainer import GANTrainer

    rep = tool("representation_run_torch")
    args = rep.parse_args(TOOL_CORPUS)
    vae_cfg = tool("quality_run_torch").vae_model_config(args)
    vae_sd = BetaVAE(vae_cfg, seed=SEED + 14, device=dev).state_dict()
    t0 = time.perf_counter()
    save_state_dict(os.path.join(tmp, "vae_pretrain.pt"), vae_sd)
    for name, critic in (("wganvae_proj", "projection"), ("wganvae", "unconditional"), ("wgan", None)):
        rna_cfg, gan_cfg = rep.gan_configs(args, vae_cfg, critic or "unconditional")
        tr = GANTrainer(rna_cfg if critic else gan_cfg, vae_sd if critic else None, device=dev)
        state = tr.init_state()
        randomize(state.generator, gen)
        state.g_stats = [(m.clone(), v.clone()) for m, v in state.generator.bn_stats()]
        tr.save_model(state, os.path.join(tmp, f"{name}_last.model"))
        del tr, state
    torch.cuda.synchronize()
    sizes = {f: os.path.getsize(os.path.join(tmp, f)) / 2**20 for f in sorted(os.listdir(tmp))}
    return {"write_s": time.perf_counter() - t0, "mib": sizes}


def conditioning_proof(dev, tmp):
    """A26: ``representation_run_torch.main`` (the projection arm), then
    ``--ceiling_only``, then ``conditioning_panel_torch.main`` for both arms,
    K1 counted around each: one launch per RNA-GAN generation call (the
    patients of both condition modes, the z-sensitivity's patients and its
    rerun, the panel's rows)."""
    rep, panel = tool("representation_run_torch"), tool("conditioning_panel_torch")
    out_dir = os.path.join(tmp, "reps")
    argv = [*TOOL_CORPUS, "--workdir", tmp, "--out", out_dir, "--patients", str(REP_PATIENTS),
            "--tiles_per_patient", str(REP_TILES), "--rna_name", "wganvae_proj", "--critic", "projection",
            "--device", str(dev)]
    z_calls = min(8, REP_PATIENTS) + 1
    out = {}
    with Launches() as full:
        result = rep.main(argv)
    with Launches() as ceiling:
        again = rep.main([*argv, "--ceiling_only"])
    with Launches() as panels:
        paths = panel.main([*TOOL_CORPUS, "--workdir", tmp, "--out", os.path.join(tmp, "grids"), "--patients",
                            str(PANEL_PATIENTS), "--noise_cols", str(PANEL_COLS), "--device", str(dev)])
    want = {"representation": 2 * REP_PATIENTS + z_calls, "ceiling_only": z_calls, "panel": 2 * PANEL_PATIENTS}
    got = {"representation": full.counts, "ceiling_only": ceiling.counts, "panel": panels.counts}
    for name, n in want.items():
        check(got[name] == {"infused_noise": n, "fused_adam": 0}, f"A26 {name}: launches {got[name]}, K1 {n} wanted")
    for res in (result, again):
        values = [v for key in ("rnagan_population", "rnagan_reference_mode", "gan_control", "real_vs_real_ceiling",
                                "z_sensitivity") for v in res[key].values()]
        check(all(math.isfinite(v) for v in values), f"A26: a statistic is not finite: {res}")
    zs = result["z_sensitivity"]
    check(zs["cross_patient_pixel_delta_same_noise"] > 0 and math.isfinite(zs["ratio"]),
          f"A26: the patient's z does not reach the tiles: {zs}")
    import numpy as np

    for sub in ("", "reference_mode"):
        for source in ("real", "rnagan", "gan"):
            shape = np.load(os.path.join(out_dir, sub, f"representations_{source}.npy")).shape
            check(shape == (REP_PATIENTS, 2048), f"A26 representations_{source}.npy {sub}: {shape}")
    side = flag(TOOL_CORPUS, "--size") + 2  # a tile and the grid's padding
    for path in paths.values():
        with open(path, "rb") as f:
            head = f.read(24)  # the PNG's IHDR: width, height
        size = (int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big"))
        check(size == ((PANEL_COLS + 1) * side + 2, PANEL_PATIENTS * side + 2), f"A26 panel {path}: {size}")
    out.update(launches={k: v["infused_noise"] for k, v in got.items()},
               wall_s={"representation": full.wall_s, "ceiling_only": ceiling.wall_s, "panel": panels.wall_s},
               stats={k: result[k] for k in ("rnagan_population", "rnagan_reference_mode", "gan_control",
                                             "real_vs_real_ceiling", "z_sensitivity")})
    print(f"phase 14 A26: {json.dumps(out)}")
    return out


def ml_cut(dev, tmp):
    """A27: ``ml_experiment_run_torch.main`` on the ``wganvae`` bundle:
    ``real``, ``rnagan_synthetic`` and ``mixed``, none skipped; K1 once a
    generation chunk of 64, K3 once a classifier step (``fit_resident``: an
    epoch's ``max(n // batch, 1)`` steps a fold)."""
    import numpy as np

    from rnagan_tpu_torch.core.config import MLConfig
    from rnagan_tpu_torch.data.synthetic import SyntheticCorpus
    from rnagan_tpu_torch.train.ml_experiment import stratified_folds

    ml = tool("ml_experiment_run_torch")
    argv = [*TOOL_CORPUS, *ML_ARGS, "--workdir", tmp, "--out", os.path.join(tmp, "ml.json"),
            "--ckpt_name", "wganvae", "--device", str(dev)]
    args = ml.parse_args(argv)
    tissue = SyntheticCorpus(args.slides, args.tiles_per_slide, 8, 16, seed=args.corpus_seed,
                             device=dev).slides.tissue.cpu().numpy()
    check(set(tissue.tolist()) == {0, 1}, f"A27: the {args.slides} slides hold one tissue: {tissue}")
    labels = tissue[np.repeat(np.arange(args.slides), args.tiles_per_slide_cls)]
    steps = 0
    for arm_labels in (labels, labels, np.concatenate([labels, labels])):
        for tr, _ in stratified_folds(arm_labels, args.folds, MLConfig().seed):
            steps += args.epochs * max(len(tr) // args.batch, 1)
    with Launches() as run:
        result = ml.main(argv)
    want = {"infused_noise": math.ceil(len(labels) / 64), "fused_adam": steps}
    check(run.counts == want, f"A27: launches {run.counts}, expected {want}")
    check(all(k in result for k in ("real", "rnagan_synthetic", "mixed"))
          and not any(k.endswith("_skipped") for k in result), f"A27: arms {sorted(result)}")
    for arm in ("real", "rnagan_synthetic", "mixed"):
        accs = [f[k] for f in result[arm]["folds"] for k in ("accuracy", "weighted_f1")]
        accs += [f["test"][k] for f in result[arm]["folds"] for k in ("accuracy", "weighted_f1")]
        check(all(0.0 <= a <= 1.0 for a in accs), f"A27 {arm}: {result[arm]}")
    out = {"launches": run.counts, "wall_s": run.wall_s,
           **{arm: {k: v for k, v in result[arm].items() if k.startswith("mean")}
              for arm in ("real", "rnagan_synthetic", "mixed")},
           "fold_wall_s": {arm: [f["wall_s"] for f in result[arm]["folds"]]
                           for arm in ("real", "rnagan_synthetic", "mixed")}}
    print(f"phase 14 A27: {json.dumps(out)}")
    return out


def tool_rates(dev, tmp):
    """The tools' device work at full width timed alone (host clock around
    synchronized calls, after a warm call): A27's render of its real pool to
    224x224 uint8, its generation of the synthetic pool (VAE encode, K1, G in
    eval mode, the resize, chunks of 64) and A26's float32 InceptionV3 on a
    batch of 64 rendered tiles."""
    import numpy as np

    ml, rep = tool("ml_experiment_run_torch"), tool("representation_run_torch")
    q = tool("quality_run_torch")
    args = ml.parse_args([*TOOL_CORPUS, *ML_ARGS, "--workdir", tmp, "--ckpt_name", "wganvae", "--device", str(dev)])
    corpus = q.build_corpus(args, dev)
    expr_norm, _ = q.normalized_expression(corpus)
    ids = np.repeat(np.arange(args.slides), args.tiles_per_slide_cls)
    tiles = np.tile(np.arange(args.tiles_per_slide_cls), args.slides)
    trainer, state, _ = ml.load_generator(args, dev)
    extractor = rep.make_extractor(rep.parse_args(TOOL_CORPUS), dev)
    images01 = (corpus.render(ids[:64], tiles[:64]) + 1.0) * 0.5

    def per_s(fn, n, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return n * reps / (time.perf_counter() - t0)

    out = {"render_tiles_per_s": per_s(lambda: ml.render_set_u8(corpus, ids, tiles, args.image_size), len(ids)),
           "generate_tiles_per_s": per_s(
               lambda: ml.generate_set_u8(trainer, state, expr_norm, ids, args.image_size), len(ids)),
           "inception_f32_images_per_s": per_s(lambda: extractor(images01, 64), 64),
           "tiles": len(ids), "image_size": args.image_size}
    print(f"phase 14 rates: {json.dumps(out)}")
    return out


def lmdb_data_plane(dev, tmp):
    """A28: ``make_lmdb_corpus_torch.main`` (tiles/s; one store read back
    equal to the render, bit for bit, after the BGR flip and back), then
    ``data_plane_run_torch.main`` on it: the VAE pre-train (K3 once a
    step), then every GAN step, resident and streamed, with K1 and K3 twice."""
    import numpy as np

    from rnagan_tpu_torch.data.store import LMDBTileStore
    from rnagan_tpu_torch.data.synthetic import SyntheticCorpus

    mk, dp = tool("make_lmdb_corpus_torch"), tool("data_plane_run_torch")
    corpus_dir = os.path.join(tmp, "corpus")
    with Launches() as write:
        written = mk.main([*LMDB_ARGS, "--out", corpus_dir, "--device", str(dev)])
    args = mk.parse_args(LMDB_ARGS)
    check(write.counts == {"infused_noise": 0, "fused_adam": 0} and written["slides_written"] == args.slides,
          f"A28 corpus: {written}, launches {write.counts}")
    corpus = SyntheticCorpus(args.slides, args.tiles_per_slide, args.genes, args.size, device=dev)
    rendered = corpus.render(np.zeros(args.tiles_per_slide, np.int64), np.arange(args.tiles_per_slide))
    want = torch.clamp((rendered + 1.0) * 127.5 + 0.5, 0.0, 255.0).to(torch.uint8).cpu().numpy()
    with LMDBTileStore(os.path.join(corpus_dir, "slide0000", "slide0000.db")) as st:
        tiles, keys = st.load_tiles(st.keys())  # the reader swaps the stored BGR to RGB
    check(len(keys) == args.tiles_per_slide and np.array_equal(tiles, want), "A28: slide 0 read back differs")
    del corpus, rendered

    argv = [*DATA_PLANE_ARGS, "--corpus", corpus_dir, "--out", os.path.join(tmp, "data_plane.json"),
            "--device", str(dev)]
    with Launches() as run:
        result = dp.main(argv)
    batches = result["meta"]["tiles"] // flag(argv, "--batch")
    ab_steps = 2 * 3 * (1 + min(flag(argv, "--overlap_ab"), batches - 1))
    gan_steps = 1 + flag(argv, "--resident_steps") + ab_steps + flag(argv, "--epochs") * batches
    vae_steps = flag(argv, "--vae_epochs") * max(args.slides // min(64, args.slides), 1)
    want = {"infused_noise": 2 * gan_steps, "fused_adam": 2 * gan_steps + vae_steps}
    check(run.counts == want, f"A28: launches {run.counts}, expected {want}")
    losses = [v for e in result["epochs"] for v in (e["d_loss"], e["g_loss"])]
    check(losses and all(math.isfinite(v) for v in losses), f"A28: losses {result['epochs']}")
    out = {"write": {"tiles_per_s": written["tiles_per_s"], "seconds": written["seconds"]},
           "launches": run.counts, "gan_steps": gan_steps, "wall_s": {"corpus": write.wall_s, "data_plane": run.wall_s},
           **{k: result.get(k) for k in ("host_pipeline_tiles_per_s", "host_ms_per_batch", "device_put_ms",
                                         "resident_step_ms", "e2e_step_ms", "inflation_vs_resident",
                                         "overlap_ab_ms", "epochs")}}
    print(f"phase 14 A28: {json.dumps(out)}")
    return out


def experiment_tools(dev):
    """Phase 14: the JAX repository's experiment tools, ported as
    ``tools/*_torch.py``, run in-process at full width on the card with
    only counts cut; their bundles (~5.5 GB) live in a temporary directory."""
    import tempfile

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["workdir"] = tools_workdir(dev, tmp, torch.Generator(device=dev).manual_seed(SEED + 14))
        out["a26"] = conditioning_proof(dev, tmp)
        out["a27"] = ml_cut(dev, tmp)
        out["rates"] = tool_rates(dev, tmp)
        out["a28"] = lmdb_data_plane(dev, tmp)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    out["wall_s"] = {"workdir": out["workdir"]["write_s"], **{f"a26_{k}": v for k, v in out["a26"]["wall_s"].items()},
                     "a27": out["a27"]["wall_s"], **{f"a28_{k}": v for k, v in out["a28"]["wall_s"].items()}}
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig
    from rnagan_tpu_torch.eval.generate import Synthesizer
    from rnagan_tpu_torch.kernels import _build
    from rnagan_tpu_torch.kernels.infusion import infused_noise, infused_noise_plain
    from rnagan_tpu_torch.kernels.quant_matmul import int8_matmul, int8_matmul_plain
    from rnagan_tpu_torch.kernels.quantize import tanh_to_uint8, tanh_to_uint8_plain
    from rnagan_tpu_torch.losses.rna_infusion import encode_z_mean, z_population_stats
    from rnagan_tpu_torch.models.betavae import BetaVAE
    from rnagan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator, make_generator

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    # ---- phase 1: build
    kb = _build.build()
    _build.library()
    print(f"kernels built in {kb.seconds:.1f} s: {kb.path.name}")
    for line in kb.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    # ---- phases 2-3: each kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1_err = check_k1(dev, gen)
    k2_worst, k2_share = check_k2(dev, gen)
    shapes = {name: [tuple(p.shape) for p in net(GANModelConfig(), device=dev).parameters()]
              for name, net in (("G", DCGANGenerator), ("D", DCGANDiscriminator))}
    k3_err = check_k3(dev, gen, shapes["G"])
    k4_errs = check_k4(dev, gen)

    # ---- phase 4: the serving path at full width, float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    vae_cfg = VAEModelConfig(compute_dtype="float32")
    gan_cfg = GANModelConfig(compute_dtype="float32")
    cfg = GANConfig(model=gan_cfg, vae=vae_cfg)
    vae, g = BetaVAE(vae_cfg, seed=1, device=dev), DCGANGenerator(gan_cfg, seed=2, device=dev)
    randomize(vae, gen)
    randomize(g, gen)
    vae_sd, g_sd = vae.state_dict(), g.state_dict()
    del vae, g
    synth = Synthesizer(cfg, vae_sd, g_sd, device=dev)
    genes = torch.randn(BATCH, vae_cfg.rna_features, generator=gen, device=dev)
    population = torch.randn(512, vae_cfg.rna_features, generator=gen, device=dev)
    z_pop = z_population_stats(synth.vae, population)
    torch.cuda.synchronize()

    infused_noise.launches = 0
    tanh_to_uint8.launches = 0
    t0 = time.perf_counter()
    first = synth.synthesize(genes, seed=11)
    one_patient = synth.synthesize(genes[:1], 64, seed=12, z_pop=z_pop)
    repeat = synth.synthesize(genes, seed=11)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"infused_noise": infused_noise.launches, "tanh_to_uint8": tanh_to_uint8.launches}
    print(f"main path: 3 requests ({BATCH} + 64 + {BATCH} tiles) in {main_s:.3f} s; launches {launches}")
    check(all(v > 0 for v in launches.values()), f"a kernel of the main path never launched: {launches}")
    check(first.shape == (BATCH, 256, 256, 3) and first.dtype == torch.uint8, "request 1 shape/dtype")
    check(one_patient.shape == (64, 256, 256, 3) and one_patient.dtype == torch.uint8,
          "request 2 shape/dtype")
    check(torch.equal(first, repeat), "the repeated request is not bit-identical")
    check(float(first.float().std()) > 1.0, "request 1 tiles are constant")

    with torch.inference_mode():  # the same requests through the plain versions
        z = encode_z_mean(synth.vae, genes)
        plain_first = tanh_to_uint8_plain(synth.serve.generator(infused_noise_plain(z, BATCH, seed=11)))
        z1 = encode_z_mean(synth.vae, genes[:1])
        plain_pop = tanh_to_uint8_plain(synth.serve.generator(
            infused_noise_plain(z1, 64, seed=12, pop_mean=z_pop[0], pop_std=z_pop[1])))
    path_diff = {"reference": uint8_diff(first, plain_first), "population": uint8_diff(one_patient, plain_pop)}
    for k, (worst, share) in path_diff.items():
        check(worst <= 1, f"{k} request: kernel path vs plain path {worst} levels")
    small = small_config_matches_cpu(dev)
    print(f"kernel path vs plain path (max level, share differing): {path_diff}; "
          f"small config card vs CPU: {small}")
    qsynth, quantized = quantized_head_path(dev, cfg, vae_sd, g_sd, genes, z_pop, synth)
    variants = serving_variants_match_cpu(dev)

    # ---- phase 5: training checks, float32, TF32 off, cuDNN deterministic
    train_check = train_kernel_vs_plain(dev, gen, vae_sd)
    train_small = {arch: train_small_matches_cpu(dev, gen, arch) for arch in ("dcgan", "dcgan_up", "condgan")}
    vae_small = vae_small_matches_cpu(dev)
    print(f"full-width f32 step, K3 vs plain Adam: {train_check}; small config steps card vs CPU: "
          f"{train_small}; small VAE steps card vs CPU: {vae_small}")

    # ---- phase 6: the training path, GANConfig() (bfloat16), cuDNN as PyTorch defaults it
    torch.backends.cudnn.deterministic = False
    trainer, train_state, train_batches, training = train_main_path(dev, gen, vae_sd)
    training["stages_b8"] = training_stage_ms(trainer, train_state, train_batches[0])
    training["profile_b8"] = profile_training(lambda: trainer.train_step(train_state, train_batches[0]))
    del trainer, train_state, train_batches
    training.update(train_step_ms_b64(dev, gen, vae_sd))
    print("training: " + json.dumps(training))

    # ---- phase 7: the VAE training path, VAEConfig() (float32, TF32 off), and the handoff to the GAN
    torch.cuda.empty_cache()
    vae_train = vae_training(dev, gen)
    print(f"VAE training on {smi}: " + json.dumps({k: v for k, v in vae_train.items() if k != "history"}))

    # ---- phase 8: the data plane, FID and the JAX package's checkpoints (gan_train on LMDB tiles)
    torch.cuda.empty_cache()
    data_phase = data_fid_checkpoints(dev, vae_cfg, vae_sd)
    print(f"data plane, FID and JAX checkpoints on {smi}: " + json.dumps(data_phase))

    # ---- phase 9: SAGAN and BigGAN (gan-train through cli.main) and the remaining CLIs
    torch.cuda.empty_cache()
    # its own generator: the timings phase draws what it drew before this phase
    # existed (its dcgan_up weights, randomized, must give tiles that vary)
    sn_phase = attention_gans(dev, torch.Generator(device=dev).manual_seed(SEED + 9), vae_cfg, vae_sd)
    print(f"SAGAN, BigGAN and the CLIs on {smi}: " + json.dumps(sn_phase))

    # ---- phase 10: the ResNet family (AdamW through K3): the classifier's CV, SimCLR, fusion
    torch.cuda.empty_cache()
    resnet_phase = resnet_family(dev, torch.Generator(device=dev).manual_seed(SEED + 10))
    print(f"ResNet family on {smi}: " + json.dumps(
        {"k3_resnet50": resnet_phase["k3_resnet50"], "small_vs_cpu": resnet_phase["small_vs_cpu"]}
        | {name: {k: resnet_phase[name][k] for k in ("step_ms", "images_per_s", "step_tflop", "tflop_per_s",
                                                     "peak_gib_above_state", "phase_s")}
                 | {"device_busy_ms": resnet_phase[name]["profile"].get("device_busy_ms_per_step"),
                    "device_idle_share": resnet_phase[name]["profile"].get("device_idle_share")}
           for name in ("ml", "ssl", "fusion")}))
    torch.cuda.empty_cache()

    # ---- phase 12: the mesh (ranks spawned over gloo on one card, NCCL on several)
    mesh_out = mesh_phase(dev)
    torch.cuda.empty_cache()

    # ---- phase 13: the synthetic corpus on the card, the quality run (cut), export_torch, the A22 knobs
    syn_phase = synthetic_and_export(dev)
    print(f"synthetic corpus, quality run and export on {smi}: " + json.dumps(syn_phase))
    torch.cuda.empty_cache()

    # ---- phase 14: the experiment tools (A26-A28) at full width, counts cut
    tools_phase = experiment_tools(dev)
    print(f"experiment tools on {smi}: wall s {json.dumps(tools_phase['wall_s'])}; phase {tools_phase['phase_s']:.1f} s")

    # ---- phase 11: timings (serving as in its first measurement: cuDNN deterministic)
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    k3 = k3_timings(shapes, dev, gen)
    n, d = BATCH, gan_cfg.encoding_dims
    zt = torch.randn(n, d, generator=gen, device=dev)
    x = torch.randn(BATCH, 3, 256, 256, generator=gen, device=dev)

    def k2_library():  # PyTorch's own ops for the same function, as a yardstick
        return (torch.tanh(x).mul_(127.5).add_(128.0).clamp_(0.0, 255.0)
                .permute(0, 2, 3, 1).to(torch.uint8, memory_format=torch.contiguous_format))

    k1_bound, k1_by = bound_ms(2 * n * d * 4, 10 * n * d)  # z in, out; ~10 flops an element
    tiny = torch.zeros(1, device=dev)  # a launch that does next to nothing: the floor under K1
    ut = (torch.rand(n, d, generator=gen, device=dev) * 2 - 1) * 0.3
    k2_elems = x.numel()
    k2_bound, k2_by = bound_ms(k2_elems * 4 + k2_elems, 6 * k2_elems)  # tanh + 5 flops
    # K4 on the quantized head's own weights and a serving batch of noise
    w_q, w_scale, w_bias = head_weights(qsynth.serve)
    k4_args = (zt, w_q, w_scale, w_bias)
    w_bf16 = w_q.to(torch.bfloat16)  # what an unquantized bf16 head would hold
    k4_bound_ms, k4_by, k4_bytes = k4_bound(n, d, w_q.shape[1])
    kernels = [
        {"name": "infused_noise", "route": "cuda", "source": "rnagan_tpu_torch/csrc/infusion.cu",
         "replaces": "rnagan_tpu/ops/infusion.py:46",
         "launches": launches["infused_noise"] + training["launches"]["infused_noise"],
         "max_abs_err": k1_err,
         "ms": time_ms(lambda: infused_noise(zt, n, seed=3), iters=200),
         "device_ms": graph_ms(lambda: infused_noise(zt, n, seed=3)),
         "plain_ms": time_ms(lambda: infused_noise_plain(zt, n, seed=3), iters=50),
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "launch_floor_ms": graph_ms(tiny.zero_),
         "device_ms_given_u": graph_ms(lambda: infused_noise(zt, n, u=ut))},  # no Philox work
        {"name": "tanh_to_uint8", "route": "cuda", "source": "rnagan_tpu_torch/csrc/quantize.cu",
         "replaces": "rnagan_tpu/ops/quantize.py:45", "launches": launches["tanh_to_uint8"],
         "max_abs_err": float(k2_worst),
         "ms": time_ms(lambda: tanh_to_uint8(x), iters=50),
         "device_ms": graph_ms(lambda: tanh_to_uint8(x)),
         "plain_ms": time_ms(lambda: tanh_to_uint8_plain(x), iters=20),
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": time_ms(k2_library, iters=20)},
        {"name": "fused_adam", "route": "cuda", "source": "rnagan_tpu_torch/csrc/fused_adam.cu",
         "replaces": "rnagan_tpu/ops/fused_adam.py:66",
         "launches": training["launches"]["fused_adam"] + vae_train["main_path_launches"],
         "max_abs_err": max(k3_err, vae_train["k3_vs_plain"]["max_abs_err"]),
         **{key: k3["G"][key] + k3["D"][key]  # one GAN training step: G's launch and D's
            for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")},
         "bound_by": k3["G"]["bound_by"],
         # one VAE training step: one launch over its 26 tensors
         **{f"vae_{key}": vae_train["k3"][key]
            for key in ("params", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "vae_launches": vae_train["main_path_launches"]},
        {"name": "int8_matmul", "route": "cuda", "source": "rnagan_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "rnagan_tpu/ops/quant_matmul.py:48", "launches": quantized["launches"]["int8_matmul"],
         "max_abs_err": next(iter(k4_errs.values()))["max_abs_err"],  # the head's shape
         "ms": time_ms(lambda: int8_matmul(*k4_args), iters=50),
         "device_ms": graph_ms(lambda: int8_matmul(*k4_args)),
         "plain_ms": time_ms(lambda: int8_matmul_plain(*k4_args), iters=10),
         "bound_ms": k4_bound_ms, "bound_by": k4_by,
         "library_ms": time_ms(lambda: torch.matmul(zt.to(torch.bfloat16), w_bf16), iters=50),
         "launches_by_route": quantized["k4_launches_by_route"], **k4_small_batches(zt, k4_args, w_bf16)},
    ]
    for i, k in enumerate(("infused_noise", "tanh_to_uint8")):  # the quantized path launched them too
        kernels[i]["launches"] += quantized["launches"][k]
    # the ResNet family's main paths: AdamW, one launch a step, and K3 at ResNet50's shapes
    resnet_launches = {"ml_cv": resnet_phase["ml"]["cv_launches"],
                       "ml_fit_resident": resnet_phase["ml"]["resident_launches"],
                       "ssl": resnet_phase["ssl"]["launches"], "fusion": resnet_phase["fusion"]["launches"]}
    kernels[2]["launches"] += sum(resnet_launches.values())
    kernels[2]["resnet_launches"] = resnet_launches
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"],
                                    *(v["max_abs_err"] for v in resnet_phase["k3_adamw_check"].values()))
    kernels[2].update({f"resnet50_{key}": resnet_phase["k3_resnet50"][key]
                       for key in ("params", "tensors", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")})
    for i, k in ((0, "infused_noise"), (2, "fused_adam")):  # and gan_train's epochs K1 and K3
        kernels[i]["launches"] += data_phase["gan_train"]["launches"][k]
        kernels[i]["gan_train_launches"] = data_phase["gan_train"]["launches"][k]
        for arch in ("sagan", "biggan"):
            kernels[i]["launches"] += sn_phase[f"gan_train_{arch}"]["launches"][k]
            kernels[i][f"gan_train_{arch}_launches"] = sn_phase[f"gan_train_{arch}"]["launches"][k]
    # K1's group mode: launches on the mesh's full-width GAN steps (rank 0's count)
    k1g = mesh_out["k1_group"]
    main_shape = f"{GANConfig().batch_size}x{gan_cfg.encoding_dims}"  # the full-width GAN step's launch
    kernels.insert(1, {
        "name": "infused_noise_group", "route": "cuda", "source": "rnagan_tpu_torch/csrc/infusion.cu",
        "replaces": "rnagan_tpu/ops/infusion.py:46",
        "launches": mesh_out["gan_full_width"]["launches"]["infused_noise_group"],
        "max_abs_err": max(k1g["vs_plain_max_abs_err"], *k1g["vs_one_pass_max_abs_err"].values()),
        **k1g["times"][main_shape], "library_ms": None, "global_shape": main_shape,
        "other_shapes": {k: v for k, v in k1g["times"].items() if k != main_shape},
        "mesh": f"{mesh_out['ranks']} ranks over {mesh_out['backend']}"})
    kernels[3]["launches"] += mesh_out["gan_full_width"]["launches"]["fused_adam"]
    kernels[3]["mesh_launches"] = mesh_out["gan_full_width"]["launches"]["fused_adam"]
    for i, k in ((0, "infused_noise"), (3, "fused_adam")):  # the quality run's epochs, wganvae and wgan
        runs = {t: syn_phase["quality_run"][t]["launches"][k] for t in ("wganvae", "wgan")}
        kernels[i]["launches"] += sum(runs.values())
        kernels[i]["quality_run_launches"] = runs
    # the experiment tools: A26's generation calls, A27's generation and
    # classifier steps, A28's VAE pre-train and GAN steps
    tool_runs = {"infused_noise": {**{f"a26_{k}": v for k, v in tools_phase["a26"]["launches"].items()},
                                     "a27": tools_phase["a27"]["launches"]["infused_noise"],
                                     "a28": tools_phase["a28"]["launches"]["infused_noise"]},
                   "fused_adam": {"a27": tools_phase["a27"]["launches"]["fused_adam"],
                                  "a28": tools_phase["a28"]["launches"]["fused_adam"]}}
    for i, k in ((0, "infused_noise"), (3, "fused_adam")):
        kernels[i]["launches"] += sum(tool_runs[k].values())
        kernels[i]["tool_launches"] = tool_runs[k]
    del w_bf16

    g_flops, v_flops = generator_flops(gan_cfg, BATCH), vae_encode_flops(vae_cfg, BATCH)
    serving = {"generator_gflop": g_flops / 1e9, "vae_encode_gflop": v_flops / 1e9,
               "generator_params": sum(t.numel() for t in synth.serve.weights.values())}
    generators = {}
    for dtype in ("float32", "bfloat16"):
        s = synth if dtype == "float32" else Synthesizer(
            dataclasses.replace(cfg, model=dataclasses.replace(gan_cfg, compute_dtype=dtype),
                                vae=dataclasses.replace(vae_cfg, compute_dtype=dtype)),
            vae_sd, g_sd, device=dev)
        with torch.inference_mode():
            zs = encode_z_mean(s.vae, genes)
            noise = infused_noise(zs, BATCH, seed=5)
            pre = s.serve.generator(noise)
            stages = {
                "vae_encode_ms": time_ms(lambda: encode_z_mean(s.vae, genes), iters=10),
                "infused_noise_ms": time_ms(lambda: infused_noise(zs, BATCH, seed=5), iters=50),
                "generator_ms": time_ms(lambda: s.serve.generator(noise), iters=10),
                "tanh_to_uint8_ms": time_ms(lambda: tanh_to_uint8(pre), iters=50),
            }
        req_ms = time_ms(lambda: s.synthesize(genes, seed=5), iters=10)
        serving[dtype] = {"request_ms_b128": req_ms, "tiles_per_s": BATCH / req_ms * 1e3, **stages,
                          "generator_tflop_per_s": g_flops / stages["generator_ms"] / 1e9,
                          "vae_encode_tflop_per_s": v_flops / stages["vae_encode_ms"] / 1e9}
        w0, b0 = s.serve.weights["model.0.0.weight"], s.serve.weights["model.0.0.bias"]
        with torch.inference_mode():
            serving[dtype]["float_head_convt_ms"] = time_ms(
                lambda: torch.nn.functional.conv_transpose2d(noise.to(w0.dtype)[:, :, None, None], w0, b0),
                iters=20)
        generators[dtype] = (s.serve.generator, noise)
    # the same generator with cuDNN free to autotune and to pick nondeterministic algorithms
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    with torch.inference_mode():
        for dtype, (g, noise) in generators.items():
            ms = time_ms(lambda: g(noise), iters=10)
            serving[dtype]["generator_autotuned_ms"] = ms
            serving[dtype]["generator_autotuned_tflop_per_s"] = g_flops / ms / 1e9
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del generators, qsynth
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    up = make_generator(dataclasses.replace(gan_cfg, arch="dcgan_up"), seed=6, device=dev)
    randomize(up, gen)
    up_sd = up.state_dict()
    del up
    serving_options = serving_option_timings(cfg, vae_sd, g_sd, up_sd, genes)
    print("serving options: " + json.dumps(serving_options))

    details = {"card": smi, "build_s": kb.seconds, "k2_share_differing": k2_share,
               "main_path_s": main_s, "kernel_vs_plain_path": path_diff, "small_vs_cpu": small,
               "serving_b128": serving, "peak_mem_gib_timings": peak_gib,
               "training_f32_k3_vs_plain": train_check, "training_small_vs_cpu": train_small,
               "training": training, "fused_adam_by_model": k3, "vae_training": vae_train,
               "vae_small_vs_cpu": vae_small, "data_fid_checkpoints": data_phase,
               "attention_gans": sn_phase, "resnet_family": resnet_phase, "mesh": mesh_out,
               "synthetic_and_export": syn_phase, "experiment_tools": tools_phase,
               "k4_check": k4_errs, "k4_bytes": k4_bytes, "quantized_head_path": quantized,
               "serving_variants_vs_cpu": variants, "serving_options_b128": serving_options,
               "total_s": time.perf_counter() - t_start}
    print("details: " + json.dumps(details))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
