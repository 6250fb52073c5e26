#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result line is printed):

1. the card, its power limit, and the kernels built from ``rnagan_tpu_torch/csrc``;
2. K1 (infused noise) against its plain PyTorch version at (128, 2048);
3. K2 (tanh -> uint8, NCHW -> NHWC) against its plain version at (128, 3, 256, 256);
4. the main path at full width (``VAEModelConfig()`` and ``GANModelConfig()``
   widths, float32, TF32 off): a ``Synthesizer`` on the card serves a batch of
   128 patients (reference mode), one patient x 64 (population mode) and a
   repeat of the first request, with the launch counters read around them;
   the kernel path is held against the plain-op path, and a small
   configuration against the same Synthesizer on the CPU;
5. timings with CUDA events: each kernel (through its wrapper, and replayed
   from a CUDA graph for its device time), its plain version and a PyTorch
   yardstick; the serving stages and tiles/s at batch 128 in float32 and
   bfloat16; the generator again with cuDNN autotuning.

It prints a details line, the ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device": ...}``.
Weights are random, from fixed seeds. Needs no JAX and no network.
"""

import dataclasses
import json
import subprocess
import sys
import time

import torch

BATCH = 128
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 non-tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


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


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
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


def vae_encode_flops(cfg, batch):
    dims = (cfg.rna_features, *cfg.encoder_dims)
    return 2 * batch * (sum(a * b for a, b in zip(dims, dims[1:])) + 2 * dims[-1] * cfg.z_dim)


def randomize(module, gen):
    """Random BN running statistics, far from (0, 1), so BN folding is
    exercised; ConvTranspose weights redrawn with a variance that keeps the
    activations O(1), so the tiles span the uint8 range (DCGAN's N(0, 0.02)
    init gives tiles of one grey level)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(1.0, 2.0, generator=gen)
            elif isinstance(m, torch.nn.ConvTranspose2d):
                taps = 1 if m.stride[0] == 1 else 4  # a 1x1-input head vs a stride-2 4x4
                m.weight.normal_(0.0, (m.in_channels * taps) ** -0.5, generator=gen)


def uint8_diff(a, b):
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def check_k1(dev, gen):
    from rnagan_tpu_torch.kernels.infusion import infused_noise, infused_noise_plain

    n, d = BATCH, 2048
    z = torch.randn(n, d, generator=gen, device=dev) * 3
    u = (torch.rand(n, d, generator=gen, device=dev) * 2 - 1) * 0.3
    pm = torch.randn(d, generator=gen, device=dev)
    ps = torch.rand(d, generator=gen, device=dev) + 0.5
    errs = {
        "u": infused_noise(z, n, u=u) - infused_noise_plain(z, n, u=u),
        "seed": infused_noise(z, n, seed=7) - infused_noise_plain(z, n, seed=7),
        "seed_broadcast": infused_noise(z[:1], n, seed=7) - infused_noise_plain(z[:1], n, seed=7),
        "population": (infused_noise(z[:1], n, seed=7, pop_mean=pm, pop_std=ps)
                       - infused_noise_plain(z[:1], n, seed=7, pop_mean=pm, pop_std=ps)),
    }
    errs = {k: float(v.abs().max()) for k, v in errs.items()}
    for k, e in errs.items():
        check(e <= 1e-5, f"K1 {k} mode differs from its plain version by {e}")
    out = infused_noise(z, n, seed=7)
    check(float(out.mean(0).abs().max()) <= 1e-5, "K1 column means are not 0")
    check(float((out.std(0, correction=1) - 1).abs().max()) <= 1e-4, "K1 column stds are not 1")
    corr = float(torch.corrcoef(torch.stack([z[:, 0], out[:, 0]]))[0, 1])
    check(corr > 0.9, f"K1 corr(z, out) = {corr}")
    check(torch.equal(out, infused_noise(z, n, seed=7)), "K1 same seed, different output")
    check(float((out - infused_noise(z, n, seed=8)).abs().max()) > 1e-2, "K1 seeds 7 and 8 agree")
    print(f"K1 infused_noise vs plain, max abs err by mode: {errs}; corr(z, out) {corr:.4f}")
    return max(errs.values())


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig
    from rnagan_tpu_torch.eval.generate import Synthesizer
    from rnagan_tpu_torch.kernels import _build
    from rnagan_tpu_torch.kernels.infusion import infused_noise, infused_noise_plain
    from rnagan_tpu_torch.kernels.quantize import tanh_to_uint8, tanh_to_uint8_plain
    from rnagan_tpu_torch.losses.rna_infusion import encode_z_mean, z_population_stats
    from rnagan_tpu_torch.models.betavae import BetaVAE
    from rnagan_tpu_torch.models.dcgan import DCGANGenerator

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

    # ---- phase 4: the main path at full width, float32, TF32 off
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

    # ---- phase 5: timings
    n, d = BATCH, gan_cfg.encoding_dims
    zt = torch.randn(n, d, generator=gen, device=dev)
    x = torch.randn(BATCH, 3, 256, 256, generator=gen, device=dev)

    def k2_library():  # PyTorch's own ops for the same function, as a yardstick
        return (torch.tanh(x).mul_(127.5).add_(128.0).clamp_(0.0, 255.0)
                .permute(0, 2, 3, 1).to(torch.uint8, memory_format=torch.contiguous_format))

    k1_bound, k1_by = bound_ms(2 * n * d * 4, 10 * n * d)  # z in, out; ~10 flops an element
    k2_elems = x.numel()
    k2_bound, k2_by = bound_ms(k2_elems * 4 + k2_elems, 6 * k2_elems)  # tanh + 5 flops
    kernels = [
        {"name": "infused_noise", "route": "cuda", "source": "rnagan_tpu_torch/csrc/infusion.cu",
         "replaces": "rnagan_tpu/ops/infusion.py:46", "launches": launches["infused_noise"],
         "max_abs_err": k1_err,
         "ms": time_ms(lambda: infused_noise(zt, n, seed=3), iters=200),
         "device_ms": graph_ms(lambda: infused_noise(zt, n, seed=3)),
         "plain_ms": time_ms(lambda: infused_noise_plain(zt, n, seed=3), iters=50),
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "tanh_to_uint8", "route": "cuda", "source": "rnagan_tpu_torch/csrc/quantize.cu",
         "replaces": "rnagan_tpu/ops/quantize.py:45", "launches": launches["tanh_to_uint8"],
         "max_abs_err": float(k2_worst),
         "ms": time_ms(lambda: tanh_to_uint8(x), iters=50),
         "device_ms": graph_ms(lambda: tanh_to_uint8(x)),
         "plain_ms": time_ms(lambda: tanh_to_uint8_plain(x), iters=20),
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": time_ms(k2_library, iters=20)},
    ]

    g_flops, v_flops = generator_flops(gan_cfg, BATCH), vae_encode_flops(vae_cfg, BATCH)
    serving = {"generator_gflop": g_flops / 1e9, "vae_encode_gflop": v_flops / 1e9,
               "generator_params": sum(t.numel() for t in synth.serve.generator.parameters())}
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

    details = {"card": smi, "build_s": kb.seconds, "k2_share_differing": k2_share,
               "main_path_s": main_s, "kernel_vs_plain_path": path_diff, "small_vs_cpu": small,
               "serving_b128": serving, "peak_mem_gib": peak_gib,
               "total_s": time.perf_counter() - t_start}
    print("details: " + json.dumps(details))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
