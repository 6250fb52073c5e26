"""The traced run's checks and readers on made-up traces: an incomplete trace
gives no number, and the readers take their numbers from the right records."""

import pytest

from perfbench.core import bench, spec, trace

STEP = [("sm90_xmma_fprop_implicit_gemm", 0.0, 0.004), ("elementwise_kernel", 0.004, 0.005),
        ("(anonymous namespace)::fused_adam_kernel", 0.005, 0.006), ("memcpy: Memcpy HtoD", 0.0061, 0.0062),
        ("(anonymous namespace)::fused_adam_kernel", 0.0062, 0.007)]


def steps(n, gap=0.001, drop=None):
    ops, t = [], 0.0
    for i in range(n):
        ops += [(name, t + s, t + e) for k, (name, s, e) in enumerate(STEP) if (i, k) != drop]
        t += 0.007 + gap
    return ops


def profile(ops, units=4, launches=8):
    window = max(e for _, _, e in ops) - min(s for _, s, _ in ops)
    return trace.Profile(ops, [("perfbench.batch_wait", 0.0, 1.0)], window, units,
                         {"fused_adam": launches, "tanh_to_uint8": 0, "infused_noise": 0})


def readings(p):
    return bench.Readings(bench.Window(1.0, 10, 80, []), {"batch_wait": [0.002, 0.004], "entry": [0.01, 0.03]}, p,
                          {"params": 1_000_000, "bf16_flop": 1e12, "fp32_flop": 0.0})


def read(name, r):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py").read(r)


def test_a_complete_trace_passes_and_is_read():
    p = profile(steps(4))
    trace.check_complete(p, "fused_adam", 2)
    r = readings(p)
    assert read("gan_train.conv_ms", r) == pytest.approx(4.0)
    assert read("k3_roofline.gan_train", r) == pytest.approx(100 * 28e6 / 3.35e12 / 0.0018)
    assert read("gan_train.batch_wait_ms", r) == pytest.approx(3.0)
    assert read("gan_train.entry_host_ms", r) == pytest.approx(4.0)
    assert 0 < read("gan_train.device_idle_share", r) < 100
    assert read("gan_train.mfu", r) == pytest.approx(100 * 1e12 / 989e12 / 0.1)
    gaps = trace.breakdown(p)["idle_gaps"]
    assert gaps and gaps[0][0] == "perfbench.batch_wait"


@pytest.mark.parametrize("names", [("gan_train.entry_host_ms", "vae_train.entry_host_ms"),
                                   ("k3_roofline.gan_train", "k3_roofline.vae_train"),
                                   ("gan_train.device_idle_share", "vae_train.device_idle_share",
                                    "synth.device_idle_share"),
                                   ("gan_train.mfu", "vae_train.mfu", "synth.mfu"),
                                   ("gan_train.conv_ms", "synth.conv_ms"), ("vae_train.gemm_ms", "synth.gemm_ms")])
def test_metrics_of_one_quantity_in_different_cells_read_alike(names):
    """One quantity reported beside different end-to-end metrics is a metric
    each, each file naming the one reader they share."""
    r = readings(profile(steps(4)))
    values = [read(n, r) for n in names]
    assert all(v == values[0] for v in values), dict(zip(names, values))


@pytest.mark.parametrize("broken", ["a K3 record lost", "a step's record lost", "the span short"])
def test_an_incomplete_trace_gives_no_number(broken):
    if broken == "a K3 record lost":
        p = profile(steps(4, drop=(2, 2)))
    elif broken == "a step's record lost":
        p = profile(steps(4, drop=(2, 1)))
    else:
        p = profile(steps(4))
        p.window_s *= 2
    with pytest.raises(trace.IncompleteTrace):
        trace.check_complete(p, "fused_adam", 2)
