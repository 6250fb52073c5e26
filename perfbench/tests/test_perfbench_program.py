"""The readers of the program's own spans, stage marks and counters
(``core/program.py``) on made-up traces: each number comes from the right
records, and a program that records none of them gives no number."""

import ast

import pytest

from perfbench.core import bench, program, spec, trace

#: one GAN step: its table load, then each stage's mark and work, then ``end``
STEP = [("memcpy: Memcpy HtoD (Pinned -> Device)", 0.0, 0.0005), ("index_select_kernel", 0.0005, 0.0006),
        ("rnagan_mark_gan_ingest()", 0.0006, 0.00061), ("elementwise_kernel", 0.00061, 0.0007),
        ("rnagan_mark_gan_g_forward()", 0.0007, 0.00071), ("sm90_xmma_fprop_implicit_gemm", 0.00071, 0.0027),
        ("rnagan_mark_gan_gp()", 0.0027, 0.00271), ("cudnn::nchwToNhwcKernel", 0.00271, 0.0037),
        ("rnagan_mark_gan_d_adam()", 0.0037, 0.00371), ("(anonymous namespace)::fused_adam_kernel", 0.00371, 0.0047),
        ("rnagan_mark_end()", 0.0047, 0.00471), ("elementwise_kernel", 0.00471, 0.0048)]
PERIOD = 0.006


def steps(n, marks=True):
    ops = []
    for i in range(n):
        ops += [(name, i * PERIOD + s, i * PERIOD + e) for name, s, e in STEP if marks or "rnagan_mark" not in name]
    return ops


def host(n):
    """Each step: ``gan.train_step`` holding ``graph.load`` and ``graph.replay``; a bare caller gap after it."""
    out = []
    for i in range(n):
        t = i * PERIOD
        out += [("rnagan.gan.train_step", t + 0.0048, t + 0.0058), ("rnagan.graph.load", t + 0.0049, t + 0.0051),
                ("rnagan.graph.replay", t + 0.0052, t + 0.0055), ("aten::copy_", t + 0.0049, t + 0.005)]
    return out


def profile(n=4, marks=True, spans=True):
    return trace.Profile(steps(n, marks), host(n) if spans else [], n * PERIOD, n, {})


def readings(p):
    return bench.Readings(bench.Window(1.0, 10, 80, []), {}, p, {})


def read(name, p):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py").read(readings(p))


def test_span_ms_sums_a_span_a_step():
    p = profile()
    assert program.span_ms(p, "graph.load") == pytest.approx(0.2)
    assert program.span_ms(p, "graph.replay") == pytest.approx(0.3)
    assert program.span_ms(p, "gan.train_step") == pytest.approx(1.0)
    assert program.span_ms(p, "data.batch") is None
    assert read("gan_train.load_host_ms", p) == pytest.approx(0.2)
    for name in ("gan_train.replay_host_ms", "quality_train.replay_host_ms", "vae_train.replay_host_ms"):
        assert read(name, p) == pytest.approx(0.3)


def test_stage_ms_sums_the_work_between_a_mark_and_the_next():
    p = profile()
    assert program.stage_ms(p, "gan_g_forward") == pytest.approx(1.99)
    assert program.stage_ms(p, "gan_gp") == pytest.approx(0.99)
    assert program.stage_ms(p, "gan_g_forward", "gan_gp") == pytest.approx(2.98)
    assert program.stage_ms(p, "gan_d_adam") == pytest.approx(0.99)
    assert program.stage_ms(p, "render") is None  # never marked
    assert read("gan_train.gp_ms", p) == pytest.approx(0.99)
    # the model's stages that were marked, the unmarked ones counting 0
    assert read("gan_train.model_ms", p) == read("quality_train.model_ms", p) == pytest.approx(2.98)
    assert program.marks_ms(p) == pytest.approx(0.05)


def test_the_unmarked_share_leaves_out_the_table_copies():
    p = profile()
    staged = sum(e - s for n, s, e in STEP if "rnagan_mark" not in n)
    outside = (0.0006 - 0.0005) + (0.0048 - 0.00471)  # the row gather before the first mark, the work after ``end``
    assert program.unmarked_share(p) == pytest.approx(100 * outside / staged)
    assert program.stage_seconds(p)[None] == pytest.approx(4 * (outside + 0.0005))


def test_the_named_idle_share_reads_where_each_long_gap_begins():
    p = profile()
    # each step leaves one gap, 0.0048 -> 0.006 (the next step's copy); it begins inside gan.train_step
    assert program.idle_named_share(p) == pytest.approx(100.0)
    moved = trace.Profile(p.device, [(n, s + 0.0003 if n == "rnagan.gan.train_step" else s, e) for n, s, e in p.host],
                          p.window_s, p.units, {})
    assert program.idle_named_share(moved) == pytest.approx(0.0)
    gaps = trace.breakdown(p)["idle_gaps"]
    assert gaps[0][0] == "rnagan.gan.train_step"
    assert read("gan_train.idle_named_share", p) == read("synth.idle_named_share", p) == pytest.approx(100.0)


def test_counters_are_read_from_the_program(monkeypatch):
    from rnagan_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "counters", {"graph.h2d_bytes": 3 * 6_906_000, "graph.loaded_steps": 3,
                                                "graph.capture_s": 1.25})
    p = profile()
    assert read("gan_train.h2d_mb", p) == pytest.approx(6.906)
    assert read("setup.capture_s", p) == pytest.approx(1.25)
    assert program.counter_ratio("graph.h2d_bytes", "graph.no_such") is None
    monkeypatch.setattr(profiling, "counters", {"graph.h2d_bytes": 5, "graph.loaded_steps": 0})
    assert read("gan_train.h2d_mb", p) is None


def reads_the_program(name):
    """Whether the metric's reader imports ``perfbench.core.program``, in any form."""
    tree = ast.parse((spec.HERE / "metrics" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(a.name == "perfbench.core.program" for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and (node.module == "perfbench.core.program" or (
                node.module == "perfbench.core" and any(a.name == "program" for a in node.names))):
            return True
    return False


@pytest.mark.parametrize("source, reads", [("from perfbench.core import program", True),
                                           ("from perfbench.core import bench, program as p", True),
                                           ("from perfbench.core.program import stage_ms", True),
                                           ("import perfbench.core.program", True),
                                           ("from perfbench.metrics import mfu as read", False),
                                           ("# perfbench.core import program", False)])
def test_the_program_readers_are_found_by_their_imports(tmp_path, monkeypatch, source, reads):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "probe.py").write_text(source + "\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    assert reads_the_program("probe") is reads


def test_a_program_that_records_nothing_gives_no_number(monkeypatch):
    """What a parent without spans, marks or counters reads: nothing, and no error."""
    from rnagan_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "counters")
    p = profile(marks=False, spans=False)
    new = [m["name"] for m in spec.load_benchmark()["per_layer"] if reads_the_program(m["name"])]
    assert len(new) >= 29
    for name in new:
        assert read(name, p) is None, name
    assert program.unmarked_share(p) is None and program.marks_ms(p) is None


def test_no_mark_falls_in_a_category_or_counted_pattern():
    from rnagan_tpu_torch.core import profiling

    for stage in profiling.STAGES:
        for name in (f"{profiling.MARK_PREFIX}{stage}()", f"void {profiling.MARK_PREFIX}{stage}()"):
            assert trace.category(name) == "elementwise and other", name
            assert not any(pattern in name for pattern in trace.COUNTED), name
            assert program.MARK.search(name).group(1) == stage
