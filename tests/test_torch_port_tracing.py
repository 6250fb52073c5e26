"""What the port records about its own work (``core/profiling.py``): host spans
in a profiler's trace, device stage marks, counters, and the bytes
``StepGraph.load`` counts.

The CPU tests run the eager paths under a CPU profiler. The tests marked
``card`` need CUDA and skip without it; on a machine with a card they run
without this directory's conftest (which loads JAX), as
``python -m pytest tests/test_torch_port_tracing.py -q --noconftest``.
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rnagan_tpu_torch.core import profiling
from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEConfig, VAEModelConfig
from rnagan_tpu_torch.data.patches import PatchBatches, PatchData
from rnagan_tpu_torch.data.synthetic import SyntheticCorpus
from rnagan_tpu_torch.eval.generate import Synthesizer
from rnagan_tpu_torch.kernels import _build
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.models.registry import make_generator
from rnagan_tpu_torch.train import step_graph
from rnagan_tpu_torch.train.gan_trainer import GANTrainer
from rnagan_tpu_torch.train.vae_trainer import VAETrainer

REPO = Path(__file__).resolve().parent.parent
VAE_MODEL = VAEModelConfig(rna_features=16, z_dim=8, encoder_dims=(12, 8), decoder_dims=(12,))
GAN = GANConfig(model=GANModelConfig(out_size=16, encoding_dims=8, step_channels=4, compute_dtype="float32"),
                vae=VAE_MODEL, batch_size=4)
#: the marks of a ``wganvae`` step with the fused GP that runs its G stage
GAN_MARKS = ["gan_ingest", "gan_encode", "gan_noise", "gan_g_forward", "gan_d_forward", "gan_gp", "gan_d_backward",
             "gan_d_adam", "gan_noise", "gan_g_step", "gan_g_adam", "gan_stats", "end"]
#: the marks of a β-VAE step of ``run_steps`` (``vae_rows``: its ``prepare``, here the resident matrix's rows)
VAE_MARKS = ["vae_rows", "vae_mask", "vae_forward", "vae_backward", "vae_adam", "vae_stats", "end"]
SYNTH_MARKS = ["synth_encode", "synth_noise", "synth_generator", "synth_quantize", "end"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test captures and traces steps on the card")
    return torch.device("cuda", 0)


def _vae_sd():
    return BetaVAE(VAE_MODEL, seed=3).state_dict()


def _gan(device="cpu"):
    trainer = GANTrainer(GAN, vae_state_dict=_vae_sd(), device=device)
    return trainer, trainer.init_state()


def _batch(n=4, seed=0):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (n, 16, 16, 3)).astype(np.uint8),
            "rna_data": rs.randn(n, 16).astype(np.float32)}


def _patches():
    rs = np.random.RandomState(1)
    return PatchBatches(PatchData(images=rs.randint(0, 256, (10, 16, 16, 3)).astype(np.uint8),
                                  labels=np.zeros(10, np.int32), slide_idx=np.arange(10, dtype=np.int32) % 2,
                                  slides=["a", "b"], rna=rs.randn(2, 16).astype(np.float32)),
                        batch_size=4, with_rna=True, seed=5)


def _synth(device="cpu"):
    g_sd = make_generator(GAN.model, seed=4, device="cpu").state_dict()
    return Synthesizer(GAN, _vae_sd(), g_sd, device=device)


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    return [(e["name"][len(profiling.SPAN_PREFIX):], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"
            and e["name"].startswith(profiling.SPAN_PREFIX)]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _state_numbers(trainer, state):
    return [t.detach().clone() for t in trainer._state_tensors(state)]


# ------------------------------------------------------------------- spans


def test_spans_are_user_annotations_nested_as_stated(tmp_path):
    trainer, state = _gan()
    batches, synth = _patches(), _synth()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(state, _batch())
        built = list(batches.epoch(0))
        synth.synthesize(torch.randn(4, 16), seed=7)
    spans = _annotations(prof, tmp_path)
    names = [s[0] for s in spans]
    assert names.count("gan.train_step") == 1 and names.count("synth.request") == 1
    assert names.count("data.batch") == len(built) == 3
    step = next(s for s in spans if s[0] == "gan.train_step")
    request = next(s for s in spans if s[0] == "synth.request")
    plans = [s for s in spans if s[0] == "gan.plan"]
    assert plans and all(_inside(p, step) for p in plans)
    ingress = [s for s in spans if s[0] == "synth.ingress"]
    assert len(ingress) == 1 and _inside(ingress[0], request)
    assert not any(_inside(b, step) or _inside(b, request) for b in spans if b[0] == "data.batch")


def test_the_synthetic_corpus_names_its_batch_ids(tmp_path):
    corpus = SyntheticCorpus(n_slides=3, tiles_per_slide=4, n_genes=16, size=16, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sl, ti = corpus.batch_ids(11, 4, 2)
    assert sl.shape == ti.shape == (2, 4)
    assert [s[0] for s in _annotations(prof, tmp_path)] == ["synthetic.batch_ids"]


def test_without_a_profiler_a_span_enters_no_record_function(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a RecordFunction was entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.recording()
    assert profiling.span("a") is profiling.span("b")
    trainer, state = _gan()
    trainer.train_step(state, _batch())
    list(_patches().epoch(1))
    _synth().synthesize(torch.randn(4, 16), seed=1)
    with profiling.span("gan.train_step"):
        pass


# ------------------------------------------------------------------- marks


def test_marks_follow_the_stages_of_each_step(monkeypatch):
    """Each step marks its stages in order (recorded by name here: on the CPU a mark launches nothing)."""
    seen = []
    monkeypatch.setattr(profiling, "mark", lambda stage, device: seen.append(stage))
    trainer, state = _gan()
    trainer.train_step(state, _batch())
    assert seen == GAN_MARKS
    seen.clear()
    vae = VAETrainer(VAEConfig(model=VAE_MODEL, batch_size=4), device="cpu")
    vae.run_resident(vae.init_state(), torch.randn(10, 16), 1, 4)
    assert seen == VAE_MARKS
    seen.clear()
    _synth().synthesize(torch.randn(4, 16), seed=2)
    assert seen == SYNTH_MARKS
    seen.clear()
    SyntheticCorpus(n_slides=3, tiles_per_slide=4, n_genes=16, size=16, device="cpu").render([0, 1], [2, 3])
    assert seen == ["render"]


def test_a_mark_is_a_no_op_on_the_cpu(monkeypatch):
    def refuse():
        raise AssertionError("a mark reached the kernel library on the CPU")

    monkeypatch.setattr(_build, "library", refuse)
    cpu = torch.device("cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        for stage in profiling.STAGES:
            profiling.mark(stage, cpu)
    with pytest.raises(KeyError):
        profiling.mark("no_such_stage", cpu)


def test_the_eager_step_under_a_profiler_keeps_its_numbers():
    """Spans and marks change no number: the same step with and without a
    profiler gives the same metrics and state, bit for bit (the parity tests
    hold that step against the JAX package's)."""
    out = []
    for traced in (False, True):
        trainer, state = _gan()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                _, metrics = trainer.train_step(state, _batch())
        else:
            _, metrics = trainer.train_step(state, _batch())
        out.append(({k: v.clone() for k, v in metrics.items()}, _state_numbers(trainer, state)))
    (m0, s0), (m1, s1) = out
    assert m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert len(s0) == len(s1) and all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_the_stage_list_is_the_kernel_source_s():
    text = (_build.CSRC / "marks.cu").read_text()
    body = re.search(r"#define RNAGAN_STAGES\(X\)(.*?)\n\n", text, re.S).group(1)
    assert tuple(re.findall(r"X\((\w+)\)", body)) == profiling.STAGES
    assert len(set(profiling.STAGES)) == len(profiling.STAGES)


# ---------------------------------------------------------------- counters


def test_count_adds(monkeypatch):
    monkeypatch.setattr(profiling, "counters", {})
    profiling.count("graph.loaded_steps", 3)
    profiling.count("graph.loaded_steps", 4)
    profiling.count("graph.capture_s", 0.25)
    assert profiling.counters == {"graph.loaded_steps": 7, "graph.capture_s": 0.25}


@pytest.mark.parametrize("steps", [5, 2])
def test_load_counts_the_host_tables_bytes(steps):
    tables = {"image": torch.zeros((5, 4, 4, 3), dtype=torch.uint8), "rna_data": torch.zeros((5, 16)),
              "seeds": torch.zeros((5, 4), dtype=torch.int64), "ids": torch.zeros((5, 8), device="meta")}
    whole = sum(t.nbytes for k, t in tables.items() if k != "ids")
    assert step_graph.host_bytes(tables, steps) == whole * steps // 5


# -------------------------------------------------------------------- card


def _mark_kernels(prof, tmp_path):
    path = tmp_path / "card.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"), key=lambda e: e["ts"])
    return [e["name"] for e in kernels if profiling.MARK_PREFIX in e["name"]]


def _stage(name):
    return re.search(profiling.MARK_PREFIX + r"(\w+)", name).group(1)


@pytest.mark.card
@pytest.mark.parametrize("path", ["gan", "vae", "synth"])
def test_a_traced_step_holds_each_stage_mark_in_order(card, tmp_path, path):
    """A replay of a captured GAN or β-VAE step, and an eager request under a
    profiler, hold each stage's mark in order, and no mark's name falls in a
    kernel category or counted pattern of the benchmark's trace reader."""
    if path == "gan":
        trainer, state = _gan(card)
        trainer.train_step(state, _batch())  # captures
        run, expected = (lambda: trainer.train_step(state, _batch(seed=1))), GAN_MARKS
    elif path == "vae":
        vae = VAETrainer(VAEConfig(model=VAE_MODEL, batch_size=4), device=card)
        vae_state, data = vae.init_state(), torch.randn(10, 16, device=card)
        vae.run_resident(vae_state, data, 1, 4)
        run, expected = (lambda: vae.run_resident(vae_state, data, 1, 4)), VAE_MARKS
    else:
        synth = _synth(card)
        gene = torch.randn(4, 16, device=card)
        synth.synthesize(gene, seed=1)
        run, expected = (lambda: synth.synthesize(gene, seed=2)), SYNTH_MARKS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=card).add_(1)  # the session's first device record can go missing: not a mark
        run()
        torch.cuda.synchronize()
    names = _mark_kernels(prof, tmp_path)
    assert [_stage(n) for n in names] == expected
    sys.path.insert(0, str(REPO))
    try:
        from perfbench.core import trace
    finally:
        sys.path.remove(str(REPO))
    for n in names:
        assert trace.category(n) == "elementwise and other", n
        assert not any(pattern in n for pattern in trace.COUNTED), n


# ------------------------------------------------------- nested stages

#: a tiny ``biggan_pub`` whose attention runs in both nets (64x64 table, attention at 32x32)
BIGGAN_PUB = GANConfig(model=GANModelConfig(arch="biggan_pub", out_size=64, encoding_dims=40, step_channels=4,
                                            num_classes=2, attn_size=32, embed_dim=8, compute_dtype="float32"),
                       vae=VAEModelConfig(rna_features=16, z_dim=40, encoder_dims=(12, 8), decoder_dims=(12,)),
                       batch_size=4)


def _seen_marks(monkeypatch):
    """The stages marked, in order, while the real ``mark`` still runs (and keeps the stage it named)."""
    seen, real = [], profiling.mark

    def record(stage, device):
        seen.append(stage)
        real(stage, device)
    monkeypatch.setattr(profiling, "mark", record)
    return seen


def _with_attention(marks, inside):
    """``marks`` with ``gan_attn`` nested in each stage of ``inside`` (stage -> attention calls)."""
    out = []
    for stage in marks:
        out.append(stage)
        for _ in range(inside.get(stage, 0)):
            out += ["gan_attn", stage]
    return out


def test_attention_is_a_stage_nested_in_the_one_that_runs_it(monkeypatch):
    """``gan_attn`` marks each attention call and the enclosing stage is
    marked again when it returns: G's in the D stage's G forward and in the G
    stage, D's on the real tiles and the fakes, in the penalty's forward and in
    the G stage. Without attention (DCGAN) the marks are the parent's exactly."""
    seen = _seen_marks(monkeypatch)
    trainer, state = _gan()
    trainer.train_step(state, _batch())
    assert seen == GAN_MARKS and "gan_attn" not in seen
    seen.clear()
    trainer = GANTrainer(BIGGAN_PUB, vae_state_dict=BetaVAE(BIGGAN_PUB.vae, seed=3).state_dict(), device="cpu")
    state = trainer.init_state()
    rs = np.random.RandomState(3)
    trainer.train_step(state, {"image": rs.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8),
                               "rna_data": rs.randn(4, 16).astype(np.float32), "labels": np.array([0, 1, 1, 0])})
    assert seen == _with_attention(GAN_MARKS, {"gan_g_forward": 1, "gan_d_forward": 2, "gan_gp": 1, "gan_g_step": 2})


def test_a_nested_stage_resumes_the_stage_marked_before_it(monkeypatch):
    seen = _seen_marks(monkeypatch)
    cpu = torch.device("cpu")
    profiling.mark("gan_d_forward", cpu)
    with profiling.nested("gan_attn", cpu):
        assert seen[-1] == "gan_attn"
    profiling.mark("end", cpu)
    with profiling.nested("gan_attn", cpu):
        pass
    assert seen == ["gan_d_forward", "gan_attn", "gan_d_forward", "end", "gan_attn", "end"]
