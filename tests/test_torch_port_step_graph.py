"""The training step as one program (``train/step_graph.py``) and what it
reads from device memory, on the CPU: K1's seed and K3's bias corrections as
tensors, the seed table, the Philox draws of the GP's eps and the normal
noise, ``train_step_eager`` against the JAX step, the quality tool's
``--steps_per_dispatch`` chunks, and ``AsyncSaver`` (ported from
``tests/test_core.py:81-110``). The captured path itself needs a card:
``chip_smoke.py`` phase 15 holds it against ``train_step_eager`` there, bit
for bit; here ``StepGraph`` must refuse to run without CUDA."""

import dataclasses
import importlib.util
import os
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from test_torch_port_train import N, VAE_KW, _cfgs, _draws, _jax_state, _np, _port_state

from rnagan_tpu.parallel.mesh import make_mesh
from rnagan_tpu.train.gan_trainer import GANTrainer as JaxGANTrainer
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.core import rng as trng
from rnagan_tpu_torch.core.checkpoint import AsyncSaver, load_bundle, save_bundle
from rnagan_tpu_torch.kernels.fused_adam import adam_update_plain, fused_adam
from rnagan_tpu_torch.kernels.infusion import infused_noise, infused_noise_plain
from rnagan_tpu_torch.optim.adam import bias_corrections
from rnagan_tpu_torch.train import step_graph
from rnagan_tpu_torch.train.gan_trainer import GANTrainer, given_batch

REPO = Path(__file__).resolve().parent.parent
F32 = np.float32


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the suite runs several workers at once, and a full
    thread pool in each makes the CPU convolutions crawl (the quality run's
    smoke took 667 s beside 6 workers with 8 threads, 25 s alone)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("dtype,shape", [(torch.int64, ()), (torch.int32, (1,)), (torch.int64, (1,))])
@pytest.mark.parametrize("z_rows", [6, 1])
def test_k1_tensor_seed_matches_int_seed(dtype, shape, z_rows):
    """The plain version (the CPU's K1) with the seed as a one-element tensor
    draws the int seed's Philox stream: bit-equal output, population mode too."""
    z = torch.randn(z_rows, 40, generator=torch.Generator().manual_seed(0)) * 3
    seed = torch.full(shape, 123457, dtype=dtype)
    assert torch.equal(infused_noise(z, 6, seed=seed), infused_noise(z, 6, seed=123457))
    assert torch.equal(infused_noise_plain(z, 6, seed=seed), infused_noise_plain(z, 6, seed=123457))
    pm, ps = torch.zeros(40), torch.ones(40)
    assert torch.equal(infused_noise(z[:1], 6, seed=seed, pop_mean=pm, pop_std=ps),
                       infused_noise(z[:1], 6, seed=123457, pop_mean=pm, pop_std=ps))
    assert not torch.equal(infused_noise(z, 6, seed=seed), infused_noise(z, 6, seed=123458))


@pytest.mark.parametrize("seed", [torch.zeros(2, dtype=torch.int64), torch.zeros((), dtype=torch.float32)])
def test_k1_rejects_a_seed_tensor_of_another_shape_or_type(seed):
    with pytest.raises(ValueError, match="tensor seed"):
        infused_noise(torch.zeros(4, 8), 4, seed=seed)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_k3_corr_tensor_matches_host_floats(mu_dtype, wd):
    """K3 on the CPU (its plain version) with ``corr`` as a float32 (2,)
    tensor: bit-equal to the same step with the host floats."""
    g = torch.Generator().manual_seed(1)
    shapes = [(7, 5), (3,), (64,)]
    c1, c2 = bias_corrections(6, 0.5, 0.999)
    hp = dict(lr=1e-3, b1=0.5, b2=0.999, eps=1e-8, wd=wd)

    def inputs():
        g.manual_seed(1)
        return ([torch.randn(s, generator=g) for s in shapes], [torch.randn(s, generator=g) for s in shapes],
                [(torch.randn(s, generator=g) * 1e-3).to(mu_dtype) for s in shapes],
                [torch.rand(s, generator=g) * 1e-2 for s in shapes])

    a, b, c = inputs(), inputs(), inputs()
    fused_adam(*a, corr=torch.tensor([c1, c2], dtype=torch.float32), **hp)
    fused_adam(*b, c1=c1, c2=c2, **hp)
    adam_update_plain(*c, None, None, corr=torch.tensor([c1, c2], dtype=torch.float32), **hp)
    for xs, ys, zs in zip(a, b, c):
        for x, y, w in zip(xs, ys, zs):
            assert torch.equal(x, y) and torch.equal(x, w)
    with pytest.raises(ValueError, match="c1 and c2, or corr"):
        fused_adam(*inputs(), c1=c1, c2=c2, corr=torch.tensor([c1, c2]), **hp)
    with pytest.raises(ValueError, match="corr must be"):
        fused_adam(*inputs(), corr=torch.tensor([c1, c2, 1.0]), **hp)


def test_seed_table_and_draws_match_the_host_seeds():
    """``SeedStream.table`` holds ``seed(name, step, stage)`` entry by entry;
    the GP eps's uniforms and the normal noise drawn from a table entry (a
    device scalar) equal the draws from the same host int."""
    s = trng.SeedStream(17)
    table = s.table("train", 40, 5, 4)
    assert table.dtype == torch.int64 and table.shape == (5, 4)
    assert [[s.seed("train", 40 + i, j) for j in range(4)] for i in range(5)] == table.tolist()
    for seed in (table[2, 3], table[2:3, 3]):
        assert torch.equal(trng.uniform(seed, (6, 1, 1, 1), "cpu"), trng.uniform(int(table[2, 3]), (6, 1, 1, 1), "cpu"))
        assert torch.equal(trng.normal(seed, (4, 33), "cpu"), trng.normal(int(table[2, 3]), (4, 33), "cpu"))
    u = trng.uniform(5, (20000,), "cpu")
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.01
    x = trng.normal(5, (200, 101), "cpu")
    assert abs(float(x.mean())) < 0.02 and abs(float(x.std()) - 1.0) < 0.02
    assert not torch.equal(trng.uniform(5, (8,), "cpu"), trng.uniform(6, (8,), "cpu"))


@pytest.fixture(scope="module")
def vae():
    from test_torch_port_parity import jax_vae_variables

    from rnagan_tpu.core import config as jcfg
    from rnagan_tpu_torch import convert
    from rnagan_tpu_torch.core import config as tcfg

    vars_ = jax_vae_variables(jcfg.VAEModelConfig(**VAE_KW), seed=11)
    return vars_, convert.betavae_state_dict_from_jax(tcfg.VAEModelConfig(**VAE_KW), vars_)


def test_step_graph_refuses_to_run_without_cuda(vae):
    """No CUDA: ``StepGraph`` raises, it never runs the step eagerly; the
    trainer on the CPU takes its eager step by choice (``captures()``)."""
    for device in ("cuda", "cpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            step_graph.StepGraph(lambda v, rows: rows["x"], {"x": torch.zeros(1, 2)}, 1, [], device)
    _, tc = _cfgs({}, {})
    assert not GANTrainer(tc, vae[1], device="cpu").captures()


class _Graph:
    """``StepGraph`` without CUDA: what the cache built it from."""

    def __init__(self, fn, tables, capacity, state, device):
        self.capacity, self.state, self.pool_bytes, self.graphs = capacity, list(state), 1, {}


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.cfg = tcfg.GANModelConfig(arch="biggan", num_classes=2)
        self.w = torch.nn.Parameter(torch.zeros(3))


CACHE_CASES = ("same_key", "data_ptr", "prepare", "capacity", "table_dtype", "module_cfg", "cudnn_flag",
               "tf32_flag", "fifth_key_evicts_the_oldest", "eval_snapshots_nothing", "prepare_cache", "captures",
               "reads_and_release")


@pytest.mark.parametrize("case", CACHE_CASES)
def test_step_graphs_cache_policy(case, monkeypatch):
    """``StepGraphs``' key, eviction, snapshot and capture rules, with
    ``StepGraph`` (which needs a card) replaced by a stub: the same key finds
    the same graph, and each part of the key builds a new one when it
    changes."""
    monkeypatch.setattr(step_graph, "StepGraph", _Graph)
    graphs = step_graph.StepGraphs("cuda", SimpleNamespace(world=1))
    net, opt = _Net(), object()
    live = [net.w, torch.zeros(2)]
    built = []

    def body():
        built.append(1)
        return lambda variant, rows: None

    def prepare(rows):
        return rows

    def graph(kind="train", live=live, tables=None, prepare=prepare, capacity=4):
        tables = {"x": torch.zeros(4, 3)} if tables is None else tables
        return graphs.graph(kind, (net, opt), live, tables, prepare, capacity, body)

    first = graph()
    if case == "same_key":
        assert graph() is first and graph(tables={"x": torch.ones(9, 3)}) is first and len(built) == 1
    elif case == "data_ptr":
        assert graph(live=[torch.zeros(3), live[1]]) is not first
    elif case == "prepare":
        assert graph(prepare=lambda rows: rows) is not first
    elif case == "capacity":
        assert graph(capacity=5) is not first and graph(capacity=5).capacity == 5
    elif case == "table_dtype":
        assert graph(tables={"x": torch.zeros(4, 3, dtype=torch.float64)}) is not first
        assert graph(tables={"x": torch.zeros(4, 2)}) is not first
    elif case == "module_cfg":
        net.cfg = dataclasses.replace(net.cfg, remat=True)
        assert graph() is not first
        net.cfg = dataclasses.replace(net.cfg, remat=False)
        assert graph() is first
    elif case == "cudnn_flag":
        monkeypatch.setattr(torch.backends.cudnn, "benchmark", not torch.backends.cudnn.benchmark)
        assert graph() is not first
    elif case == "tf32_flag":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", not torch.backends.cuda.matmul.allow_tf32)
        assert graph() is not first
    elif case == "fifth_key_evicts_the_oldest":
        second = graph(capacity=5)
        graph(capacity=6), graph(capacity=7)
        assert graph() is first  # the first is now the most recently used
        graph(capacity=8)  # the fifth key: the least recently used (capacity 5) goes
        assert len(graphs.graphs()) == step_graph.MAX_GRAPHS == 4
        assert graph() is first and graph(capacity=5) is not second
    elif case == "eval_snapshots_nothing":
        ev = graph(kind="eval")
        assert ev is not first and ev.state == [] and [t is u for t, u in zip(first.state, live)] == [True, True]
    elif case == "prepare_cache":
        made = []
        fns = [graphs.prepared(("host", k), lambda: made.append(1) or (lambda rows: rows))
               for k in range(2 * step_graph.MAX_GRAPHS)]
        assert graphs.prepared(("host", 0), lambda: None) is fns[0] and len(made) == 2 * step_graph.MAX_GRAPHS
        graphs.prepared(("host", "new"), lambda: made.append(1) or (lambda rows: rows))
        assert graphs.prepared(("host", 1), lambda: "rebuilt") == "rebuilt"  # the oldest went
    elif case == "captures":
        assert graphs.captures()
        assert not step_graph.StepGraphs("cpu", SimpleNamespace(world=1)).captures()
        assert not step_graph.StepGraphs("cuda", SimpleNamespace(world=2)).captures()
    else:
        graph(kind="eval")
        assert [k for k, _ in graphs.graphs()] == ["train", "eval"] and graphs.pool_bytes() == 2
        graphs.prepared("p", lambda: prepare)
        graphs.release()
        assert graphs.graphs() == [] and graphs.pool_bytes() == 0 and graphs.prepared("p", lambda: None) is None


EAGER_CASES = {"wganvae": ({}, 2),
               "wgan_compat_clip_ncritic2_ema": ({"loss_type": "wgan", "compat_reference_gp": True, "n_critic": 2,
                                                  "g_ema_decay": 0.99}, 2)}


@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_train_step_eager_matches_jax(vae, case):
    """``train_step_eager`` (the captured step's plain version) against the
    JAX step with given draws, at the tolerances of
    ``tests/test_torch_port_train.py``; ``run_steps`` over the same batches
    as tables gives the same steps bit for bit, its metrics vector summed."""
    cfg_kw, steps = EAGER_CASES[case]
    jc, tc = _cfgs(cfg_kw, {})
    vae_vars, vae_sd = vae
    wganvae = jc.loss_type == "wganvae"
    jtr = JaxGANTrainer(jc, vae_variables=vae_vars if wganvae else None, mesh=make_mesh(devices=jax.devices()[:1]))
    js = _jax_state(jtr, jc)
    tr = GANTrainer(tc, vae_sd if wganvae else None, device="cpu")
    ts, again = _port_state(tr, tc, js), _port_state(tr, tc, js)
    rng = np.random.RandomState(1)
    batches, draws = [], []
    for k in range(steps):
        batch = {"image": (rng.rand(N, 32, 32, 3) * 255).astype(np.uint8),
                 "rna_data": rng.randn(N, VAE_KW["rna_features"]).astype(F32)}
        key = jax.random.key(100 + k)
        js, jmet = jtr._train_step(js, {**batch, "rng": key}, jtr.vae_variables)
        batches.append(batch)
        draws.append(_draws(key, jc))
        ts, tmet = tr.train_step_eager(ts, batch, draws=draws[-1])
        for name in jmet:
            np.testing.assert_allclose(_np(tmet[name]), np.asarray(jmet[name]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {k} {name}")
    assert ts.step == int(js.step) and ts.g_opt.count == int(js.g_opt[0].count)
    assert ts.d_opt.count == int(js.d_opt[0].count)
    keys = ("image", "rna_data") + tuple(draws[0])
    tables = {k: torch.stack([torch.as_tensor((b | d)[k]) for b, d in zip(batches, draws)]) for k in keys}
    sums = torch.zeros(len(tr.metric_keys()))
    tr.run_steps(again, tables, given_batch, steps, sums=sums)
    for x, y in zip((*ts.generator.parameters(), *ts.discriminator.parameters(), *ts.d_opt.nu),
                    (*again.generator.parameters(), *again.discriminator.parameters(), *again.d_opt.nu)):
        assert torch.equal(x, y)
    assert (again.step, again.g_opt.count, again.d_opt.count) == (ts.step, ts.g_opt.count, ts.d_opt.count)
    assert torch.isfinite(sums).all()


def _quality_tool():
    spec = importlib.util.spec_from_file_location("quality_run_torch", REPO / "tools" / "quality_run_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quality_run_steps_per_dispatch_changes_no_number(tmp_path, monkeypatch):
    """``--smoke --device cpu`` with one step a dispatch and with 500: the
    same history bit for bit, and the same final bundle's weights: a step's
    ids depend on the epoch and the step only. The FID probe is replaced by
    a function of G's weights (the real one's Inception set-up is most of
    the smoke run and reads nothing the chunks change)."""
    q = _quality_tool()

    def make_probe(trainer, corpus, expr_dev, args):
        def probe(state, epoch, train_mode=False):
            return float(sum(p.detach().double().abs().sum() for p in state.generator.parameters()))

        probe.floor = 0.0
        probe.sample_grid = lambda state, path, epoch: None
        return probe

    monkeypatch.setattr(q, "make_fid_probe", make_probe)
    out = {}
    for spd in (1, 500):
        wd = tmp_path / str(spd)
        out[spd] = q.main(["--smoke", "--device", "cpu", "--steps_per_dispatch", str(spd), "--workdir", str(wd)])
    keys = ("epoch", "d_loss", "g_loss", "gp", "fid")
    assert [{k: r[k] for k in keys} for r in out[1]["history"]] == \
           [{k: r[k] for k in keys} for r in out[500]["history"]]
    assert out[1]["best"] == out[500]["best"]
    a = torch.load(tmp_path / "1" / "wganvae_last.model", weights_only=True)
    b = torch.load(tmp_path / "500" / "wganvae_last.model", weights_only=True)
    assert all(torch.equal(a["generator"][k], b["generator"][k]) for k in a["generator"])


# ----------------------------------------------------------------- AsyncSaver


def test_async_saver(tmp_path):
    """``tests/test_core.py::test_async_saver``: a second save waits for the
    first, the newest wins; the bundle is byte-equal to ``save_bundle``'s."""
    saver = AsyncSaver()
    p = str(tmp_path / "a.model")
    saver.save_bundle(p, {"x": np.arange(4)}, {"epoch": 1})
    saver.save_bundle(p, {"x": np.arange(4) * 2, "t": torch.arange(3.0)}, {"epoch": 2})  # waits for the first
    saver.wait()
    trees, meta = load_bundle(p)
    assert meta["epoch"] == 2
    np.testing.assert_array_equal(trees["x"], np.arange(4) * 2)
    ref = str(tmp_path / "ref.model")
    save_bundle(ref, {"x": np.arange(4) * 2, "t": torch.arange(3.0)}, {"epoch": 2})
    assert Path(p).read_bytes() == Path(ref).read_bytes()


def test_async_saver_snapshots_before_the_state_moves(tmp_path):
    """``test_async_saver_survives_donation``: the tensors are copied when
    the save is called; an in-place update right after (what the next step
    does to the state) does not reach the file."""
    saver = AsyncSaver()
    x = torch.arange(8, dtype=torch.float32)
    release = threading.Event()
    p = str(tmp_path / "d.model")

    def write(path, tree):
        release.wait(10)
        save_bundle(path, tree, {"epoch": 0})

    saver.save(p, {"x": x}, write)
    x.add_(1.0)  # the next step, in place, while the write is still pending
    release.set()
    saver.wait()
    trees, _ = load_bundle(p)
    np.testing.assert_array_equal(trees["x"], np.arange(8, dtype=np.float32))


def test_async_saver_reraises_the_workers_error(tmp_path):
    saver = AsyncSaver()

    def write(path, tree):
        raise OSError("disk full")

    saver.save(str(tmp_path / "e.model"), {"x": torch.zeros(2)}, write)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()  # raised once


def test_gan_bundle_async_is_byte_equal_to_sync(vae, tmp_path):
    """``GANTrainer.save_model(..., async_=True)``, with a step taken right
    after the call, writes the bytes of the synchronous save of that state."""
    _, tc = _cfgs({"g_ema_decay": 0.99}, {})
    tr = GANTrainer(tc, vae[1], device="cpu")
    st = tr.init_state()
    rng = np.random.RandomState(3)
    batch = {"image": (rng.rand(N, 32, 32, 3) * 255).astype(np.uint8),
             "rna_data": rng.randn(N, VAE_KW["rna_features"]).astype(F32)}
    tr.train_step(st, batch)
    # one file name in two directories: torch.save names the archive's records after the file
    sync_path, async_path = str(tmp_path / "sync" / "gan.model"), str(tmp_path / "async" / "gan.model")
    tr.save_model(st, sync_path, epoch=3)
    tr.save_model(st, async_path, epoch=3, async_=True)
    tr.train_step(st, batch)
    tr.wait_saves()
    assert os.path.getsize(sync_path) > 0
    assert Path(sync_path).read_bytes() == Path(async_path).read_bytes()
