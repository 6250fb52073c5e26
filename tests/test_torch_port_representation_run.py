"""The conditioning proof's tools on the port (``tools/representation_run_torch.py``,
``tools/conditioning_panel_torch.py``) against the JAX package, on the CPU.

* Slice parity at float32 on fixed inputs: the same small VAE and G (weights
  moved by the converters), the same real tiles (numpy), and one fixed
  linear feature map (pixels -> 64 features, nonnegative weights) handed to
  both packages' ``mean_activation`` in place of InceptionV3. The real row
  comes through each package's ``compute_representations``; the RNA-GAN
  rows (population and reference mode) and the GAN row through each
  package's pieces (``encode_z_mean``, the infused noise, G in eval mode,
  ``to_unit_range``, ``mean_activation``), JAX's uniforms and normals drawn
  with ``jax.random`` here and handed to the port. Rows agree within
  1e-5 x max|ref| + 1e-6, and ``distance_statistics`` on them give equal
  dicts: the shares exactly, the distances to the 4 decimals the function
  rounds to, give or take that last digit (``_same_statistics``).
* The z-sensitivity record against the JAX tool's own statements, read
  from ``tools/representation_run.py`` with ``ast`` and run on the same arrays.
* The held-out tile ids, and ``--smoke`` runs of both tools whose JSON keys
  are the JAX tool's (read from its source with ``ast``; the JAX tool is
  never run).
"""

import ast
import json
import os
import struct
import sys
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_parity import jax_generator_variables, jax_vae_variables

from rnagan_tpu.core import config as jcfg
from rnagan_tpu.eval import generate as jgen
from rnagan_tpu.eval import representation as jrep
from rnagan_tpu.losses import rna_infusion as jinf
from rnagan_tpu.models.betavae import BetaVAE as JaxBetaVAE
from rnagan_tpu.models.dcgan import make_generator
from rnagan_tpu.train.gan_trainer import GANTrainer as JaxGANTrainer
from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core import config as tcfg
from rnagan_tpu_torch.core.checkpoint import save_state_dict
from rnagan_tpu_torch.eval import generate as tgen
from rnagan_tpu_torch.eval import representation as trep
from rnagan_tpu_torch.losses import rna_infusion as tinf
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.train.gan_trainer import GANTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)
import conditioning_panel_torch as panel  # noqa: E402
import quality_run_torch  # noqa: E402
import representation_run_torch as rep  # noqa: E402

VAE_KW = dict(rna_features=20, z_dim=16, encoder_dims=(24, 16), decoder_dims=(24,), compute_dtype="float32")
G_KW = dict(out_size=32, encoding_dims=16, step_channels=8, compute_dtype="float32")
R = 0.3  # noise range
PATIENTS, TILES, FEATURES = 4, 6, 64
F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ shared helpers


def source_keys(path, func="main"):
    """``{dotted name: keys}`` that ``func`` in ``path`` writes into dicts: dict
    literals assigned to a name (and their literal sub-dicts), subscript
    assignments (``result["meta"]["x"] = ...`` adds ``x`` to ``result.meta``)
    and ``setdefault`` keys; f-string keys and loop-variable keys are
    expanded over a ``for`` over a literal tuple."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = defaultdict(set)

    def key_of(node, env):
        if isinstance(node, ast.Constant):
            return [node.value]
        if isinstance(node, ast.Name) and node.id in env:
            return env[node.id]
        if isinstance(node, ast.JoinedStr):
            out = [""]
            for part in node.values:
                vals = [part.value] if isinstance(part, ast.Constant) else env.get(part.value.id, [])
                out = [o + str(v) for o in out for v in vals]
            return out
        return []

    def add_dict(name, d, env):
        for k, v in zip(d.keys, d.values):
            for kk in (key_of(k, env) if k is not None else []):
                keys[name].add(kk)
                if isinstance(v, ast.Dict):
                    add_dict(f"{name}.{kk}", v, env)

    def loop_env(node, env):
        elts = node.iter.elts if isinstance(node.iter, ast.Tuple) else []
        if isinstance(node.target, ast.Name) and all(isinstance(e, ast.Constant) for e in elts):
            return {**env, node.target.id: [e.value for e in elts]}
        if isinstance(node.target, ast.Tuple) and elts and all(isinstance(e, ast.Tuple) for e in elts):
            env = dict(env)
            for j, t in enumerate(node.target.elts):
                if isinstance(t, ast.Name) and all(isinstance(e.elts[j], ast.Constant) for e in elts):
                    env[t.id] = [e.elts[j].value for e in elts]
            return env
        return env

    def visit(node, env):
        if isinstance(node, ast.For):
            env = loop_env(node, env)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and isinstance(node.value, ast.Dict):
                    add_dict(t.id, node.value, env)
                elif isinstance(t, ast.Subscript):
                    parts = []
                    while isinstance(t, ast.Subscript):
                        parts.insert(0, key_of(t.slice, env))
                        t = t.value
                    if isinstance(t, ast.Name) and all(parts):
                        prefix = t.id + "".join("." + p[0] for p in parts[:-1])
                        for k in parts[-1]:
                            keys[prefix].add(k)
                            if isinstance(node.value, ast.Dict):
                                add_dict(f"{prefix}.{k}", node.value, env)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "setdefault"
                and isinstance(node.func.value, ast.Name) and node.args and isinstance(node.args[0], ast.Constant)):
            keys[node.func.value.id].add(node.args[0].value)
        for child in ast.iter_child_nodes(node):
            visit(child, env)

    visit(fn, {})
    return {k: sorted(v) for k, v in keys.items()}


def smoke_workdir(path):
    """What ``--smoke`` runs of the downstream tools read: ``vae_pretrain.pt``
    (``save_state_dict`` of a small random-init VAE) and the ``wganvae_proj``,
    ``wganvae`` and ``wgan`` bundles (``GANTrainer.save_model`` of init
    states), at the tools' ``--smoke`` shapes."""
    path = str(path)
    args = rep.parse_args(["--smoke", "--device", "cpu"])
    vae_cfg = quality_run_torch.vae_model_config(args)
    vae_sd = BetaVAE(vae_cfg, seed=0).state_dict()
    save_state_dict(os.path.join(path, "vae_pretrain.pt"), vae_sd)
    for name, critic in (("wganvae_proj", "projection"), ("wganvae", "unconditional")):
        cfg, gan_cfg = rep.gan_configs(args, vae_cfg, critic)
        tr = GANTrainer(cfg, vae_sd, device="cpu")
        tr.save_model(tr.init_state(), os.path.join(path, f"{name}_last.model"))
    tr = GANTrainer(gan_cfg, device="cpu")
    tr.save_model(tr.init_state(), os.path.join(path, "wgan_last.model"))
    return path


# ------------------------------------------------------------ slice parity


@pytest.fixture(scope="module")
def nets():
    """Both packages' VAE and two G's (the RNA-GAN and the control) on one
    set of numpy weights, and the port's trainers holding them."""
    jv_cfg, jg_cfg = jcfg.VAEModelConfig(**VAE_KW), jcfg.GANModelConfig(**G_KW)
    tv_cfg, tg_cfg = tcfg.VAEModelConfig(**VAE_KW), tcfg.GANModelConfig(**G_KW)
    vae_vars = jax_vae_variables(jv_cfg, seed=0)
    g = {arm: jax_generator_variables(jg_cfg, seed=s) for arm, s in (("rnagan", 1), ("gan", 2))}
    vae_sd = convert.betavae_state_dict_from_jax(tv_cfg, vae_vars)
    trainers, states = {}, {}
    for arm, loss in (("rnagan", "wganvae"), ("gan", "wgan")):
        tr = GANTrainer(tcfg.GANConfig(model=tg_cfg, loss_type=loss, vae=tv_cfg, noise_range=R),
                        vae_sd if loss == "wganvae" else None, device="cpu")
        st = tr.init_state()
        st.generator.load_state_dict(convert.generator_state_dict_from_jax(tg_cfg, *g[arm]))
        st.g_stats = [(m.clone(), v.clone()) for m, v in st.generator.bn_stats()]
        trainers[arm], states[arm] = tr, st
    rng = np.random.RandomState(0)
    rna = rng.randn(12, VAE_KW["rna_features"]).astype(F32)
    return dict(jv_cfg=jv_cfg, jg_cfg=jg_cfg, vae_vars=vae_vars, g=g, trainers=trainers, states=states, rna=rna,
                # each patient's tiles a shade of its own, so the real rows differ by more than noise
                real=(rng.rand(PATIENTS, TILES, 32, 32, 3) + np.arange(PATIENTS)[:, None, None, None, None]
                      ).astype(F32) / PATIENTS * 2.0 - 1.0,
                weight=rng.rand(32 * 32 * 3, FEATURES).astype(F32) / 1000.0)


def _extractors(weight):
    """The fixed linear feature map as each package's extractor."""
    w_t = torch.from_numpy(weight)

    def jax_ext(images, batch_size):
        return np.asarray(images, F32).reshape(len(images), -1) @ weight

    def port_ext(images, batch_size):
        return torch.as_tensor(images).float().reshape(len(images), -1) @ w_t

    return jax_ext, port_ext


def _jax_rows(nets, jax_ext, mode, keys):
    """Mean activations of each patient's generated tiles, the JAX package's pieces."""
    jvae, gen = JaxBetaVAE(nets["jv_cfg"]), make_generator(nets["jg_cfg"])
    arm = "gan" if mode == "gan" else "rnagan"
    params, stats = nets["g"][arm]
    pop = jinf.z_population_stats(jvae, nets["vae_vars"], nets["rna"], batch_size=8)
    rows = []
    for i, key in enumerate(keys):
        d = G_KW["encoding_dims"]
        if mode == "gan":
            noise = jax.random.normal(key, (TILES, d), jnp.float32)
        else:
            z = jinf.encode_z_mean(jvae, nets["vae_vars"], jnp.asarray(nets["rna"][i:i + 1]))
            if mode == "population":
                noise = jinf.infused_noise_population(key, z, *map(jnp.asarray, pop), TILES, R)
            else:
                noise = jinf.infused_noise(key, jnp.broadcast_to(z, (TILES, d)), R)
        imgs = gen.apply({"params": params, "batch_stats": stats}, noise, train=False)
        rows.append(jrep.mean_activation(jgen.to_unit_range(np.asarray(imgs)), jax_ext))
    return np.stack(rows)


def _port_rows(nets, port_ext, mode, keys):
    """The same with the port's pieces, on JAX's uniforms (or normals)."""
    arm = "gan" if mode == "gan" else "rnagan"
    tr, st = nets["trainers"][arm], nets["states"][arm]
    d = G_KW["encoding_dims"]
    if mode == "population":
        tr.set_z_population(nets["rna"])
    rows = []
    for i, key in enumerate(keys):
        if mode == "gan":
            noise = torch.from_numpy(np.array(jax.random.normal(key, (TILES, d), jnp.float32)))
        else:
            u = torch.from_numpy(np.array(jax.random.uniform(key, (TILES, d), jnp.float32, -R, R)))
            z = tinf.encode_z_mean(tr.vae, torch.from_numpy(nets["rna"][i:i + 1]))
            noise = (tinf.infused_noise_population(z, *tr.z_pop, TILES, u=u, noise_range=R)
                     if mode == "population" else tinf.infused_noise(z, TILES, u=u, noise_range=R))
        with torch.no_grad():
            imgs = st.generator.forward_stats(noise, st.g_stats, False)[0].permute(0, 2, 3, 1)
        rows.append(trep.mean_activation(tgen.to_unit_range(imgs), port_ext))
    return np.stack(rows)


def _real_rows(nets, jax_ext, port_ext):
    """The real row of each package's ``compute_representations`` (its
    generated rows, drawn from each package's own streams, are not compared)."""
    patients = [f"p{i}" for i in range(PATIENTS)]
    real = {p: nets["real"][i] for i, p in enumerate(patients)}
    gene = {p: nets["rna"][i] for i, p in enumerate(patients)}
    jtr = JaxGANTrainer(jcfg.GANConfig(model=nets["jg_cfg"], loss_type="wganvae", vae=nets["jv_cfg"],
                                       noise_range=R), vae_variables=nets["vae_vars"])
    params, stats = nets["g"]["rnagan"]
    jstate = jtr.init_state().replace(g_params=params, g_stats=stats)
    jreps = jrep.compute_representations(patients, real.get, gene.get, jtr, jstate, jtr, jstate,
                                         key=jax.random.key(1234), tiles_per_patient=TILES, extractor=jax_ext)
    tr, st = nets["trainers"]["rnagan"], nets["states"]["rnagan"]
    tr.set_z_population(nets["rna"])
    treps = trep.compute_representations(patients, real.get, gene.get, tr, st, nets["trainers"]["gan"],
                                         nets["states"]["gan"], seed=1234, tiles_per_patient=TILES,
                                         extractor=port_ext, condition_mode="population")
    assert {k: v.shape for k, v in treps.items()} == {k: (PATIENTS, FEATURES) for k in ("real", "rnagan", "gan")}
    return jreps["real"], treps["real"]


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max() + 1e-6)


def _same_statistics(got, ref):
    """Equal dicts: the same keys, the shares and the chance level exactly
    equal, the distances and the margin equal to the 4 decimals
    ``distance_statistics`` rounds them to, give or take that last digit (rows
    that agree to float32 rounding can straddle a rounding boundary)."""
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if k.startswith("frac_") or k == "chance_level":
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1.0001e-4, (k, got[k], v)


def test_representation_rows_and_statistics_match_jax(nets):
    """Real, RNA-GAN (population and reference mode) and GAN rows of 4
    patients x 6 tiles within 1e-5 x max|ref| + 1e-6; ``distance_statistics``
    with tissue labels equal, dict for dict."""
    jax_ext, port_ext = _extractors(nets["weight"])
    j_real, t_real = _real_rows(nets, jax_ext, port_ext)
    _close(t_real, j_real)
    labels = np.arange(PATIENTS) % 2
    keys = [jax.random.fold_in(jax.random.key(7), i) for i in range(PATIENTS)]
    for mode in ("population", "reference", "gan"):
        j_rows, t_rows = _jax_rows(nets, jax_ext, mode, keys), _port_rows(nets, port_ext, mode, keys)
        _close(t_rows, j_rows)
        assert np.abs(j_rows - j_real).max() > 1e-3  # the comparison is not of the real row with itself
        _same_statistics(trep.distance_statistics(t_real, t_rows, labels),
                         jrep.distance_statistics(j_real, j_rows, labels))
        # on the same rows the two functions agree exactly
        assert trep.distance_statistics(j_real, j_rows, labels) == jrep.distance_statistics(j_real, j_rows, labels)
    # the reference mode cancels one patient's broadcast z: every patient's tiles are alike
    j_ref = _jax_rows(nets, jax_ext, "reference", [keys[0]] * PATIENTS)
    assert np.abs(j_ref - j_ref[0]).max() <= 1e-5 * np.abs(j_ref).max()


def _jax_z_sensitivity(per_patient, rerun):
    """The JAX tool's z-sensitivity statements (``cross``, ``noise_delta`` and
    ``result["z_sensitivity"]``), read from its source and run here."""
    with open(os.path.join(TOOLS, "representation_run.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")

    def wanted(stmt):
        if not isinstance(stmt, ast.Assign):
            return False
        t = stmt.targets[0]
        return ((isinstance(t, ast.Name) and t.id in ("cross", "noise_delta"))
                or (isinstance(t, ast.Subscript) and getattr(t.slice, "value", None) == "z_sensitivity"))

    body = [s for s in main.body if wanted(s)]
    assert len(body) == 3
    env = {"np": np, "per_patient": per_patient, "rerun": rerun, "n_zp": len(per_patient), "n_zt": len(rerun),
           "result": {}}
    exec(compile(ast.Module(body=body, type_ignores=[]), "representation_run.py", "exec"), env)
    return env["result"]["z_sensitivity"]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_z_sensitivity_matches_the_jax_tool(as_tensor):
    rng = np.random.RandomState(11)
    per_patient = [rng.rand(16, 8, 8, 3).astype(F32) for _ in range(5)]
    per_patient[3] = per_patient[2] + 1e-3  # a near-duplicate pair, as a conditioning-blind generator gives
    rerun = rng.rand(16, 8, 8, 3).astype(F32)
    ref = _jax_z_sensitivity(per_patient, rerun)
    got = rep.z_sensitivity([torch.from_numpy(x) for x in per_patient] if as_tensor else per_patient,
                            torch.from_numpy(rerun) if as_tensor else rerun)
    assert got == ref
    assert ref["patients"] == 5 and ref["tiles"] == 16


def test_heldout_ids_are_the_jax_tools():
    """``tiles_per_slide + (offset + arange(count)) % HELDOUT_SPAN``, wrapping
    past the held-out span; the renders are the corpus's own."""
    from rnagan_tpu_torch.data.synthetic import SyntheticCorpus

    corpus = SyntheticCorpus(n_slides=3, tiles_per_slide=10, n_genes=8, size=16, device="cpu")
    for slide, offset, count in ((0, 0, 5), (2, 60, 10), (1, 3, 70)):
        sl, ti = rep.heldout_ids(corpus, slide, offset, count)
        ref = corpus.tiles_per_slide + (offset + jnp.arange(count, dtype=jnp.int32)) % 64
        np.testing.assert_array_equal(ti, np.asarray(ref))
        np.testing.assert_array_equal(sl, np.full(count, slide))
        assert ti.min() >= 10 and ti.max() < 10 + corpus.HELDOUT_SPAN
    torch.testing.assert_close(rep.render_heldout(corpus, 2, 60, 6), corpus.render(*rep.heldout_ids(corpus, 2, 60, 6)),
                               rtol=0, atol=0)


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", head[16:24])


def test_smoke_runs_write_the_jax_tools_keys(tmp_path):
    """``--smoke --device cpu``: the representation run (projection arm), then
    ``--ceiling_only`` merging into its JSON, then the panel for both arms."""
    wd = smoke_workdir(tmp_path / "wd")
    out = str(tmp_path / "reps")
    common = ["--smoke", "--device", "cpu", "--workdir", wd, "--out", out]
    result = rep.main([*common, "--rna_name", "wganvae_proj", "--critic", "projection"])
    jkeys = source_keys(os.path.join(TOOLS, "representation_run.py"))
    assert sorted(result) == jkeys["result"]
    assert sorted(result["meta"]) == jkeys["result.meta"]
    assert sorted(result["z_sensitivity"]) == jkeys["result.z_sensitivity"]
    stat_keys = sorted(jrep.distance_statistics(np.eye(3), np.eye(3), np.arange(3)))
    for name in ("rnagan_population", "rnagan_reference_mode", "gan_control", "real_vs_real_ceiling"):
        assert sorted(result[name]) == stat_keys
        assert all(np.isfinite(v) for v in result[name].values())
    zs = result["z_sensitivity"]
    assert zs["patients"] == 4 and zs["tiles"] == 16 and zs["cross_patient_pixel_delta_same_noise"] > 0
    for sub in ("", "reference_mode"):
        for source in ("real", "rnagan", "gan"):
            assert np.load(os.path.join(out, sub, f"representations_{source}.npy")).shape == (4, 2048)
    with open(os.path.join(out, "distance_stats.json")) as f:
        assert json.load(f) == result

    again = rep.main([*common, "--rna_name", "wganvae_proj", "--critic", "projection", "--ceiling_only"])
    assert sorted(again) == sorted(result)
    assert {k: again[k] for k in ("meta", "gan_control")} == {k: result[k] for k in ("meta", "gan_control")}
    assert again["z_sensitivity"] == result["z_sensitivity"]  # the same seeds, the same tiles

    paths = panel.main(["--smoke", "--device", "cpu", "--workdir", wd, "--out", str(tmp_path / "grids")])
    assert sorted(paths) == ["wganvae", "wganvae_proj"]
    for path in paths.values():
        assert path.endswith("_patient_panel.png")
        assert _png_size(path) == (4 * (32 + 2) + 2, 4 * (32 + 2) + 2)  # 4 patients x (1 real + 3 fakes)


def test_smoke_defaults_match_the_quality_tools():
    """The ``--smoke`` corpus and VAE are ``quality_run_torch --smoke``'s, so a
    smoke quality run's workdir feeds these tools."""
    q = quality_run_torch.parse_args(["--smoke"])
    for tool in (rep, panel):
        a = tool.parse_args(["--smoke"])
        assert (a.genes, a.size) == (q.genes, q.size)
    assert quality_run_torch.vae_model_config(q) == quality_run_torch.smoke_vae(q)[1]
