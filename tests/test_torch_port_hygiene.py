"""The port's package rules: no JAX or pandas (nor PIL or h5py at import), CUDA
by default, no library optimizer."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rnagan_tpu.eval import generate as jgen
from rnagan_tpu_torch.cli import betavae_train
from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEConfig, VAEModelConfig
from rnagan_tpu_torch.eval import generate as tgen
from rnagan_tpu_torch.eval.serving import make_serving_fn
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.models.dcgan import DCGANGenerator
from rnagan_tpu_torch.train.gan_trainer import GANTrainer
from rnagan_tpu_torch.train.vae_trainer import VAETrainer

REPO = Path(__file__).resolve().parent.parent
SMALL = GANConfig(
    model=GANModelConfig(out_size=16, encoding_dims=8, step_channels=4, compute_dtype="float32"),
    vae=VAEModelConfig(rna_features=16, z_dim=8, encoder_dims=(12, 8), decoder_dims=(12,)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import rnagan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rnagan_tpu_torch.__path__, "rnagan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "rnagan_tpu"))
print(" ".join(names))
assert not bad, bad
"""

#: the same, with the forbidden packages made unimportable first: a module
#: that imports one of them (even lazily, at import time) fails here
_IMPORT_ALL_BLOCKED = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "rnagan_tpu"):
    sys.modules[name] = None
""" + _IMPORT_ALL

#: subpackages of the port and modules of each that must be among the imported
SUBPACKAGES = {"core": ("checkpoint", "msgpack"),
               "data": ("rna", "store", "tiles", "patches", "tiler", "synthetic"),
               "cli": ("betavae_train", "gan_train", "generate", "fid", "sample", "interpolate",
                       "representation", "metrics", "tile", "main", "ml_experiment", "export_torch"),
               "eval": ("interpolate", "fid", "representation"), "losses": ("vae",),
               "models": ("betavae", "inception", "sagan", "biggan", "resnet", "fusion"),
               "optim": ("scheduled", "adam"),
               "train": ("vae_trainer", "ml_experiment", "ssl_trainer", "fusion_trainer", "step_graph"),
               "kernels": ("fused_adam",), "utils": ("images",),
               "parallel": ("mesh", "collectives", "launch")}

#: the card's machine has neither: a module imports them inside the function that reads files
_IMPORT_ALL_NO_PIL_H5PY = """
import sys
for name in ("PIL", "h5py"):
    sys.modules[name] = None
""" + _IMPORT_ALL


def _import_all(code):
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 50  # every module of the port
    for sub, modules in SUBPACKAGES.items():
        for module in modules:
            assert f"rnagan_tpu_torch.{sub}.{module}" in names, (sub, module)


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has JAX loaded by the conftest):
    importing every module of the port loads no jax/flax/optax/msgpack/
    pandas/rnagan_tpu module."""
    _import_all(_IMPORT_ALL)


def test_port_imports_with_forbidden_packages_blocked():
    """Every module of the port imports with jax, flax, optax, msgpack,
    pandas and rnagan_tpu made unimportable (``sys.modules[name] = None``)."""
    _import_all(_IMPORT_ALL_BLOCKED)


#: the port's quality-run tool, imported with the forbidden packages blocked:
#: it imports the port, numpy and the standard library only
_IMPORT_TOOL_BLOCKED = """
import importlib.util, sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "rnagan_tpu"):
    sys.modules[name] = None
spec = importlib.util.spec_from_file_location("quality_run_torch", "tools/quality_run_torch.py")
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
args = tool.parse_args(["--smoke", "--device", "cpu"])
import rnagan_tpu_torch.cli.export_torch, rnagan_tpu_torch.data.synthetic
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "rnagan_tpu"))
assert not bad, bad
print(args.size, args.genes)
"""


def test_quality_tool_imports_no_jax():
    """``tools/quality_run_torch.py`` imports (and parses its flags) with
    jax, flax, optax, msgpack, pandas and rnagan_tpu unimportable."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_TOOL_BLOCKED], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["32", "64"]


#: the JAX repository's experiment tools, ported, each run at its ``--smoke`` shapes on the CPU
#: with the forbidden packages blocked; the A26/A27 tools read a workdir of
#: random-init checkpoints written here first (``GANTrainer.save_model``,
#: ``save_state_dict``). ``demo_e2e_torch`` only imports and parses its flags:
#: its step 1 writes PNG slides with PIL.
_EXPERIMENT_TOOL_BLOCKED = """
import importlib, os, sys, tempfile
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "rnagan_tpu"):
    sys.modules[name] = None
sys.path.insert(0, "tools")
import torch
torch.set_num_threads(2)
name = sys.argv[1]
tool = importlib.import_module(name)
tmp = tempfile.mkdtemp()
if name == "demo_e2e_torch":
    args = tool.build_parser().parse_args([tmp, "--device", "cpu"])
else:
    args = tool.parse_args(["--smoke", "--device", "cpu"])
    argv = ["--smoke", "--device", "cpu"]
    if name in ("representation_run_torch", "conditioning_panel_torch", "ml_experiment_run_torch"):
        import quality_run_torch, representation_run_torch as rep
        from rnagan_tpu_torch.core.checkpoint import save_state_dict
        from rnagan_tpu_torch.models.betavae import BetaVAE
        from rnagan_tpu_torch.train.gan_trainer import GANTrainer
        vae_cfg = quality_run_torch.vae_model_config(args)
        vae_sd = BetaVAE(vae_cfg, seed=0).state_dict()
        save_state_dict(os.path.join(tmp, "vae_pretrain.pt"), vae_sd)
        for ckpt, critic in (("wganvae_proj", "projection"), ("wganvae", "unconditional")):
            cfg, gan_cfg = rep.gan_configs(args, vae_cfg, critic)
            tr = GANTrainer(cfg, vae_sd, device="cpu")
            tr.save_model(tr.init_state(), os.path.join(tmp, ckpt + "_last.model"))
        tr = GANTrainer(gan_cfg, device="cpu")
        tr.save_model(tr.init_state(), os.path.join(tmp, "wgan_last.model"))
        argv += ["--workdir", tmp, "--out", os.path.join(tmp, "out.json" if name.startswith("ml") else "out")]
    elif name == "make_lmdb_corpus_torch":
        argv += ["--out", os.path.join(tmp, "corpus")]
    else:
        argv += ["--corpus", os.path.join(tmp, "corpus"), "--out", os.path.join(tmp, "dp.json")]
    tool.main(argv)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "rnagan_tpu"))
assert not bad, bad
print("ok", args.device)
"""

EXPERIMENT_TOOLS = ("representation_run_torch", "conditioning_panel_torch", "ml_experiment_run_torch",
                "make_lmdb_corpus_torch", "data_plane_run_torch", "demo_e2e_torch")


@pytest.mark.parametrize("tool", EXPERIMENT_TOOLS)
def test_experiment_tools_run_without_jax(tool):
    """Each ported experiment tool imports, parses its flags and runs its
    ``--smoke`` entry (the demo: imports and parses) with jax, flax, optax,
    msgpack, pandas and rnagan_tpu unimportable."""
    env = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", _EXPERIMENT_TOOL_BLOCKED, tool], cwd=REPO, capture_output=True,
                         text=True, timeout=180, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-2:] == ["ok", "cpu"]


def _jax_flags(name):
    """``{flag: default}`` of the JAX tool's ``add_argument`` calls, read from its source."""
    flags = {}
    for node in ast.walk(ast.parse((REPO / "tools" / f"{name}.py").read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords if k.arg in ("default", "action")}
            flags[node.args[0].value] = kw.get("default", False if kw.get("action") == "store_true" else None)
    return flags


#: flags of a JAX tool that its port leaves out: ``--compile_only`` warms the
#: JAX tool's persistent compilation cache, which the card's process has no
#: counterpart of (a CUDA graph is captured in the process that replays it)
DROPPED_FLAGS = {"quality_run_torch": ("--compile_only",)}


@pytest.mark.parametrize("tool", [t for t in EXPERIMENT_TOOLS if t != "demo_e2e_torch"] + ["quality_run_torch"])
def test_experiment_tools_keep_the_jax_flags(tool):
    """Every flag of the JAX twin with its default, ``--device`` (default
    ``cuda``) for ``--platform``; the only other flags are ``--device`` and
    ``--smoke`` (which the JAX quality tool has too); the quality tool leaves
    out ``--compile_only`` and nothing else."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(tool, REPO / "tools" / f"{tool}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    port = {a.option_strings[0]: a.default for a in module.build_parser()._actions if a.option_strings}
    port.pop("-h")
    jax_flags = _jax_flags(tool.removesuffix("_torch"))
    jax_flags.pop("--platform", None)
    for name in DROPPED_FLAGS.get(tool, ()):
        jax_flags.pop(name)
    assert port.pop("--device") == "cuda" and port.pop("--smoke") is False
    assert jax_flags.pop("--smoke", False) is False
    assert port == jax_flags


def test_port_imports_without_pil_or_h5py():
    """Every module of the port imports with PIL and h5py unimportable: the
    JPEG and HDF5 readers import them inside their functions."""
    _import_all(_IMPORT_ALL_NO_PIL_H5PY)


@pytest.mark.parametrize("entry", ["tile_classifier", "simclr", "fusion", "cli", "main"])
def test_resnet_entry_points_default_to_cuda(entry, tmp_path):
    """The ML, SimCLR and fusion trainers and ``ml-experiment`` (its module
    and through ``main``) resolve the device first: with no card they raise
    unless given the CPU, before a tile is read."""
    if torch.cuda.is_available():
        pytest.skip("the card is present: the CUDA default does not raise here")
    from rnagan_tpu_torch.cli import main as cli_main
    from rnagan_tpu_torch.cli import ml_experiment
    from rnagan_tpu_torch.core.config import MLConfig
    from rnagan_tpu_torch.train.fusion_trainer import FusionConfig, FusionTrainer
    from rnagan_tpu_torch.train.ml_experiment import TileClassifierTrainer
    from rnagan_tpu_torch.train.ssl_trainer import SimCLRTrainer, SSLConfig

    argv = ["--csv", str(tmp_path / "absent.csv")]
    call = {"tile_classifier": lambda: TileClassifierTrainer(MLConfig()),
            "simclr": lambda: SimCLRTrainer(SSLConfig()), "fusion": lambda: FusionTrainer(FusionConfig()),
            "cli": lambda: ml_experiment.main(argv),
            "main": lambda: cli_main.main(["ml-experiment", *argv])}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the CUDA default does not raise here")
    vae_sd = BetaVAE(SMALL.vae).state_dict()
    g_sd = DCGANGenerator(SMALL.model).state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.Synthesizer(SMALL, vae_sd, g_sd)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serving_fn(SMALL.model, g_sd)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GANTrainer(SMALL, vae_sd)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VAETrainer(VAEConfig(model=SMALL.vae))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        betavae_train.main(["--config", str(REPO / "configs" / "betavae_tissues.json")])


@pytest.mark.parametrize("entry", ["inception_extractor", "gan_train", "fid", "sample", "interpolate",
                                   "representation", "main_gan_train", "sagan_trainer", "biggan_trainer",
                                   "synthetic_corpus", "export_torch", "main_export_torch", "quality_run_torch",
                                   *EXPERIMENT_TOOLS])
def test_data_and_fid_entry_points_default_to_cuda(entry):
    """The Inception extractor, the SAGAN and BigGAN trainers, the synthetic
    corpus, the CLIs that take ``--device``, the quality-run tool and the
    ported experiment tools resolve the device first: with no card they
    raise unless given the CPU, before any data is read or written
    (``metrics`` and ``tile`` run on the host and take no device)."""
    if torch.cuda.is_available():
        pytest.skip("the card is present: the CUDA default does not raise here")
    import dataclasses

    import importlib.util

    from rnagan_tpu_torch.cli import export_torch, fid, gan_train, interpolate, main, representation, sample
    from rnagan_tpu_torch.data.synthetic import SyntheticCorpus
    from rnagan_tpu_torch.eval.fid import InceptionExtractor

    def tool_module(name):
        spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    tool = tool_module("quality_run_torch")

    config = str(REPO / "configs" / "gan_run_lung.json")
    vae = str(REPO / "configs" / "betavae_tissues.json")

    def trainer(arch):
        model = dataclasses.replace(SMALL.model, arch=arch, num_classes=2 if arch == "biggan" else 0,
                                    attn_size=8)
        return lambda: GANTrainer(dataclasses.replace(SMALL, model=model), BetaVAE(SMALL.vae).state_dict())

    call = {"inception_extractor": InceptionExtractor,
            "gan_train": lambda: gan_train.main(["--config", config]),
            "fid": lambda: fid.main(["--config", config]),
            "sample": lambda: sample.main(["--config", vae, "--checkpoint", "absent.pt"]),
            "interpolate": lambda: interpolate.main(["--config", vae, "--checkpoint", "absent.ckpt"]),
            "representation": lambda: representation.main(["--config", config, "--checkpoint", "a.model",
                                                            "--checkpoint2", "b.model", "--vae", "v.pt"]),
            "main_gan_train": lambda: main.main(["gan-train", "--config", config, "--gan_type", "biggan"]),
            "sagan_trainer": trainer("sagan"), "biggan_trainer": trainer("biggan"),
            "synthetic_corpus": lambda: SyntheticCorpus(n_slides=2, tiles_per_slide=2, n_genes=8, size=16),
            "export_torch": lambda: export_torch.main(["--config", config, "--checkpoint", "a.model",
                                                       "--out", "b.model"]),
            "main_export_torch": lambda: main.main(["export-torch", "--config", config, "--checkpoint", "a.model",
                                                    "--out", "b.msgpack", "--to_native"]),
            "quality_run_torch": lambda: tool.main(["--smoke"]),
            "demo_e2e_torch": lambda: tool_module(entry).main([str(REPO / "runs" / "absent_demo")]),
            "data_plane_run_torch": lambda: tool_module(entry).main(["--smoke", "--corpus", "absent_corpus"])}.get(
                entry, lambda: tool_module(entry).main(["--smoke"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_training_path_uses_no_library_optimizer():
    """The port's optimizer is the K3 kernel: no module of the package calls
    ``torch.optim``, a ``torch._foreach_*`` op or a fused library optimizer."""
    for path in sorted((REPO / "rnagan_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert not (node.attr == "optim" and getattr(node.value, "id", None) == "torch"), path
                assert not node.attr.startswith("_foreach_"), path
            elif isinstance(node, ast.ImportFrom):
                assert not (node.module or "").startswith("torch.optim"), path
            elif isinstance(node, ast.Import):
                assert not any(a.name.startswith("torch.optim") for a in node.names), path
            elif isinstance(node, ast.keyword):
                assert node.arg != "fused", path


def test_synthesize_needs_exactly_one_noise_source():
    synth = tgen.Synthesizer(SMALL, BetaVAE(SMALL.vae).state_dict(),
                             DCGANGenerator(SMALL.model).state_dict(), device="cpu")
    gene = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="exactly one"):
        synth.synthesize(gene)
    with pytest.raises(ValueError):  # three patients cannot fill two rows
        synth.synthesize(torch.zeros(3, 16), 2, seed=0)
    assert synth.synthesize(gene, seed=0).shape == (2, 16, 16, 3)


@pytest.mark.parametrize("images", [
    np.linspace(-1.2, 1.2, 24, dtype=np.float32).reshape(2, 2, 2, 3),
    np.linspace(0.0, 1.0, 24, dtype=np.float32).reshape(2, 2, 2, 3),
    np.arange(24, dtype=np.uint8).reshape(2, 2, 2, 3) * 10,
])
def test_unit_range_helpers_match_jax(images):
    np.testing.assert_allclose(tgen.to_unit_range(torch.from_numpy(images)).numpy(),
                               jgen.to_unit_range(images), atol=1e-7)
    if images.dtype == np.float32:
        np.testing.assert_allclose(tgen.unnormalize(torch.from_numpy(images)).numpy(),
                                   jgen.unnormalize(images), atol=1e-7)
