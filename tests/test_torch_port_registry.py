"""The GAN arch registry (``models/registry.py``): the classes it builds,
the traits that replaced the trainer's and the CLIs' rules by arch name, the
CLIs' one ``GANModelConfig`` helper, and the direction of the models'
imports."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from rnagan_tpu_torch.cli.common import gan_model_config
from rnagan_tpu_torch.core.config import GANModelConfig
from rnagan_tpu_torch.models import biggan, biggan_pub, dcgan, registry, sagan

REPO = Path(__file__).resolve().parent.parent
ARCHS = ("dcgan", "dcgan_up", "condgan", "sagan", "biggan", "biggan_pub")
#: the table of classes the registry held before it read the classes' ``ARCHS``
CLASSES = {
    "dcgan": (dcgan.DCGANGenerator, dcgan.DCGANDiscriminator),
    "dcgan_up": (dcgan.DCGANUpGenerator, dcgan.DCGANDiscriminator),
    "condgan": (dcgan.ConditionalDCGANGenerator, dcgan.ConditionalDCGANDiscriminator),
    "sagan": (sagan.SAGANGenerator, sagan.SAGANDiscriminator),
    "biggan": (biggan.BigGANGenerator, biggan.BigGANDiscriminator),
    "biggan_pub": (biggan_pub.PublishedBigGANGenerator, biggan_pub.PublishedBigGANDiscriminator)}
#: a run's JSON: two CSVs, so the class-conditional archs take two classes
RUN_JSON = {"path_csv": ["a.csv", "b.csv"], "img_size": 32, "encoding_dims": 40, "compute_dtype": "float32"}


def _name_rules(arch: str, num_classes: int):
    """What the trainer and the two CLIs decided from the arch's name:
    whether a step reads labels, whether the nets carry spectral-norm state,
    and the CLIs' defaults for the keys a run's JSON may leave out."""
    published = arch == "biggan_pub"
    labels = arch in ("condgan", "biggan_pub") or (arch == "biggan" and num_classes > 0)
    defaults = {"step_channels": 32 if arch in ("condgan", "sagan") else 64, "attn_size": 64 if published else 32,
                **({"embed_dim": 128} if published else {})}
    return labels, arch in ("sagan", "biggan", "biggan_pub"), defaults


def _gan_train_config(config, arch, critic):
    """``cli/gan_train.py``'s ``GANModelConfig`` as it was built by name."""
    conditional = arch in ("condgan", "biggan", "biggan_pub")
    published = arch == "biggan_pub"
    return GANModelConfig(
        arch=arch, out_size=int(config.get("img_size", 256)), encoding_dims=int(config.get("encoding_dims", 2048)),
        step_channels=int(config.get("step_channels", 32 if arch in ("condgan", "sagan") else 64)),
        num_classes=len(config["path_csv"]) if conditional else 0,
        attn_size=int(config.get("attn_size", 64 if published else 32)),
        **({"embed_dim": int(config.get("embed_dim", 128))} if published else {}),
        critic=critic, compute_dtype=str(config.get("compute_dtype", "bfloat16")))


def _generate_config(config, arch):
    """``cli/generate.py``'s ``GANModelConfig`` as it was built by name."""
    return GANModelConfig(
        arch=arch, out_size=int(config.get("img_size", 256)), encoding_dims=int(config.get("encoding_dims", 2048)),
        step_channels=int(config.get("step_channels", 32 if arch in ("condgan", "sagan") else 64)),
        num_classes=len(config.get("path_csv", ())) if arch in ("condgan", "biggan") else 0,
        attn_size=int(config.get("attn_size", 32)), compute_dtype=str(config.get("compute_dtype", "bfloat16")))


@pytest.mark.parametrize("num_classes", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_registry_classes_and_traits_match_the_name_rules(arch, num_classes):
    cfg = GANModelConfig(arch=arch, num_classes=num_classes, out_size=32, step_channels=4, encoding_dims=40,
                         attn_size=16, embed_dim=8, compute_dtype="float32")
    gen, disc = CLASSES[arch]
    assert (registry.GENERATORS[arch], registry.DISCRIMINATORS[arch]) == (gen, disc)
    if arch != "biggan_pub" or num_classes:  # biggan_pub refuses to be built without classes
        assert type(registry.make_generator(cfg)) is gen
        assert type(registry.make_discriminator(cfg)) is disc
    labels, sn, defaults = _name_rules(arch, num_classes)
    assert (registry.takes_labels(cfg), registry.spectral_norm(cfg), registry.cli_defaults(arch)) == \
           (labels, sn, defaults)
    for config in (RUN_JSON, {**RUN_JSON, "step_channels": 8, "attn_size": 16, "embed_dim": 6},
                   {**RUN_JSON, "path_csv": ["a.csv"]}):
        assert gan_model_config(config, arch, critic="projection") == _gan_train_config(config, arch, "projection")
        if arch != "biggan_pub":  # generate refuses it
            assert gan_model_config(config, arch) == _generate_config(config, arch)
    with pytest.raises(ValueError, match="is not one of"):
        registry.takes_labels(dataclasses.replace(cfg, arch="stylegan"))


def test_dcgan_imports_none_of_the_nets_built_on_it():
    """The imports point one way: ``models/dcgan.py`` names none of
    ``sagan``, ``biggan``, ``biggan_pub`` or ``registry``, at its top or in a
    function, and importing it in a fresh interpreter loads none of them."""
    later = {"sagan", "biggan", "biggan_pub", "registry"}
    tree = ast.parse((REPO / "rnagan_tpu_torch" / "models" / "dcgan.py").read_text())
    named = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            named |= {(node.module or "").split(".")[-1], *(a.name for a in node.names)}
        elif isinstance(node, ast.Import):
            named |= {a.name.split(".")[-1] for a in node.names}
    assert not named & later, named & later
    code = ("import sys, rnagan_tpu_torch.models.dcgan\n"
            f"print(sorted(m for m in {sorted(later)!r} if 'rnagan_tpu_torch.models.' + m in sys.modules))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["[]"]
