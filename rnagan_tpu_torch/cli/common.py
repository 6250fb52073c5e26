"""Shared CLI plumbing (port of ``rnagan_tpu/cli/common.py``)."""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np


def dump_pickle(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def add_dist_arguments(p) -> None:
    """``--dist_backend`` of the training CLIs (read only under torchrun)."""
    p.add_argument("--dist_backend", type=str, default="nccl", choices=("nccl", "gloo"),
                   help="process-group backend under torchrun (nccl: one rank a card; gloo: CPU ranks "
                        "with --device cpu, or several ranks on one card)")


def training_mesh(args, mesh_cfg):
    """The training mesh of a CLI: under torchrun the process group is joined
    with ``--dist_backend`` and every rank goes on the data axis; outside it,
    the one-device mesh on ``--device``."""
    from rnagan_tpu_torch.parallel.launch import from_environment
    from rnagan_tpu_torch.parallel.mesh import make_mesh

    from_environment(args.dist_backend)
    return make_mesh(mesh_cfg, args.device)


def gan_model_config(config: Dict[str, Any], arch: str, critic: str = "unconditional"):
    """The ``GANModelConfig`` of ``arch`` from a run's JSON: the arch's keys
    with their defaults (``registry.cli_defaults``), and as ``num_classes``
    the number of ``path_csv`` files where the nets then take labels (the
    reference's biggan wiring's ``n_classes=2``), else 0."""
    import dataclasses

    from rnagan_tpu_torch.core.config import GANModelConfig
    from rnagan_tpu_torch.models import registry

    cfg = GANModelConfig(
        arch=arch,
        out_size=int(config.get("img_size", 256)),
        encoding_dims=int(config.get("encoding_dims", 2048)),
        num_classes=len(config.get("path_csv", ())),
        compute_dtype=str(config.get("compute_dtype", "bfloat16")),
        critic=critic,
        **{k: int(config.get(k, v)) for k, v in registry.cli_defaults(arch).items()},
    )
    return cfg if registry.takes_labels(cfg) else dataclasses.replace(cfg, num_classes=0)


def load_vae(checkpoint: str, model_cfg, device):
    """A trained betaVAE for the sampling CLIs: ``(model in eval mode, scaler
    or None, metadata)``. A ``.pt``/``.pth`` state_dict takes the
    ``scaler.npz`` and ``model_dict_best.json`` written beside it
    (``core/checkpoint.py::BestKeeper``) when they exist; any other file is a
    JAX bundle (``model_best.ckpt``) with its bundled scaler and ``__meta__``."""
    import json

    from rnagan_tpu_torch import convert
    from rnagan_tpu_torch.core.checkpoint import SCALER_NAME, load_bundle
    from rnagan_tpu_torch.data.rna import Scaler
    from rnagan_tpu_torch.models.betavae import BetaVAE

    scaler, meta = None, {}
    if checkpoint.endswith((".pt", ".pth")):
        state_dict = convert.load_betavae_state_dict(checkpoint)
        folder = os.path.dirname(os.path.abspath(checkpoint))
        if os.path.exists(os.path.join(folder, SCALER_NAME)):
            scaler = Scaler.load(os.path.join(folder, SCALER_NAME))
        info = os.path.splitext(checkpoint)[0] + ".json"
        if os.path.exists(info):
            with open(info) as f:
                meta = json.load(f)
    else:
        trees, meta = load_bundle(checkpoint)
        state_dict = convert.betavae_state_dict_from_jax(
            model_cfg, {"params": trees["params"], "batch_stats": trees["batch_stats"]})
        if "scaler" in trees:
            scaler = Scaler.from_state_dict(trees["scaler"])
    model = BetaVAE(model_cfg, device=device)
    model.load_state_dict(state_dict)
    return model.eval(), scaler, meta


def load_gan_dataframe(config: Dict[str, Any]):
    """The slide table of a config: its ``path_csv`` files read in turn and
    concatenated, each row with its CSV's ``patch_data_path`` and the CSV's
    index as an integer tissue label (reference ``histopathology_gan.py:111-129``).
    A :class:`~rnagan_tpu_torch.data.patches.SlideTable`, where the JAX
    package returns a pandas frame."""
    from rnagan_tpu_torch.data.patches import SlideTable
    from rnagan_tpu_torch.data.rna import RNATable

    tables = []
    for tissue_id, (csv_path, patch_path) in enumerate(zip(config["path_csv"], config["patch_data_path"])):
        rna = RNATable.read_csv(csv_path)
        if rna.wsi_file_name is None:
            raise ValueError(f"{csv_path} has no wsi_file_name column")
        n = len(rna)
        tables.append(SlideTable(rna, np.array([patch_path] * n, dtype=object),
                                 np.full(n, tissue_id, np.int64)))
    return SlideTable.concat(tables)


def load_inception_extractor(weights_path: Optional[str] = None, device="cuda"):
    """An ``InceptionExtractor``, from pretrained weights when given (a
    torchvision ``.pt``/``.pth`` state_dict, the reference's FID network, or
    keras arrays ``.npz``/``.h5``), with the input and pool conventions of
    their source; else the seeded default init, which is not a trained
    network (shared by the fid and gan_train CLIs)."""
    from rnagan_tpu_torch.eval.fid import InceptionExtractor

    if weights_path:
        from rnagan_tpu_torch.models.inception import load_fid_inception

        state_dict, kwargs = load_fid_inception(weights_path)
        return InceptionExtractor(state_dict, device=device, **kwargs)
    return InceptionExtractor(None, device=device)
