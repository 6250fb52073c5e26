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
