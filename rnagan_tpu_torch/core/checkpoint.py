"""Best-on-validation checkpoints of the β-VAE (the port's counterpart of
``rnagan_tpu/core/checkpoint.py::BestKeeper``).

The reference writes ``torch.save(state_dict)`` files, ``model_dict_best.pt``
and ``model_last.pt`` (``betaVAE.py:270-275``). :class:`BestKeeper` writes the
same: plain reference-layout state_dicts, which
``convert.load_betavae_state_dict`` and ``GANConfig(vae_checkpoint=...)`` read
unchanged. What a state_dict cannot hold goes beside it:

* ``scaler.npz``, the fitted normalization :class:`~rnagan_tpu_torch.data.rna.Scaler`
  (the JAX package bundles it into each checkpoint; the reference re-fits it
  in every script);
* ``model_dict_best.json``, the best epoch, its validation loss and the
  caller's metadata.

Every file is written to a temporary name and renamed, so a crash never
leaves a torn checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

SCALER_NAME = "scaler.npz"


def _atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """``torch.save`` of CPU copies, atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    _atomic(path, lambda tmp: torch.save(cpu, tmp))


class BestKeeper:
    """Best and last checkpoints in ``save_dir``."""

    def __init__(self, save_dir: str, best_name: str = "model_dict_best.pt",
                 last_name: str = "model_last.pt"):
        self.save_dir = save_dir
        self.best_path = os.path.join(save_dir, best_name)
        self.last_path = os.path.join(save_dir, last_name)
        self.scaler_path = os.path.join(save_dir, SCALER_NAME)
        self.best_loss = float("inf")
        self.best_epoch = -1
        os.makedirs(save_dir, exist_ok=True)

    def _save_scaler(self, scaler) -> None:
        if scaler is not None:
            _atomic(self.scaler_path, scaler.save)

    def update(self, epoch: int, val_loss: float, state_dict: Dict[str, torch.Tensor], scaler=None,
               metadata: Optional[Dict[str, Any]] = None) -> bool:
        """Write the best files when ``val_loss`` improves on the best so far."""
        improved = val_loss < self.best_loss
        if improved:
            self.best_loss, self.best_epoch = val_loss, epoch
            save_state_dict(self.best_path, state_dict)
            meta = {**(metadata or {}), "epoch": epoch, "val_loss": val_loss}
            meta_path = os.path.splitext(self.best_path)[0] + ".json"

            def write(tmp):
                with open(tmp, "w") as f:
                    json.dump(meta, f)

            _atomic(meta_path, write)
            self._save_scaler(scaler)
        return improved

    def save_last(self, state_dict: Dict[str, torch.Tensor], scaler=None) -> None:
        save_state_dict(self.last_path, state_dict)
        self._save_scaler(scaler)
