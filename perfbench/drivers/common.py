"""What the drivers share: the port's configurations from a configuration file,
the reference's numerics switches, and the first steps' readings."""

from __future__ import annotations

import contextlib
import gc
from typing import Dict

import torch

from perfbench.core import compare


def gan_config(cfg: dict, batch: int, seed: int):
    from rnagan_tpu_torch.core.config import GANConfig, GANModelConfig, VAEModelConfig

    m, vm, t = cfg["model"], cfg["vae"], cfg["train"]
    model = GANModelConfig(arch=m["arch"], encoding_dims=m["encoding_dims"], out_size=m["out_size"],
                           out_channels=m["out_channels"], step_channels=m["step_channels"],
                           leaky_slope=m["leaky_slope"], disc_last_leaky=m["disc_last_leaky"],
                           compute_dtype=m["compute_dtype"])
    return GANConfig(model=model, loss_type=t["loss_type"], batch_size=batch, g_lr=t["g_lr"], d_lr=t["d_lr"],
                     adam_b1=t["adam_b1"], adam_b2=t["adam_b2"], gp_lambda=t["gp_lambda"],
                     noise_range=t["noise_range"], vae=vae_model_config(vm), seed=seed)


def vae_model_config(vm: dict):
    from rnagan_tpu_torch.core.config import VAEModelConfig

    return VAEModelConfig(rna_features=vm["rna_features"], z_dim=vm["z_dim"],
                          encoder_dims=tuple(vm["encoder_dims"]), decoder_dims=tuple(vm["decoder_dims"]),
                          beta=vm["beta"], dropout_rate=vm["dropout_rate"], leaky_slope=vm["leaky_slope"],
                          compute_dtype=vm["compute_dtype"])


def gan_hp(cfg: dict) -> dict:
    t = cfg["train"]
    return dict(noise_range=t["noise_range"], gp_lambda=t["gp_lambda"], g_lr=t["g_lr"], d_lr=t["d_lr"],
                b1=t["adam_b1"], b2=t["adam_b2"])


@contextlib.contextmanager
def reference_numerics():
    """Float32 products without TF32, as the references state."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(ref: dict, initial: Dict[str, torch.Tensor], stat_names) -> dict:
    """A reference run's readings in the form the program's take (``core/compare.py``)."""
    state = ref["state"]
    out = {"losses": ref["losses"], "grads": compare.norms(ref["first_grads"]),
           "change": compare.change_norms({k: v for k, v in state.items() if k not in stat_names}, initial),
           "stats": compare.change_norms({k: state[k] for k in stat_names}, initial)}
    if "stats_after" in ref:
        out["stats1"] = compare.change_norms(ref["stats_after"][0], initial)
    return out
