"""The numbers that decide ``correct``: gaps between the program's readings and the reference's.

Training cells compare, over the run's first steps (all through the window's
own call and feed):

* ``loss_gap``: each step's losses, ``|program - reference| / max(|reference|,
  scale)``, the worst step and loss; ``scale`` is the reference's mean
  ``|D score|`` of the step for the GAN and the loss itself for the β-VAE;
* ``grad_gap``: the first step's gradient as the optimizer got it, per leaf
  (``mu / (1 - b1)`` after one step), ``|‖g‖ - ‖g_ref‖| / max(‖g_ref‖,
  median leaf ‖g_ref‖)``, the worst leaf;
* ``change_gap``: the same of each parameter's change ``‖p_3 - p_0‖`` after
  the steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf with none moves by round-off alone);
* ``stats_gap``: the same of each BatchNorm running statistic's change;
* each leaf number also as its median leaf (``*_median``), and
  ``loss1_gap``, the first step's losses alone: the numbers that stay steady
  from seed to seed where a kink (a LeakyReLU at 0) turns the worst leaf and
  the later steps on the rounding of one sample.

A cell's ``limits/<cell>.json`` names the numbers it compares.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Sequence

import torch

#: a leaf whose reference gradient is below this share of the median leaf's is left out of ``change_gap``
MOVED_SHARE = 1e-3


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().float())) for k, v in tensors.items()}


def change_norms(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(after[k].detach().float() - before[k].detach().float())) for k in after}


def loss_gap(prog: Sequence[Dict[str, float]], ref: Sequence[Dict[str, float]], keys: Iterable[str]) -> float:
    keys = list(keys)
    worst = 0.0
    for p, r in zip(prog, ref, strict=True):
        for k in keys:
            worst = max(worst, abs(p[k] - r[k]) / max(abs(r[k]), r["scale"], 1e-30))
    return worst


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str] = None) -> List[float]:
    """Each leaf's ``|prog - ref| / max(ref, median leaf ref)``."""
    leaves = sorted(ref) if leaves is None else leaves
    if not leaves:
        return [0.0]
    floor = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in leaves]


def moved_leaves(ref_grads: Dict[str, float]) -> List[str]:
    floor = statistics.median(ref_grads.values())
    return sorted(k for k, v in ref_grads.items() if v >= MOVED_SHARE * floor)


def training_numbers(prog: dict, ref: dict, loss_keys: Iterable[str], first_keys: Iterable[str] = (),
                     score_keys: Iterable[str] = ()) -> Dict[str, float]:
    """``prog`` and ``ref`` hold ``losses`` (per step), ``grads`` (first-step
    norms per leaf), ``change`` and ``stats`` (change norms per leaf after the
    last step) and optionally ``stats1`` (after the first). Each leaf number
    comes as its worst leaf and as its median leaf (``*_median``);
    ``loss1_gap`` is the first step's ``first_keys``, ``score1_gap`` its
    ``score_keys``."""
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"], loss_keys),
           "loss1_gap": loss_gap(prog["losses"][:1], ref["losses"][:1], first_keys or loss_keys)}
    if score_keys:
        out["score1_gap"] = loss_gap(prog["losses"][:1], ref["losses"][:1], score_keys)
    for name, key, leaves in (("grad", "grads", None), ("change", "change", moved_leaves(ref["grads"])),
                              ("stats", "stats", None), ("stats1", "stats1", None)):
        if key not in prog:
            continue
        gaps = leaf_gaps(prog[key], ref[key], leaves)
        out[f"{name}_gap"], out[f"{name}_gap_median"] = max(gaps), statistics.median(gaps)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """Each number beside its limit (a number passes at or below it)."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}


def passes(checks: Dict[str, dict]) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
