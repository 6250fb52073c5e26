"""A frozen copy of the procedural H&E corpus's arithmetic (``data/synthetic.py``
of the port, as of the benchmark's first version), so the reference renders
the quality run's real tiles itself.

The corpus draws from Philox4x32-10 with key ``(corpus seed, stream)`` and
counter ``(row, slot, block, 0)``: a row is a global tile id, a slide or a
step, a slot one of the draws, a block four consecutive elements. Uniforms
take a word's top 24 bits, normals come from pairs of words by Box-Muller.
Slide latents are a per-tissue centre plus a per-slide scatter; a tile is
stroma waves, a union of soft elliptical nuclei and white lumen blobs,
composited in RGB with chroma noise. The nucleus union is a product of
``(1 - mask)`` over the nuclei one at a time (the port multiplies chunks).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from perfbench.reference.draws import MASK, philox4x32, unit

LATENT = 8
STREAM_SLIDES, STREAM_RENDER, STREAM_BATCH_IDS = 0, 3, 4
MAX_NUCLEI = 96
#: the corpus's tissues, and the ids past a slide's training tiles kept for held-out tiles:
#: a tile's global id is ``tile + slide * (tiles_per_slide + HELDOUT_SPAN)``
TISSUES, HELDOUT_SPAN = 2, 64


def _words(seed: int, stream: int, rows: torch.Tensor, slots: Sequence[Tuple[int, int]]):
    device = rows.device
    blocks = [(slot, -(-count // 4)) for slot, count in slots]
    c1 = torch.cat([torch.full((b,), slot, dtype=torch.int64, device=device) for slot, b in blocks])
    c2 = torch.cat([torch.arange(b, dtype=torch.int64, device=device) for _, b in blocks])
    c0 = (rows.to(torch.int64) & MASK)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = torch.stack(philox4x32((c0, c1[None], c2[None], zero), (int(seed), int(stream))), dim=-1)
    out, start = [], 0
    for (_, b), (_, count) in zip(blocks, slots):
        out.append(words[:, start:start + b].reshape(len(rows), 4 * b)[:, :count])
        start += b
    return out


def _normal(words: torch.Tensor) -> torch.Tensor:
    u = unit(words).unflatten(-1, (-1, 2))
    r = torch.sqrt(-2.0 * torch.log1p(-u[..., 0]))
    theta = (2.0 * math.pi) * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1).flatten(-2)


def draws(seed: int, stream: int, rows: torch.Tensor, spec: Dict[str, Tuple[int, Tuple[int, ...], str]]):
    """``{name: (R, *shape)}`` for ``{name: (slot, shape, "uniform" | "normal")}``."""
    sizes = [(slot, 2 * -(-math.prod(shape) // 2)) for slot, shape, _ in spec.values()]
    out = {}
    for (name, (_, shape, kind)), w in zip(spec.items(), _words(seed, stream, rows, sizes)):
        x = unit(w) if kind == "uniform" else _normal(w)
        out[name] = x[:, :math.prod(shape)].reshape(len(rows), *shape)
    return out


def slide_latents(seed: int, n_slides: int, n_tissues: int, device) -> torch.Tensor:
    """(n_slides, LATENT): ``1.2 * centre[tissue] + 0.45 * scatter``, tissue = slide mod n_tissues."""
    centers, scatter = (draws(seed, STREAM_SLIDES, torch.arange(n, device=device), {"x": (slot, (LATENT,), "normal")})["x"]
                        for slot, n in ((0, n_tissues), (1, n_slides)))
    tissue = torch.arange(n_slides, device=device) % n_tissues
    return (centers * 1.2)[tissue] + 0.45 * scatter


def batch_ids(key: int, batch: int, steps: int, n_slides: int, tiles_per_slide: int, device):
    """(steps, batch) slide and tile ids of steps ``[0, steps)`` under ``key``."""
    d = draws(key, STREAM_BATCH_IDS, torch.arange(steps, device=device),
              {"slide": (0, (batch,), "uniform"), "tile": (1, (batch,), "uniform")})
    sl = (d["slide"] * n_slides).to(torch.int64).clamp_(max=n_slides - 1)
    ti = (d["tile"] * tiles_per_slide).to(torch.int64).clamp_(max=tiles_per_slide - 1)
    return sl, ti


def _disc(yy, xx, cy, cx, ry, rx, theta, sharp: float = 1.5):
    ct, st = torch.cos(theta), torch.sin(theta)
    dy, dx = yy - cy, xx - cx
    u = (ct * dx + st * dy) / rx
    v = (-st * dx + ct * dy) / ry
    return torch.sigmoid((1.0 - (u * u + v * v)) * sharp * 4.0)


def render(seed: int, s: torch.Tensor, tile_ids: torch.Tensor, size: int, m: int = MAX_NUCLEI) -> torch.Tensor:
    """Tiles of latents ``s`` (B, LATENT) and global ids (B,): float32 (B, size, size, 3) in [-1, 1]."""
    d = draws(seed, STREAM_RENDER, tile_ids,
              {"kf": (0, (6, 2), "uniform"), "ph": (1, (6,), "uniform"), "centers": (2, (m, 2), "uniform"),
               "present": (3, (m,), "uniform"), "radii": (4, (m,), "uniform"), "thetas": (5, (m,), "uniform"),
               "lcenters": (6, (4, 2), "uniform"), "lpresent": (7, (4,), "uniform"),
               "noise": (8, (size, size, 3), "normal")})
    sig, dev = torch.sigmoid, s.device
    col = lambda x: x[:, None, None]  # noqa: E731
    density = 0.25 + 0.7 * sig(s[:, 0])
    radius = (3.0 + 4.0 * sig(s[:, 1])) * size / 64.0
    hema = 0.35 + 0.5 * sig(s[:, 2])
    tex_scale = 1.0 + 3.0 * sig(s[:, 3])
    lumen_amt = 0.6 * sig(s[:, 4])
    elong = 1.0 + 1.5 * sig(s[:, 5])
    eosin = 0.55 + 0.4 * sig(s[:, 6])
    chroma = 0.02 + 0.05 * sig(s[:, 7])
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")

    kf = (d["kf"] * 2.0 - 1.0) * col(tex_scale) * 2 * math.pi / size
    ph = d["ph"] * (2.0 * math.pi)
    waves = torch.sin(kf[:, :, 0, None, None] * yy + kf[:, :, 1, None, None] * xx + ph[:, :, None, None])
    stroma = 0.5 + 0.5 * torch.tanh(waves.mean(1) * 2.0)

    present = (d["present"] < density[:, None]).to(torch.float32)
    centers, radii, thetas = d["centers"] * float(size), radius[:, None] * (d["radii"] * 0.7 + 0.65), d["thetas"] * math.pi
    clear = torch.ones_like(stroma)
    for k in range(m):
        ry = radii[:, k, None, None]
        mask = _disc(yy, xx, centers[:, k, 0, None, None], centers[:, k, 1, None, None], ry, ry * col(elong),
                     thetas[:, k, None, None])
        clear = clear * (1.0 - mask * present[:, k, None, None])
    nuclei = 1.0 - clear

    lpresent = (d["lpresent"] < lumen_amt[:, None]).to(torch.float32)
    lc = d["lcenters"] * float(size)
    blobs = _disc(yy, xx, lc[:, :, 0, None, None], lc[:, :, 1, None, None], size * 0.11, size * 0.14,
                  torch.tensor(0.3, device=dev)) * lpresent[:, :, None, None]
    lumen = 1.0 - torch.prod(1.0 - blobs, dim=1)

    stroma_rgb = torch.stack([0.92 - 0.10 * stroma, 0.60 - 0.18 * stroma * col(eosin), 0.75 - 0.08 * stroma], -1)
    nuc_rgb = torch.stack([0.30 * (1 - hema) + 0.22, 0.16 + 0.08 * (1 - hema), 0.45 + 0.25 * hema], -1)[:, None, None, :]
    nuclei, lumen = nuclei[..., None], lumen[..., None]
    img = stroma_rgb * (1 - nuclei) + nuc_rgb * nuclei
    img = img * (1 - lumen) + 0.97 * lumen
    return torch.clamp(img + col(chroma)[..., None] * d["noise"], 0.0, 1.0) * 2.0 - 1.0
