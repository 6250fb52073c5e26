"""Procedural H&E corpus on the device (port of ``rnagan_tpu/data/synthetic.py``).

Slide latents ``s`` drive both tile morphology (stroma texture, nuclei,
lumen, stain) and a 19,198-gene expression profile, so RNA infusion carries
information about the tiles. The corpus is the input of the quality run
(``tools/quality_run_torch.py``); nothing on the production data path reads it.

Each JAX function is split into its draws and a deterministic function of
them: ``sample_slides_from_draws``, ``render_batch_from_draws`` (and
``render_tile_from_draws``), ``make_gene_map_from_draws`` and
``expression_from_slides_from_draws`` take the arrays that the JAX function
draws from ``jax.random`` (the tests hand them JAX's) and compute the rest
with the JAX function's arithmetic. The nucleus union, a ``lax.scan`` over
96 ellipses in JAX, is a product of ``(1 - m)`` over chunks of nuclei here:
the same function up to the order of its rounding.

The port's own draws (``sample_slides``, ``render_batch``, ``make_gene_map``,
``expression_from_slides``) match ``jax.random``'s in distribution, not in
bits. They come from the Philox4x32-10 stream of ``kernels/infusion.py`` in
int64 tensor ops, with key ``(corpus seed, stream)`` and counter ``(row, slot,
block, 0)``: a row is a global tile id (or a slide, gene-map row or step),
a slot one of the JAX function's draws and a block four consecutive
elements (one Philox output each). Uniforms take a word's top 24 bits,
normals come from pairs of them by Box-Muller. So a tile is a function of
(corpus seed, global tile id) only, a batch draws in one Philox call, and
the CPU and the card draw the same bits.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rnagan_tpu_torch.core import profiling
from rnagan_tpu_torch.core.device import resolve_device
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.kernels.infusion import _MASK, philox4x32

LATENT = 8

#: the Philox streams of a corpus seed
STREAM_SLIDES, STREAM_GENE_MAP, STREAM_EXPRESSION, STREAM_RENDER, STREAM_BATCH_IDS = range(5)

#: elements of one nucleus chunk's (B, K, S, S) temporaries (128 MiB in float32)
CHUNK_ELEMENTS = 1 << 25


class SlideParams(NamedTuple):
    """Per-slide latents (all shaped (n_slides, ...))."""

    s: torch.Tensor       # (n, LATENT) morphology/expression latent
    tissue: torch.Tensor  # (n,) int64 tissue id


# ------------------------------------------------------------------- draws


def philox_words(seed: int, stream: int, rows: torch.Tensor,
                 slots: Sequence[Tuple[int, int]]) -> list:
    """Philox output words for each row of ``rows`` (int64 ids) and each
    ``(slot, count)``: a list of (R, count) int64 tensors holding uint32
    values, from one Philox call over counters ``(row, slot, block, 0)``."""
    device = rows.device
    blocks = [(slot, -(-count // 4)) for slot, count in slots]
    c1 = torch.cat([torch.full((b,), slot, dtype=torch.int64, device=device) for slot, b in blocks])
    c2 = torch.cat([torch.arange(b, dtype=torch.int64, device=device) for _, b in blocks])
    c0 = (rows.to(torch.int64) & _MASK)[:, None]
    words = torch.stack(philox4x32((c0, c1[None], c2[None], 0), (int(seed), int(stream))), dim=-1)
    out, start = [], 0
    for (_, b), (_, count) in zip(blocks, slots):
        out.append(words[:, start:start + b].reshape(len(rows), 4 * b)[:, :count])
        start += b
    return out


def to_uniform(words: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 uniforms in [0, 1) from their top 24 bits."""
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


def to_normal(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (last dimension even) -> standard normals by Box-Muller:
    each pair (a, b) gives ``r cos(2 pi u_b)`` and ``r sin(2 pi u_b)`` with
    ``r = sqrt(-2 log(1 - u_a))``."""
    u = to_uniform(words).unflatten(-1, (-1, 2))
    r = torch.sqrt(-2.0 * torch.log1p(-u[..., 0]))
    theta = (2.0 * math.pi) * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1).flatten(-2)


def _draws(seed: int, stream: int, rows: torch.Tensor, spec: Dict[str, Tuple[int, Tuple[int, ...], str]]):
    """``{name: tensor (R, *shape)}`` for ``spec`` ``{name: (slot, shape,
    "uniform" | "normal")}``, one Philox call."""
    sizes = {name: (slot, 2 * -(-math.prod(shape) // 2)) for name, (slot, shape, _) in spec.items()}
    words = philox_words(seed, stream, rows, list(sizes.values()))
    out = {}
    for (name, (_, shape, kind)), w in zip(spec.items(), words):
        x = to_uniform(w) if kind == "uniform" else to_normal(w)
        out[name] = x[:, :math.prod(shape)].reshape(len(rows), *shape)
    return out


def _rows(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


# ------------------------------------------------------------------ slides


def sample_slides_from_draws(n_slides: int, n_tissues: int, centers: torch.Tensor,
                             scatter: torch.Tensor) -> SlideParams:
    """Slide latents from the draws ``centers`` (n_tissues, LATENT) and
    ``scatter`` (n_slides, LATENT), standard normals: a per-tissue mean plus
    a per-slide scatter, so tissues form separated clusters in morphology and
    expression."""
    tissue = torch.arange(n_slides, dtype=torch.int64, device=centers.device) % n_tissues
    s = (centers * 1.2)[tissue] + 0.45 * scatter
    return SlideParams(s=s, tissue=tissue)


def sample_slides(seed: int, n_slides: int, n_tissues: int = 2, device="cuda") -> SlideParams:
    """:func:`sample_slides_from_draws` on Philox draws (stream ``STREAM_SLIDES``:
    slot 0 a row per tissue, slot 1 a row per slide), on ``device``."""
    device = resolve_device(device)
    centers, scatter = (_draws(seed, STREAM_SLIDES, _rows(n, device), {"x": (slot, (LATENT,), "normal")})["x"]
                        for slot, n in ((0, n_tissues), (1, n_slides)))
    return sample_slides_from_draws(n_slides, n_tissues, centers, scatter)


# --------------------------------------------------------------- rendering


def _soft_disc(yy, xx, cy, cx, ry, rx, theta, sharp=1.5):
    """Soft elliptical blob mask in [0, 1]; the arguments broadcast."""
    ct, st = torch.cos(theta), torch.sin(theta)
    dy, dx = yy - cy, xx - cx
    u = (ct * dx + st * dy) / rx
    v = (-st * dx + ct * dy) / ry
    d = u * u + v * v
    return torch.sigmoid((1.0 - d) * sharp * 4.0)


def tile_draw_spec(size: int, max_nuclei: int) -> Dict[str, Tuple[int, Tuple[int, ...], str]]:
    """A tile's draws, ``{name: (slot, shape, kind)}``, in the order and with
    the shapes of ``render_tile``'s ``jax.random`` calls (slot i is its key
    ``ks[i]``; slot 8 is the chroma noise's ``fold_in(key, 99)``). Every
    uniform is on [0, 1): :func:`tile_draws` scales them to the JAX call's range."""
    m = max_nuclei
    return {"kf": (0, (6, 2), "uniform"), "ph": (1, (6,), "uniform"),
            "centers": (2, (m, 2), "uniform"), "present": (3, (m,), "uniform"),
            "radii": (4, (m,), "uniform"), "thetas": (5, (m,), "uniform"),
            "lcenters": (6, (4, 2), "uniform"), "lpresent": (7, (4,), "uniform"),
            "noise": (8, (size, size, 3), "normal")}


def tile_draws(seed: int, tile_ids: torch.Tensor, size: int, max_nuclei: int) -> Dict[str, torch.Tensor]:
    """The draws of :func:`render_batch_from_draws` for global ``tile_ids``
    (B,), on their device: Philox stream ``STREAM_RENDER``, each scaled as
    ``render_tile`` scales its own (``kf`` on [-1, 1), ``ph`` on [0, 2 pi),
    ``centers`` and ``lcenters`` on [0, size), ``radii`` on [0.65, 1.35),
    ``thetas`` on [0, pi); ``present``/``lpresent`` on [0, 1), ``noise``
    standard normal)."""
    d = _draws(seed, STREAM_RENDER, tile_ids, tile_draw_spec(size, max_nuclei))
    d["kf"] = d["kf"] * 2.0 - 1.0
    d["ph"] = d["ph"] * (2.0 * math.pi)
    d["centers"] = d["centers"] * float(size)
    d["radii"] = d["radii"] * 0.7 + 0.65
    d["thetas"] = d["thetas"] * math.pi
    d["lcenters"] = d["lcenters"] * float(size)
    return d


def _nuclei_clear(yy, xx, centers, present, radii, thetas, elong):
    """prod over nuclei of ``1 - soft_disc * present``: (B, S, S), in chunks
    of nuclei so a chunk's temporaries stay within ``CHUNK_ELEMENTS``."""
    b, m = present.shape
    size = yy.shape[-1]
    chunk = max(1, min(m, CHUNK_ELEMENTS // max(b * size * size, 1)))
    clear = None
    col = xx[0]  # (S,): dx depends on the column only, dy on the row only
    row = yy[:, 0]
    for k in range(0, m, chunk):
        sl = slice(k, k + chunk)
        cy, cx = centers[:, sl, 0, None, None], centers[:, sl, 1, None, None]
        ry = radii[:, sl, None, None]
        rx = ry * elong[:, None, None, None]
        th = thetas[:, sl, None, None]
        ct, st = torch.cos(th), torch.sin(th)
        dx = col[None, None, None, :] - cx                       # (B, K, 1, S)
        dy = row[None, None, :, None] - cy                       # (B, K, S, 1)
        u = (ct * dx + st * dy).div_(rx)
        v = (-st * dx + ct * dy).div_(ry)
        d = u.mul_(u).add_(v.mul_(v))
        mask = torch.sigmoid_(d.neg_().add_(1.0).mul_(6.0)).mul_(present[:, sl, None, None])
        part = torch.prod(mask.neg_().add_(1.0), dim=1)
        clear = part if clear is None else clear.mul_(part)
    return clear


def render_batch_from_draws(s: torch.Tensor, draws: Dict[str, torch.Tensor], size: int = 256,
                            max_nuclei: int = 96) -> torch.Tensor:
    """Tiles from slide latents ``s`` (B, LATENT) and their draws (each
    ``render_tile`` draw with a leading B, as :func:`tile_draws` makes them):
    float32 (B, size, size, 3) in [-1, 1]."""
    if draws["centers"].shape[1] != max_nuclei or draws["noise"].shape[1] != size:
        raise ValueError("draws do not match size and max_nuclei")
    sig = torch.sigmoid
    dev = s.device
    col = lambda x: x[:, None, None]  # noqa: E731  (B,) -> (B, 1, 1)
    density = 0.25 + 0.7 * sig(s[:, 0])            # fraction of max_nuclei present
    radius = (3.0 + 4.0 * sig(s[:, 1])) * size / 64.0
    hema = 0.35 + 0.5 * sig(s[:, 2])               # purple intensity of nuclei
    tex_scale = 1.0 + 3.0 * sig(s[:, 3])           # stroma texture frequency
    lumen_amt = 0.6 * sig(s[:, 4])                 # white lumen coverage
    elong = 1.0 + 1.5 * sig(s[:, 5])               # nuclear elongation
    eosin = 0.55 + 0.4 * sig(s[:, 6])              # stroma pinkness
    chroma_noise = 0.02 + 0.05 * sig(s[:, 7])

    grid = torch.arange(size, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")

    # stroma: a few random-phase plane waves -> smooth eosin texture
    kf = draws["kf"] * col(tex_scale) * 2 * math.pi / size                         # (B, 6, 2)
    waves = torch.sin(kf[:, :, 0, None, None] * yy + kf[:, :, 1, None, None] * xx
                      + draws["ph"][:, :, None, None])
    stroma = 0.5 + 0.5 * torch.tanh(waves.mean(1) * 2.0)                            # (B, S, S)
    del waves

    # nuclei: union of soft ellipses
    present = (draws["present"] < density[:, None]).to(torch.float32)
    radii = radius[:, None] * draws["radii"]
    nuclei = 1.0 - _nuclei_clear(yy, xx, draws["centers"], present, radii, draws["thetas"], elong)

    # lumen: few big white blobs
    lpresent = (draws["lpresent"] < lumen_amt[:, None]).to(torch.float32)
    lc = draws["lcenters"]
    theta = torch.full((), 0.3, dtype=torch.float32, device=dev)  # a fill: no host copy inside a capture
    m = _soft_disc(yy, xx, lc[:, :, 0, None, None], lc[:, :, 1, None, None],
                   size * 0.11, size * 0.14, theta) * lpresent[:, :, None, None]
    lumen = 1.0 - torch.prod(1.0 - m, dim=1)
    del m

    # composite: white background -> eosin stroma -> hematoxylin nuclei -> lumen
    stroma_rgb = torch.stack([0.92 - 0.10 * stroma,
                              0.60 - 0.18 * stroma * col(eosin),
                              0.75 - 0.08 * stroma], -1)
    nuc_rgb = torch.stack([0.30 * (1 - hema) + 0.22,
                           0.16 + 0.08 * (1 - hema),
                           0.45 + 0.25 * hema], -1)[:, None, None, :]
    nuclei, lumen = nuclei[..., None], lumen[..., None]
    img = stroma_rgb * (1 - nuclei) + nuc_rgb * nuclei
    img = img * (1 - lumen) + 0.97 * lumen
    noise = col(chroma_noise)[..., None] * draws["noise"]
    return torch.clamp(img + noise, 0.0, 1.0) * 2.0 - 1.0


def render_tile_from_draws(s: torch.Tensor, draws: Dict[str, torch.Tensor], size: int = 256,
                           max_nuclei: int = 96) -> torch.Tensor:
    """One tile from latent ``s`` (LATENT,) and ``render_tile``'s draws
    (without a batch dimension): float32 (size, size, 3) in [-1, 1]."""
    batched = {k: torch.as_tensor(v)[None] for k, v in draws.items()}
    return render_batch_from_draws(s[None], batched, size, max_nuclei)[0]


def render_batch(seed: int, slide_s: torch.Tensor, tile_ids: torch.Tensor, size: int = 256,
                 max_nuclei: int = 96) -> torch.Tensor:
    """A batch of tiles: ``slide_s`` (B, LATENT) latents, ``tile_ids`` (B,)
    *globally unique* tile ids (callers pass ``tile + slide * id_stride``, so
    a tile is deterministic: the corpus is addressable like a tile store, not
    a stream). Draws from Philox key ``(seed, STREAM_RENDER)``."""
    tile_ids = torch.as_tensor(tile_ids, device=slide_s.device)
    return render_batch_from_draws(slide_s, tile_draws(seed, tile_ids, size, max_nuclei), size, max_nuclei)


def render_tile(seed: int, tile_id: int, s: torch.Tensor, size: int = 256,
                max_nuclei: int = 96) -> torch.Tensor:
    """One tile of :func:`render_batch`: (size, size, 3)."""
    ids = torch.tensor([tile_id], dtype=torch.int64, device=s.device)
    return render_batch(seed, s[None], ids, size, max_nuclei)[0]


# -------------------------------------------------------------- expression


def make_gene_map_from_draws(w: torch.Tensor, mask_u: torch.Tensor, base: torch.Tensor,
                             zero_p: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The fixed linear map latent -> log-expression and per-gene dropout
    propensity from its draws: ``w`` (LATENT, G) and ``base`` (G,) standard
    normals, ``mask_u`` (G,) uniforms, ``zero_p`` (G,) uniforms on [0, 0.35).
    About 70 % of genes ignore the latent (housekeeping)."""
    mask = (mask_u < 0.3).to(torch.float32)
    return {"W": (w * 0.8) * mask, "base": base * 1.0 + 3.0, "zero_p": zero_p}


def make_gene_map(seed: int, n_genes: int = 19198, device="cuda") -> Dict[str, torch.Tensor]:
    """:func:`make_gene_map_from_draws` on Philox draws (stream ``STREAM_GENE_MAP``), on ``device``."""
    device = resolve_device(device)
    d = _draws(seed, STREAM_GENE_MAP, _rows(LATENT, device), {"w": (0, (n_genes,), "normal")})["w"]
    v = _draws(seed, STREAM_GENE_MAP, _rows(1, device),
               {"mask_u": (1, (n_genes,), "uniform"), "base": (2, (n_genes,), "normal"),
                "zero_p": (3, (n_genes,), "uniform")})
    return make_gene_map_from_draws(d, v["mask_u"][0], v["base"][0], v["zero_p"][0] * 0.35)


def expression_from_slides_from_draws(slide_s: torch.Tensor, gene_map: Dict[str, torch.Tensor],
                                      noise: torch.Tensor, zero_u: torch.Tensor) -> torch.Tensor:
    """(n_slides, n_genes) nonnegative counts with zero-inflation, the GTEx
    CSV shape the data layer expects, from the draws ``noise`` (n, G)
    standard normals and ``zero_u`` (n, G) uniforms."""
    log_mu = gene_map["base"] + slide_s @ gene_map["W"] + 0.25 * noise
    expr = torch.expm1(torch.clamp(log_mu, min=0.0))
    return torch.where(zero_u < gene_map["zero_p"], torch.zeros_like(expr), expr)


def expression_from_slides(seed: int, slide_s: torch.Tensor, gene_map: Dict[str, torch.Tensor]) -> torch.Tensor:
    """:func:`expression_from_slides_from_draws` on Philox draws (stream
    ``STREAM_EXPRESSION``, a row per slide)."""
    g = gene_map["base"].shape[0]
    d = _draws(seed, STREAM_EXPRESSION, _rows(slide_s.shape[0], slide_s.device),
               {"noise": (0, (g,), "normal"), "zero_u": (1, (g,), "uniform")})
    return expression_from_slides_from_draws(slide_s, gene_map, d["noise"], d["zero_u"])


# ------------------------------------------------------------------ corpus


class SyntheticCorpus:
    """Slides, their expression and tile rendering on one device: training
    batches and held-out 'real' tiles for FID. ``device="cuda"``, the
    default, raises without CUDA; the tests pass ``"cpu"``."""

    #: extra per-slide tile-id range reserved for held-out (FID "real") tiles;
    #: the per-slide id stride is tiles_per_slide + HELDOUT_SPAN, so a held-out
    #: index never aliases another slide's training tile
    HELDOUT_SPAN = 64

    def __init__(self, n_slides: int = 200, tiles_per_slide: int = 150, n_genes: int = 19198,
                 size: int = 256, seed: int = 0, n_tissues: int = 2, device="cuda"):
        self.device = resolve_device(device)
        self.n_slides, self.tiles_per_slide, self.size = n_slides, tiles_per_slide, size
        self.seed = int(seed)
        self.id_stride = tiles_per_slide + self.HELDOUT_SPAN
        self.slides = sample_slides(self.seed, n_slides, n_tissues, self.device)
        self.gene_map = make_gene_map(self.seed, n_genes, self.device)
        self.expression = expression_from_slides(self.seed, self.slides.s, self.gene_map)

    def batch_ids(self, key: int, batch: int, steps: int = 1, start: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform (slide, tile) ids of steps ``[start, start + steps)``, each
        (steps, batch) int64 on the corpus's device, from Philox key ``(key,
        STREAM_BATCH_IDS)`` with the step as the counter's row: the same ids
        on every device, and for a step whatever chunk of steps draws it.
        No host synchronization: the ids of a chunk of captured steps are
        drawn at once, and each step's render reads its row on the device."""
        with profiling.span("synthetic.batch_ids"):
            rows = torch.arange(start, start + steps, dtype=torch.int64, device=self.device)
            d = _draws(key, STREAM_BATCH_IDS, rows,
                       {"slide": (0, (batch,), "uniform"), "tile": (1, (batch,), "uniform")})
            sl = (d["slide"] * self.n_slides).to(torch.int64).clamp_(max=self.n_slides - 1)
            ti = (d["tile"] * self.tiles_per_slide).to(torch.int64).clamp_(max=self.tiles_per_slide - 1)
        return sl, ti

    def render(self, slide_ids, tile_ids) -> torch.Tensor:
        """(B, size, size, 3) float32 in [-1, 1] on the corpus's device,
        deterministic per (slide, tile). Tile indices in [0, tiles_per_slide)
        are the training corpus; [tiles_per_slide, tiles_per_slide +
        HELDOUT_SPAN) are held out. Ids already on the device render with
        device ops only, so the render can be captured in a step's CUDA graph
        (its device work begins with the ``render`` mark, ``core/profiling.py``)."""
        profiling.mark("render", self.device)
        sl = torch.as_tensor(slide_ids, dtype=torch.int64).to(self.device)
        ti = torch.as_tensor(tile_ids, dtype=torch.int64).to(self.device)
        return render_batch(self.seed, self.slides.s[sl], ti + sl * self.id_stride, self.size)

    def real_tiles(self, n: int, *, offset: int = 0, seed: int = 7) -> torch.Tensor:
        """Held-out 'real' set for FID: slides drawn with numpy's
        ``RandomState(seed)`` (the JAX package's draw), tile indices past the
        training range. Float [0, 1] NHWC on the corpus's device."""
        rng = np.random.RandomState(seed)
        sl = rng.randint(0, self.n_slides, n)
        ti = self.tiles_per_slide + offset + np.arange(n) % self.HELDOUT_SPAN
        out = [self.render(sl[i:i + 64], ti[i:i + 64]) for i in range(0, n, 64)]
        return (torch.cat(out)[:n] + 1.0) * 0.5

    def batches(self, epoch: int, batch: int, steps: int, seed: int,
                expr_norm: Optional[torch.Tensor] = None):
        """``steps`` training batches of epoch ``epoch``: ``{"image"}`` (batch,
        size, size, 3) rendered on the device, with ``"rna_data"``, the slides'
        rows of ``expr_norm`` (n_slides, genes), when it is given. The (slide,
        tile) ids of the epoch are drawn at once from run ``seed``. This is a
        ``GANTrainer.fit`` ``batches_per_epoch_fn`` once ``epoch`` is bound."""
        sl, ti = self.batch_ids(SeedStream(seed).seed("synthetic_batches", epoch), batch, steps)
        if expr_norm is not None:
            expr_norm = torch.as_tensor(expr_norm, dtype=torch.float32).to(self.device)
        for i in range(steps):
            out = {"image": self.render(sl[i], ti[i])}
            if expr_norm is not None:
                out["rna_data"] = expr_norm[sl[i]]
            yield out
