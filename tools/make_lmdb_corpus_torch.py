"""Materialize the procedural corpus as a reference-layout LMDB tile corpus,
rendered on the card by the PyTorch port.

The counterpart of ``tools/make_lmdb_corpus.py``, on ``rnagan_tpu_torch``
(it imports the port, numpy and the standard library only). It writes the
corpus that ``tools/data_plane_run_torch.py`` trains from through the
production data plane (store -> host decode -> card):

* one ``{out}/slide{s:04d}/slide{s:04d}.db`` a slide, written by the port's
  ``LMDBTileWriter`` (lz4-framed pickled ``(name, bytes, shape)`` BGR values
  and the ``__keys__`` index: what ``cli/tile.py`` writes and
  ``StreamingPatchBatches`` reads), tile names ``slide{s:04d}_patch_{j}``;
* ``{out}/expression.csv``: ``wsi_file_name`` and one ``rna_g{i}`` column a
  gene, written with ``csv``; each float32 value as its shortest decimal,
  which ``float()`` reads back to the same float32.

Tiles are ``SyntheticCorpus.render``'s, rendered on ``--device`` in batches of
``--batch``, cast to uint8 as ``clip((x + 1) * 127.5 + 0.5, 0, 255)``
truncated and stored BGR (the tiler's convention). The job is resumable a
slide at a time: a complete store is kept, a partial one is written anew.

The JAX tool renders on the host CPU to keep its TPU free and has no device
flag; here ``--device`` (default ``cuda``) picks where to render, and the
CPU runs only when asked. ``--smoke`` (tiny shapes) is new. The corpus is
the port's Philox corpus: the same statistics as the JAX tool's, not the
same pixels.

Usage:
  python tools/make_lmdb_corpus_torch.py --slides 200 --tiles_per_slide 600 --out runs/corpus
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def build_parser():
    p = argparse.ArgumentParser(description="write the procedural corpus as LMDB tile stores + expression CSV")
    p.add_argument("--slides", type=int, default=200)
    p.add_argument("--tiles_per_slide", type=int, default=600)
    p.add_argument("--genes", type=int, default=19198)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--corpus_seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--out", default="runs/corpus")
    p.add_argument("--device", default="cuda", help="torch device that renders (default: cuda)")
    p.add_argument("--smoke", action="store_true", help="tiny shapes, CPU-able")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.slides, args.tiles_per_slide, args.genes, args.size, args.batch = 4, 8, 64, 32, 4
    return args


def slide_name(s: int) -> str:
    return f"slide{s:04d}"


def write_expression_csv(path: str, expression: np.ndarray) -> None:
    """The GTEx-layout CSV: ``wsi_file_name`` then ``rna_g{i}``, a row a slide;
    float32 values as their shortest round-tripping decimals."""
    expr = np.asarray(expression, np.float32)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["wsi_file_name", *(f"rna_g{i}" for i in range(expr.shape[1]))])
        for s, row in enumerate(expr):
            writer.writerow([slide_name(s), *row.astype(str)])


def render_uint8_bgr(corpus, slide: int, tile_ids) -> torch.Tensor:
    """Tiles of ``slide`` as stored: uint8, round half up, BGR, on the corpus's device."""
    sl = np.full(len(tile_ids), slide, np.int64)
    imgs = corpus.render(sl, tile_ids)  # [-1, 1] RGB float32
    return torch.clamp((imgs + 1.0) * 127.5 + 0.5, 0.0, 255.0).to(torch.uint8).flip(-1)


def store_is_complete(db_path: str, tiles: int) -> bool:
    from rnagan_tpu_torch.data.store import LMDBTileStore

    try:
        with LMDBTileStore(db_path) as st:
            return len(st.keys()) == tiles
    except (OSError, RuntimeError, ValueError):  # unreadable: rewrite it
        return False


def main(argv=None):
    """Writes the corpus; returns ``{"slides_written", "tiles_written", "seconds", "tiles_per_s"}``."""
    args = parse_args(argv)
    from rnagan_tpu_torch.core.device import resolve_device
    from rnagan_tpu_torch.data.store import LMDBTileWriter
    from rnagan_tpu_torch.data.synthetic import SyntheticCorpus

    dev = resolve_device(args.device)
    corpus = SyntheticCorpus(n_slides=args.slides, tiles_per_slide=args.tiles_per_slide, n_genes=args.genes,
                             size=args.size, seed=args.corpus_seed, device=dev)
    os.makedirs(args.out, exist_ok=True)

    # the expression CSV first (cheap): the GTEx layout the RNA data layer reads
    csv_path = os.path.join(args.out, "expression.csv")
    if not os.path.exists(csv_path):
        expr = corpus.expression.cpu().numpy()
        write_expression_csv(csv_path, expr)
        print(f"[csv] {csv_path} ({expr.shape[0]} x {expr.shape[1]})", flush=True)

    t_start = time.perf_counter()
    written = 0
    for s in range(args.slides):
        name = slide_name(s)
        slide_dir = os.path.join(args.out, name)
        db_path = os.path.join(slide_dir, f"{name}.db")
        if os.path.exists(db_path):
            if store_is_complete(db_path, args.tiles_per_slide):
                continue
            shutil.rmtree(slide_dir, ignore_errors=True)
        os.makedirs(slide_dir, exist_ok=True)
        writer = LMDBTileWriter(db_path)
        for t0 in range(0, args.tiles_per_slide, args.batch):
            n = min(args.batch, args.tiles_per_slide - t0)
            tiles = render_uint8_bgr(corpus, s, np.arange(t0, t0 + n, dtype=np.int64)).cpu().numpy()
            for j in range(n):
                writer.put_tile(f"{name}_patch_{t0 + j}", tiles[j])
        writer.close()
        written += 1
        if written % 5 == 0 or s == args.slides - 1:
            rate = written * args.tiles_per_slide / max(time.perf_counter() - t_start, 1e-9)
            eta = (args.slides - s - 1) * args.tiles_per_slide / max(rate, 1e-9)
            print(f"[tile] slide {s + 1}/{args.slides} ({rate:.0f} tiles/s, eta {eta / 60:.0f} min)", flush=True)
    seconds = time.perf_counter() - t_start
    print(f"[done] {args.out}: {args.slides} slides x {args.tiles_per_slide} tiles in {seconds / 60:.1f} min",
          flush=True)
    tiles = written * args.tiles_per_slide
    return {"slides_written": written, "tiles_written": tiles, "seconds": seconds,
            "tiles_per_s": tiles / max(seconds, 1e-9)}


if __name__ == "__main__":
    main()
