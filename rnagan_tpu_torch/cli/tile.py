"""WSI preprocessing CLI (copy of ``rnagan_tpu/cli/tile.py``, the reference
``src/preprocess/patch_gen_grid.py:155-168`` flag surface): tile slides into
reference-format LMDB databases on the host (``data/tiler.py``); it takes no
``--device``.

Usage:
    python -m rnagan_tpu_torch.cli.tile --wsi_path slides/ --patch_path tiles/ \
        --mask_path masks/ --patch_size 256 --max_patches_per_slide 2000 \
        --dezoom_factor 1.0
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Extract tissue tiles from whole-slide images")
    p.add_argument("--wsi_path", type=str, required=True, help="directory of slides")
    p.add_argument("--patch_path", type=str, required=True, help="output tile databases")
    p.add_argument("--mask_path", type=str, default=None, help="tissue-mask cache dir")
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--max_patches_per_slide", type=int, default=2000)
    p.add_argument("--dezoom_factor", type=float, default=1.0)
    p.add_argument("--num_process", type=int, default=1,
                   help="accepted for reference-CLI parity (the reference's Pool is "
                        "commented out, patch_gen_grid.py:188-193); slides are tiled in turn")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from rnagan_tpu_torch.data.tiler import tile_slides

    done = tile_slides(
        args.wsi_path,
        args.patch_path,
        args.mask_path,
        patch_size=args.patch_size,
        max_patches_per_slide=args.max_patches_per_slide,
        dezoom_factor=args.dezoom_factor,
    )
    print(f"processed {done} slides")
    return done


if __name__ == "__main__":
    main()
