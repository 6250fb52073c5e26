"""WSI -> tile-database preprocessing (copy of ``rnagan_tpu/data/tiler.py``).

The JAX package's numpy/scipy tiler, which re-implements the reference
(``src/preprocess/patch_gen_grid.py``) without skimage; the port writes the
tiles through its own ``data/store.py::LMDBTileWriter``, so the databases
are the JAX tiler's key for key and byte for byte:

* Otsu thresholds, RGB->HSV saturation, and the low-contrast test are
  vectorized numpy implementations matching skimage semantics;
* tissue mask = not(R&G&B above their Otsu) AND saturation above Otsu AND all
  channels > RGB_min (``patch_gen_grid.py:21-34``), then dilation x3 /
  erosion x3 (``:60-61``), cached as ``mask.npy`` (``:62``);
* grid coordinates at level 0 with magnification-normalized patch size
  (``aperio.AppMag``/20 x dezoom, ``:83-85``), shuffled with seed 5 (``:88-91``);
* acceptance: mask coverage > 20% (after per-patch mask dilation) and not
  low-contrast (``:109``);
* output: the reference's LMDB format via the port's writer (ascii-int keys,
  lz4(pickled (name, bytes, shape)) values, ``__keys__`` index,
  ``{out}/{slide_id}/{slide_id}.db``).

Color-channel note (discovered reference quirk): the tiler stores RGB bytes
(``np.array(PIL)``, ``patch_gen_grid.py:117``) but the reader converts
BGR->RGB (``read_data.py:241``), so the reference trains on channel-swapped
tiles. We reproduce the pipeline exactly (store as-produced, swap at read) so
end-to-end behavior matches.

Slide input: OpenSlide when importable (real .svs); otherwise any
PIL-readable image is treated as a single-level slide, enough for tests and
pre-tiled datasets. Both are imported when a slide is opened, never with
this module.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

try:
    from scipy import ndimage as _ndimage
except Exception:  # pragma: no cover
    _ndimage = None


# ----------------------------------------------------------------- imaging


def otsu_threshold(values: np.ndarray, nbins: int = 256) -> float:
    """Otsu's threshold (skimage ``threshold_otsu`` semantics: histogram over
    the data range, maximize inter-class variance, return bin center)."""
    values = np.asarray(values).ravel()
    lo, hi = float(values.min()), float(values.max())
    if lo == hi:
        return lo
    hist, edges = np.histogram(values, bins=nbins, range=(lo, hi))
    centers = (edges[:-1] + edges[1:]) / 2.0
    hist = hist.astype(np.float64)
    w1 = np.cumsum(hist)
    w2 = np.cumsum(hist[::-1])[::-1]
    m1 = np.cumsum(hist * centers) / np.maximum(w1, 1e-12)
    m2 = (np.cumsum((hist * centers)[::-1]) / np.maximum(w2[::-1], 1e-12))[::-1]
    var_between = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[:-1][np.argmax(var_between)])


def rgb_saturation(img_rgb: np.ndarray) -> np.ndarray:
    """HSV saturation channel in [0,1] (skimage ``rgb2hsv`` semantics)."""
    x = np.asarray(img_rgb, np.float64)
    if x.max() > 1.0:
        x = x / 255.0
    mx = x.max(axis=-1)
    mn = x.min(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(mx > 0, (mx - mn) / np.where(mx > 0, mx, 1.0), 0.0)
    return s


def is_low_contrast(img_rgb: np.ndarray, fraction_threshold: float = 0.05) -> bool:
    """skimage ``is_low_contrast``: intensity percentile (1, 99) spread over
    the dtype range below the threshold."""
    x = np.asarray(img_rgb)
    if x.ndim == 3:
        x = (x @ np.array([0.2125, 0.7154, 0.0721]))  # skimage rgb2gray weights
    lo, hi = np.percentile(x, [1, 99])
    dmax = 255.0 if np.asarray(img_rgb).dtype == np.uint8 else 1.0
    return (hi - lo) / dmax < fraction_threshold


def _binary_morph(mask: np.ndarray, op: str, iterations: int) -> np.ndarray:
    if _ndimage is not None:
        fn = _ndimage.binary_dilation if op == "dilate" else _ndimage.binary_erosion
        return fn(mask, iterations=iterations)
    # numpy fallback: 4-connected structuring element
    m = mask.copy()
    for _ in range(iterations):
        shifted = [m]
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            shifted.append(np.roll(np.roll(m, dx, 0), dy, 1))
        m = np.any(shifted, axis=0) if op == "dilate" else np.all(shifted, axis=0)
    return m


def get_mask_image(img_rgb: np.ndarray, rgb_min: int = 50) -> np.ndarray:
    """Tissue mask (reference ``patch_gen_grid.py:21-34``)."""
    r, g, b = img_rgb[..., 0], img_rgb[..., 1], img_rgb[..., 2]
    background = (
        (r > otsu_threshold(r)) & (g > otsu_threshold(g)) & (b > otsu_threshold(b))
    )
    tissue_rgb = ~background
    s = rgb_saturation(img_rgb)
    tissue_s = s > otsu_threshold(s)
    min_rgb = (r > rgb_min) & (g > rgb_min) & (b > rgb_min)
    return tissue_s & tissue_rgb & min_rgb


# ----------------------------------------------------------------- slides


class SlideReader:
    """Uniform interface over OpenSlide (.svs) or a plain image file."""

    def __init__(self, path: str):
        self.path = path
        self._slide = None
        self._img = None
        if path.endswith((".svs", ".tiff", ".tif")):
            try:
                from openslide import OpenSlide  # optional native dep

                self._slide = OpenSlide(path)
            except ImportError:
                pass
        if self._slide is None:
            from PIL import Image

            self._img = np.asarray(Image.open(path).convert("RGB"))

    @property
    def level_dimensions(self) -> Sequence[Tuple[int, int]]:
        if self._slide is not None:
            return self._slide.level_dimensions
        h, w = self._img.shape[:2]
        return [(w, h)]  # openslide convention: (width, height)

    @property
    def properties(self):
        return self._slide.properties if self._slide is not None else {}

    def read_region(self, xy: Tuple[int, int], level: int, size: Tuple[int, int]) -> np.ndarray:
        """RGB array of the requested region (zero-padded at borders)."""
        x, y = xy
        w, h = size
        if self._slide is not None:
            return np.asarray(self._slide.read_region((x, y), level, (w, h)).convert("RGB"))
        out = np.zeros((h, w, 3), np.uint8)
        src = self._img[y : y + h, x : x + w]
        out[: src.shape[0], : src.shape[1]] = src
        return out


def slide_mask(reader: SlideReader, rgb_min: int = 50) -> Tuple[np.ndarray, int]:
    """Tissue mask at the lowest-resolution level, x-major like the reference
    (it transposes to (width, height), ``patch_gen_grid.py:41-42``)."""
    level = len(reader.level_dimensions) - 1
    w, h = reader.level_dimensions[level]
    img = reader.read_region((0, 0), level, (w, h))
    img_xmajor = np.transpose(img, (1, 0, 2))
    return get_mask_image(img_xmajor, rgb_min), level


# ----------------------------------------------------------------- extraction


def extract_patches(
    slide_path: str,
    patches_output_dir: str,
    slide_id: str,
    *,
    mask_path: Optional[str] = None,
    patch_size: Tuple[int, int] = (256, 256),
    max_patches_per_slide: int = 2000,
    dezoom_factor: float = 1.0,
    background_threshold: float = 0.2,
    seed: int = 5,
    resize_to_patch_size: bool = True,
) -> int:
    """Tile one slide into a reference-format database. Returns number of
    tiles written (reference ``extract_patches``, ``patch_gen_grid.py:48-138``)."""
    from PIL import Image

    from rnagan_tpu_torch.data.store import LMDBTileWriter

    reader = SlideReader(slide_path)
    patch_folder = os.path.join(patches_output_dir, slide_id)
    os.makedirs(patch_folder, exist_ok=True)

    # cached low-res tissue mask (reference :56-65)
    mask = None
    if mask_path:
        mask_folder = os.path.join(mask_path, slide_id)
        mask_file = os.path.join(mask_folder, "mask.npy")
        if os.path.exists(mask_file):
            mask = np.load(mask_file)
    if mask is None:
        mask, _ = slide_mask(reader)
        mask = _binary_morph(mask, "dilate", 3)
        mask = _binary_morph(mask, "erode", 3)
        if mask_path:
            os.makedirs(os.path.join(mask_path, slide_id), exist_ok=True)
            np.save(os.path.join(mask_path, slide_id, "mask.npy"), mask)

    mask_level = len(reader.level_dimensions) - 1
    xmax, ymax = reader.level_dimensions[0]
    ratio_x = reader.level_dimensions[0][0] / reader.level_dimensions[mask_level][0]
    ratio_y = reader.level_dimensions[0][1] / reader.level_dimensions[mask_level][1]

    # magnification normalization (reference :83-85)
    resize_factor = float(reader.properties.get("aperio.AppMag", 20)) / 20.0 * dezoom_factor
    psr = (int(resize_factor * patch_size[0]), int(resize_factor * patch_size[1]))

    indices = [(x, y) for x in range(0, xmax, psr[0]) for y in range(0, ymax, psr[1])]
    np.random.seed(seed)  # reference seeds the grid shuffle with 5 (:88)
    np.random.shuffle(indices)

    db_path = os.path.join(patch_folder, slide_id + ".db")
    writer = LMDBTileWriter(db_path)
    count = 0
    for x, y in indices:
        if count >= max_patches_per_slide:
            break
        x_mask = int(x / ratio_x)
        y_mask = int(y / ratio_y)
        if x_mask >= mask.shape[0] or y_mask >= mask.shape[1] or not mask[x_mask, y_mask]:
            continue
        patch = reader.read_region((x, y), 0, psr)
        patch_mask = _binary_morph(get_mask_image(patch), "dilate", 3)
        if patch_mask.sum() <= background_threshold * patch_mask.size or is_low_contrast(patch):
            continue
        if resize_to_patch_size and psr != tuple(patch_size):
            patch = np.asarray(Image.fromarray(patch).resize(patch_size))
        writer.put_tile(f"{slide_id}_patch_{count}", patch)
        count += 1
    writer.close()
    return count


def tile_slides(
    wsi_dir: str,
    patch_path: str,
    mask_path: Optional[str] = None,
    *,
    patch_size: int = 256,
    max_patches_per_slide: int = 2000,
    dezoom_factor: float = 1.0,
    extensions: Tuple[str, ...] = (".svs", ".tif", ".tiff", ".png", ".jpg", ".jpeg"),
    verbose: bool = True,
) -> int:
    """Sequential loop over a slide directory (reference ``__main__``,
    ``patch_gen_grid.py:171-193``). Returns slides processed."""
    done = 0
    for name in sorted(os.listdir(wsi_dir)):
        if not name.lower().endswith(extensions):
            continue
        slide_id = ".".join(name.split(".")[:2]) if name.count(".") >= 2 else os.path.splitext(name)[0]
        try:
            n = extract_patches(
                os.path.join(wsi_dir, name),
                patch_path,
                slide_id,
                mask_path=mask_path,
                patch_size=(patch_size, patch_size),
                max_patches_per_slide=max_patches_per_slide,
                dezoom_factor=dezoom_factor,
            )
            if verbose:
                print(f"{slide_id}: {n} tiles")
            done += 1
        except Exception as e:
            if verbose:
                print(f"error with slide {slide_id}: {e}")
    return done
