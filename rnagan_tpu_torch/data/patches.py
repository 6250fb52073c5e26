"""Patch datasets: slide databases -> training batches, and bags of tiles per
slide (port of ``rnagan_tpu/data/patches.py``, without pandas).

The JAX package walks a pandas frame of slides. The port walks a
:class:`SlideTable`: the rows of an :class:`~rnagan_tpu_torch.data.rna.RNATable`
(``wsi_file_name`` and the ``rna_*`` expression columns) with each row's
``patch_data_path`` and integer ``labels`` beside them
(``cli/common.py::load_gan_dataframe`` builds one from a config's CSVs).

Slides are opened once (mmap through ``data/store.py``), the sampled tiles
decoded in bulk into contiguous uint8 arrays, and per-tile RNA rows are an
index into a per-slide matrix. A slide that cannot be read is skipped, and
entries that do not decode are dropped (the reference's collate filter,
``histopathology_gan.py:26-48``). The database of a slide is
``{patch_data_path}/{wsi}/{wsi -.svs +.db}`` (``read_data.py:197``).

The random draws are the JAX package's, draw for draw: one
``RandomState(seed)`` across slides, no draw for a slide that fails to open,
and ``quick`` keeping ``min(n, 150 if with_rna else 10)`` slides as pandas'
``df.sample(k, random_state=seed)`` picks them (``data/rna.py::sample_rows``).
So the same CSVs and seed give the same tiles, labels and RNA rows.

The bag half (:class:`BagData`, :func:`make_bags`, the JPEG and HDF5 bag
readers, :func:`convert_slide_to_hdf5`) walks a :class:`SlideTable` where
the JAX functions walk a frame: the same row order, ``quick`` keeping the
listed slides in table order, a slide's ``labels`` entry as its label and
its expression row as its RNA when the table has ``rna_*`` columns. PIL and
h5py are imported inside the functions that use them.
"""

from __future__ import annotations

import os
import threading
import weakref
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rnagan_tpu_torch.data.batching import batch_indices
from rnagan_tpu_torch.data.rna import RNATable
from rnagan_tpu_torch.data.store import LMDBTileStore
from rnagan_tpu_torch.data.tiles import Prefetcher, tiles_to_float

#: what a slide that cannot be read raises: a missing or malformed database
#: (``LMDBTileStore``'s IOError) or a failed native decode
_SLIDE_ERRORS = (OSError, RuntimeError, ValueError)


def slide_db_path(patch_data_path: str, wsi_file_name: str) -> str:
    """``{path}/{wsi}/{wsi -.svs +.db}`` (reference ``read_data.py:197``);
    a name without ``.svs`` gets ``.db`` appended."""
    db = wsi_file_name.replace(".svs", ".db") if ".svs" in wsi_file_name else wsi_file_name + ".db"
    return os.path.join(patch_data_path, wsi_file_name, db)


@dataclass
class SlideTable:
    """Slides: ``rna`` (its ``wsi_file_name`` names each slide, its values
    the expression), and per row the ``patch_data_path`` and int ``labels``."""

    rna: RNATable
    patch_data_path: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.rna)

    @property
    def wsi_file_name(self) -> np.ndarray:
        return self.rna.wsi_file_name

    def take(self, idx) -> "SlideTable":
        idx = np.asarray(idx, np.intp)
        return SlideTable(self.rna.take(idx), self.patch_data_path[idx], self.labels[idx])

    def with_rna_values(self, values: np.ndarray) -> "SlideTable":
        return SlideTable(self.rna.with_values(values), self.patch_data_path, self.labels)

    def rna_row(self, i: int) -> np.ndarray:
        return np.asarray(self.rna.values[i], np.float32)

    def db_path(self, i: int) -> str:
        return slide_db_path(self.patch_data_path[i], self.wsi_file_name[i])

    @staticmethod
    def concat(tables: Sequence["SlideTable"]) -> "SlideTable":
        return SlideTable(RNATable.concat([t.rna for t in tables]),
                          np.concatenate([t.patch_data_path for t in tables]),
                          np.concatenate([t.labels for t in tables]))


@dataclass
class PatchData:
    """A flat tile dataset with per-slide RNA and labels."""

    images: np.ndarray          # (N, H, W, 3) uint8, RGB
    labels: np.ndarray          # (N,) int32
    slide_idx: np.ndarray       # (N,) int32 -> index into slides / rna
    slides: List[str]
    rna: Optional[np.ndarray] = None  # (num_slides, G) float32

    def __len__(self):
        return len(self.images)

    def rna_for_tiles(self, tile_indices: np.ndarray) -> np.ndarray:
        if self.rna is None:
            raise ValueError("this PatchData was loaded without RNA (with_rna=False)")
        return self.rna[self.slide_idx[tile_indices]]


def _sample_keys(store: LMDBTileStore, rng: np.random.RandomState, n: int) -> List[bytes]:
    keys = store.keys()
    return [keys[i] for i in rng.choice(len(keys), min(len(keys), n), replace=False)]


def load_patch_data(slides: SlideTable, *, max_patches_total: int = 300, seed: int = 99,
                    quick: bool = False, with_rna: bool = False, verbose: bool = True) -> PatchData:
    """A :class:`PatchData` from a slide table, at most ``max_patches_total``
    tiles a slide (reference ``read_data.py:174-231,284-332``)."""
    if quick:
        k = min(len(slides), 150 if with_rna else 10)
        slides = slides.take(np.random.RandomState(seed).choice(len(slides), k, replace=False))
    rng = np.random.RandomState(seed)
    images: List[np.ndarray] = []
    labels: List[int] = []
    slide_idx: List[int] = []
    names: List[str] = []
    rna_rows: List[np.ndarray] = []
    for i in range(len(slides)):
        path = slides.db_path(i)
        try:
            with LMDBTileStore(path) as store:
                tiles, kept = store.load_tiles(_sample_keys(store, rng, max_patches_total))
        except _SLIDE_ERRORS as e:  # skip unreadable slides, as the reference does
            if verbose:
                print(f"Error with db {path}: {e}")
            continue
        if not kept:
            continue
        sid = len(names)
        names.append(slides.wsi_file_name[i])
        if with_rna:
            rna_rows.append(slides.rna_row(i))
        images.append(tiles)
        labels += [int(slides.labels[i])] * len(kept)
        slide_idx += [sid] * len(kept)
    if not images:
        return PatchData(np.zeros((0, 0, 0, 3), np.uint8), np.zeros(0, np.int32), np.zeros(0, np.int32), [])
    return PatchData(images=np.concatenate(images, axis=0), labels=np.asarray(labels, np.int32),
                     slide_idx=np.asarray(slide_idx, np.int32), slides=names,
                     rna=np.stack(rna_rows) if with_rna else None)


def patient_tiles(slides: SlideTable, patient: str, n: int, *,
                  seed: int = 99) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``n`` random tiles and the RNA row (1, G) of one patient's slide (the
    reference's ``load_images_from_patient``, ``gan_utils.py:120-195``);
    the RNA row is None when the table has no expression columns."""
    rows = np.flatnonzero(slides.wsi_file_name == patient)
    if len(rows) == 0:
        raise KeyError(f"patient {patient} not in the slide table")
    i = int(rows[0])
    with LMDBTileStore(slides.db_path(i)) as store:
        tiles, _ = store.load_tiles(_sample_keys(store, np.random.RandomState(seed), n))
    return tiles, (slides.rna_row(i)[None, :] if slides.rna.columns else None)


class PatchBatches:
    """Epoch batches over a :class:`PatchData`: the GAN trainer's batch dicts
    (``image`` float32 in [-1, 1], optionally ``rna_data`` and ``labels``)."""

    def __init__(self, data: PatchData, *, batch_size: int = 8, with_rna: bool = False,
                 with_labels: bool = False, shuffle: bool = True, seed: int = 0, pad_to: int = 1):
        self.data, self.batch_size = data, batch_size
        self.with_rna, self.with_labels = with_rna, with_labels
        self.shuffle, self.seed, self.pad_to = shuffle, seed, pad_to

    def __len__(self):
        return -(-len(self.data) // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        for idx, _ in batch_indices(len(self.data), self.batch_size, shuffle=self.shuffle,
                                    seed=self.seed, epoch=epoch, pad_to=self.pad_to):
            batch = {"image": tiles_to_float(self.data.images[idx])}
            if self.with_rna:
                batch["rna_data"] = self.data.rna_for_tiles(idx)
            if self.with_labels:
                batch["labels"] = self.data.labels[idx]
            yield batch


class StreamingPatchBatches:
    """Batches decoded on demand, for corpora larger than host memory. A scan
    at construction samples ``(db path, key, label, slide)`` per tile; each
    epoch shuffles that index, and a worker thread (``tiles.Prefetcher``)
    decodes the next batches from the open stores while the card trains."""

    #: how far a corrupt entry's replacement is searched for, in entries
    _CORRUPT_SCAN_LIMIT = 1024

    def __init__(self, slides: SlideTable, *, batch_size: int = 8, max_patches_total: int = 300,
                 with_rna: bool = False, with_labels: bool = False, seed: int = 99, pad_to: int = 1,
                 prefetch_depth: int = 2, verbose: bool = False, emit_uint8: bool = False,
                 prewarm: bool = False, transfer=None):
        self.batch_size, self.with_rna, self.with_labels = batch_size, with_rna, with_labels
        self.seed, self.pad_to, self.prefetch_depth = seed, pad_to, prefetch_depth
        #: ship uint8 tiles and let the trainer normalize on the card
        self.emit_uint8 = emit_uint8
        #: a callable run on each batch in the prefetch thread (e.g. a copy to the card)
        self.transfer = transfer
        #: the epochs' workers that may still run (a worker keeps its Prefetcher alive)
        self._prefetchers: "weakref.WeakSet[Prefetcher]" = weakref.WeakSet()
        rng = np.random.RandomState(seed)
        self._entries: List[Tuple[str, bytes, int, int]] = []  # (db, key, label, slide)
        self._rna_rows: List[np.ndarray] = []
        self._stores: Dict[str, LMDBTileStore] = {}
        for i in range(len(slides)):
            path = slides.db_path(i)
            try:
                store = LMDBTileStore(path)
                keys = store.keys()
            except _SLIDE_ERRORS as e:
                if verbose:
                    print(f"Error with db {path}: {e}")
                continue
            self._stores[path] = store
            sid = len(self._rna_rows)
            self._rna_rows.append(slides.rna_row(i) if with_rna else np.zeros(0, np.float32))
            chosen = rng.choice(len(keys), min(len(keys), max_patches_total), replace=False)
            label = int(slides.labels[i])
            self._entries += [(path, keys[k], label, sid) for k in chosen]

        # an optional sequential page-cache prewarm of every store in the
        # background: random reads of a cold corpus are disk-seek-bound
        self._prewarm_thread: Optional[threading.Thread] = None
        if prewarm:
            stores = list(self._stores.values())

            def _warm():
                for st in stores:
                    try:
                        st.prewarm()
                    except OSError:  # a store the loader cannot read fails there, not here
                        pass

            self._prewarm_thread = threading.Thread(target=_warm, name="corpus-prewarm", daemon=True)
            self._prewarm_thread.start()

        # the tile shape, from the first decodable entry of the first 256
        self._tile_hw: Optional[Tuple[int, int]] = None
        for path, key, _, _ in self._entries[:256]:
            img = self._stores[path].get_tile(key)
            if img is not None and img.ndim == 3:
                self._tile_hw = (img.shape[0], img.shape[1])
                break

    def __len__(self):
        return -(-len(self._entries) // self.batch_size)

    def wait_prewarm(self, timeout: Optional[float] = None) -> None:
        if self._prewarm_thread is not None:
            self._prewarm_thread.join(timeout)

    def close(self):
        """Stops every epoch's worker (an epoch left unfinished still decodes
        ahead), then closes the stores."""
        for prefetcher in list(self._prefetchers):
            prefetcher.close()
        for s in self._stores.values():
            s.close()
        self._stores.clear()

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        if self._tile_hw is None:
            raise RuntimeError("no decodable tile found in the streaming index")
        h, w = self._tile_hw
        n = len(idx)
        imgs = np.empty((n, h, w, 3), np.uint8)
        chosen = [self._entries[i] for i in idx]
        by_store: Dict[str, List[int]] = {}
        for pos in range(n):
            by_store.setdefault(chosen[pos][0], []).append(pos)
        failed: List[int] = []
        for path, positions in by_store.items():
            tiles, ok = self._stores[path].load_tiles_fixed([chosen[p][1] for p in positions], h, w)
            for j, pos in enumerate(positions):
                if ok[j]:
                    imgs[pos] = tiles[j]
                else:
                    failed.append(pos)
        # a corrupt entry: the next decodable one within a bounded scan
        for pos in failed:
            for offset in range(1, min(len(self._entries), self._CORRUPT_SCAN_LIMIT) + 1):
                cand = self._entries[(idx[pos] + offset) % len(self._entries)]
                img = self._stores[cand[0]].get_tile(cand[1])
                if img is not None and img.shape == (h, w, 3):
                    imgs[pos], chosen[pos] = img, cand
                    break
            else:
                raise RuntimeError(f"no decodable tile within {self._CORRUPT_SCAN_LIMIT} entries "
                                   f"of index {idx[pos]}")
        batch = {"image": imgs if self.emit_uint8 else tiles_to_float(imgs)}
        if self.with_rna:
            batch["rna_data"] = np.stack([self._rna_rows[c[3]] for c in chosen])
        if self.with_labels:
            batch["labels"] = np.asarray([c[2] for c in chosen], np.int32)
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        def gen():
            for idx, _ in batch_indices(len(self._entries), self.batch_size, shuffle=True,
                                        seed=self.seed, epoch=epoch, pad_to=self.pad_to):
                yield self._make_batch(idx)

        prefetcher = Prefetcher(gen(), depth=self.prefetch_depth, transfer=self.transfer)
        self._prefetchers.add(prefetcher)
        return prefetcher


# -------------------------------------------------------------------- bags


@dataclass
class BagData:
    """Bags of ``bag_size`` tiles per slide + slide-level label/RNA — the
    PatchBagDataset / PatchBagRNADataset shape (reference ``read_data.py:22-155``)."""

    bags: np.ndarray            # (B, bag_size, H, W, 3) uint8
    labels: np.ndarray          # (B,) int32
    slide_idx: np.ndarray       # (B,) int32
    slides: List[str]
    rna: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.bags)


def _bag_data(bags, labels, slide_idx, slides, rna_rows, bag_size) -> BagData:
    rna = np.stack(rna_rows) if rna_rows else None
    if not bags:
        return BagData(np.zeros((0, bag_size, 0, 0, 3), np.uint8), np.zeros(0, np.int32),
                       np.zeros(0, np.int32), slides, rna)
    return BagData(np.stack(bags), np.asarray(labels, np.int32), np.asarray(slide_idx, np.int32), slides, rna)


def _quick(slides: SlideTable, quick: Optional[Sequence[str]]) -> SlideTable:
    if quick is None:
        return slides
    return slides.take(np.flatnonzero(np.isin(slides.wsi_file_name, list(quick))))


def load_bag_folder(slides: SlideTable, patch_path: str, *, bag_size: int = 20,
                    max_patch_per_wsi: Optional[int] = 400, img_size: Optional[int] = None,
                    quick: Optional[Sequence[str]] = None) -> BagData:
    """Bags from the reference's file-per-patch JPEG layout
    (``get_data_rna_bag_wsi``, ``read_data.py:60-98``): ``patch_path/<wsi>/``
    holds ``<wsi>_patch_<i>.jpeg`` and a ``loc.txt`` whose line count minus 2
    is the patch count (``:83-85``). The first ``max_patch_per_wsi`` patches
    in index order, consecutive ``bag_size`` chunks (remainder dropped);
    ``quick`` keeps the listed slides (``:70-71``)."""
    from PIL import Image

    slides = _quick(slides, quick)
    bags, labels, slide_idx, names, rna_rows = [], [], [], [], []
    for i in range(len(slides)):
        wsi = slides.wsi_file_name[i]
        slide_dir = os.path.join(patch_path, wsi)
        loc = os.path.join(slide_dir, "loc.txt")
        if not os.path.isdir(slide_dir) or not os.path.exists(loc):
            continue
        with open(loc) as f:
            n_patches = sum(1 for _ in f) - 2
        paths = [os.path.join(slide_dir, f"{wsi}_patch_{k}.jpeg") for k in range(n_patches)]
        if max_patch_per_wsi is not None:
            paths = paths[:max_patch_per_wsi]
        sid = len(names)
        names.append(wsi)
        if slides.rna.columns:
            rna_rows.append(slides.rna_row(i))
        for k in range(len(paths) // bag_size):
            tiles = []
            for path in paths[bag_size * k : bag_size * (k + 1)]:
                with Image.open(path) as im:
                    im = im.convert("RGB")
                    if img_size is not None and im.size != (img_size, img_size):
                        im = im.resize((img_size, img_size), Image.BILINEAR)
                    tiles.append(np.asarray(im, np.uint8))
            bags.append(np.stack(tiles))
            labels.append(int(slides.labels[i]))
            slide_idx.append(sid)
    return _bag_data(bags, labels, slide_idx, names, rna_rows, bag_size)


def slide_hdf5_path(patch_data_path: str, wsi_file_name: str) -> str:
    """``{path}/{wsi_file_name}.h5``: one HDF5 file per slide (the layout the
    reference's ``_Patches256x256_hdf5`` directory implies, ``ml_experiments.py:265``)."""
    return os.path.join(patch_data_path, wsi_file_name + ".h5")


def write_slide_hdf5(path: str, tiles: np.ndarray, locs: Optional[np.ndarray] = None) -> None:
    """One slide's tiles as an HDF5 store: ``patches`` (N, H, W, 3) uint8,
    chunked a tile (a bag read decodes only its rows), gzip level 1, and an
    optional ``loc`` (N, 2) int32 grid-coordinate table."""
    import h5py

    tiles = np.ascontiguousarray(tiles, np.uint8)
    if tiles.ndim != 4 or tiles.shape[-1] != 3:
        raise ValueError(f"tiles must be (N,H,W,3) uint8, got {tiles.shape}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("patches", data=tiles, chunks=(1,) + tiles.shape[1:],
                         compression="gzip", compression_opts=1)
        if locs is not None:
            f.create_dataset("loc", data=np.asarray(locs, np.int32))


def convert_slide_to_hdf5(patch_data_path: str, wsi_file_name: str, out_dir: str,
                          chunk_tiles: int = 512) -> str:
    """A slide's LMDB tile database (the tiler's output) as the HDF5 store
    :func:`load_bag_hdf5` reads; returns its path. Tiles keep their index
    order: ascii-integer keys are sorted numerically (a tree walk yields
    '10' before '2'), and stream through in ``chunk_tiles`` batches, so peak
    memory stays a chunk's; a tile that does not decode is left out."""
    import h5py

    out = slide_hdf5_path(out_dir, wsi_file_name)
    with LMDBTileStore(slide_db_path(patch_data_path, wsi_file_name)) as store:
        keys = store.keys()
        if not keys:
            raise ValueError(f"empty tile database for {wsi_file_name}")
        if all(k.isdigit() for k in keys):
            keys = sorted(keys, key=int)
        first = store.get_tile(keys[0])
        if first is None:
            raise ValueError(f"corrupt first tile in {wsi_file_name}")
        h, w = first.shape[:2]
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with h5py.File(out, "w") as f:
            ds = f.create_dataset("patches", shape=(0, h, w, 3), maxshape=(None, h, w, 3), dtype=np.uint8,
                                  chunks=(1, h, w, 3), compression="gzip", compression_opts=1)
            written = 0
            for i in range(0, len(keys), chunk_tiles):
                tiles, ok = store.load_tiles_fixed(keys[i : i + chunk_tiles], h, w)
                tiles = tiles[ok]
                if len(tiles):
                    ds.resize(written + len(tiles), axis=0)
                    ds[written:] = tiles
                    written += len(tiles)
    return out


def load_bag_hdf5(slides: SlideTable, patch_path: str, *, bag_size: int = 40,
                  max_patch_per_wsi: Optional[int] = 300, img_size: Optional[int] = None,
                  quick: Optional[Sequence[str]] = None) -> BagData:
    """:func:`load_bag_folder`'s bags over per-slide HDF5 stores (the
    reference's declared ``PatchBagDatasetHDF5``): the patch count is the
    ``patches`` dataset's length; a slide with a store is listed even with
    no full bag, so slide indices and RNA rows align with the folder reader's."""
    import h5py

    slides = _quick(slides, quick)
    bags, labels, slide_idx, names, rna_rows = [], [], [], [], []
    for i in range(len(slides)):
        wsi = slides.wsi_file_name[i]
        h5path = slide_hdf5_path(patch_path, wsi)
        if not os.path.exists(h5path):
            continue
        with h5py.File(h5path, "r") as f:
            if "patches" not in f:
                continue
            ds = f["patches"]
            n_patches = ds.shape[0]
            if max_patch_per_wsi is not None:
                n_patches = min(n_patches, max_patch_per_wsi)
            sid = len(names)
            names.append(wsi)
            if slides.rna.columns:
                rna_rows.append(slides.rna_row(i))
            for k in range(n_patches // bag_size):
                chunk = np.asarray(ds[bag_size * k : bag_size * (k + 1)], np.uint8)
                if img_size is not None and chunk.shape[1:3] != (img_size, img_size):
                    chunk = _resize_bilinear_u8(chunk, img_size)
                bags.append(chunk)
                labels.append(int(slides.labels[i]))
                slide_idx.append(sid)
    return _bag_data(bags, labels, slide_idx, names, rna_rows, bag_size)


def _resize_bilinear_u8(tiles: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of a (N, H, W, 3) uint8 stack with PIL (torchvision
    Resize's default interpolation, as the reference)."""
    from PIL import Image

    out = np.empty((tiles.shape[0], size, size, 3), np.uint8)
    for i, t in enumerate(tiles):
        out[i] = np.asarray(Image.fromarray(t).resize((size, size), Image.BILINEAR))
    return out


def make_bags(data: PatchData, bag_size: int = 40, seed: int = 0, drop_last: bool = True) -> BagData:
    """A :class:`PatchData` grouped into per-slide bags, shuffled within each
    slide (the reference's ``shuffle()``, ``read_data.py:134``), drawing from
    one ``RandomState(seed)`` as the JAX package does; with ``drop_last``
    off, a short last bag is filled with tiles of its slide drawn again."""
    rng = np.random.RandomState(seed)
    bags, labels, slide_idx = [], [], []
    for sid in range(len(data.slides)):
        tiles = np.flatnonzero(data.slide_idx == sid)
        rng.shuffle(tiles)
        n_full = len(tiles) // bag_size
        for b in range(n_full):
            chunk = tiles[b * bag_size : (b + 1) * bag_size]
            bags.append(data.images[chunk])
            labels.append(int(data.labels[chunk[0]]))
            slide_idx.append(sid)
        if not drop_last and len(tiles) % bag_size:
            chunk = tiles[n_full * bag_size :]
            fill = tiles[rng.choice(len(tiles), bag_size - len(chunk))]
            bags.append(data.images[np.concatenate([chunk, fill])])
            labels.append(int(data.labels[chunk[0]]))
            slide_idx.append(sid)
    if not bags:
        return BagData(np.zeros((0, bag_size, 0, 0, 3), np.uint8), np.zeros(0, np.int32),
                       np.zeros(0, np.int32), data.slides, data.rna)
    return BagData(np.stack(bags), np.asarray(labels, np.int32), np.asarray(slide_idx, np.int32),
                   data.slides, data.rna)
