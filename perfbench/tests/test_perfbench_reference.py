"""The references' frozen copies of the port's inputs agree with the port today:
the data plane's batches (epoch order, uint8 conversion) and the procedural
corpus's slide latents, batch ids and render. A later change to the port's
arithmetic shows here and in the cells' comparisons."""

import numpy as np
import torch

from perfbench.reference import data, render


def test_the_data_plane_copy_builds_patch_batches_batches():
    from rnagan_tpu_torch.data.patches import PatchBatches, PatchData

    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (24, 8, 8, 3)).astype(np.uint8)
    rna = rng.randn(4, 5).astype(np.float32)
    slide_idx = np.repeat(np.arange(4, dtype=np.int32), 6)
    pd = PatchData(images=images, labels=np.zeros(24, np.int32), slide_idx=slide_idx,
                   slides=[str(i) for i in range(4)], rna=rna)
    port = list(PatchBatches(pd, batch_size=5, with_rna=True, seed=1234).epoch(0))[:3]
    ref = data.first_batches(images, rna, slide_idx, 5, 3, 1234, "cpu")
    for p, r in zip(port, ref, strict=True):
        assert torch.equal(torch.as_tensor(p["image"]), r["image"])
        assert torch.equal(torch.as_tensor(p["rna_data"]), r["rna_data"])


def test_the_render_copy_draws_and_renders_as_the_corpus():
    from rnagan_tpu_torch.data.synthetic import SyntheticCorpus

    corpus = SyntheticCorpus(n_slides=5, tiles_per_slide=7, n_genes=30, size=32, seed=123456789, device="cpu")
    latents = render.slide_latents(123456789, 5, render.TISSUES, "cpu")
    assert torch.equal(latents, corpus.slides.s)
    sl, ti = corpus.batch_ids(987654321, 4, 3, start=0)
    rsl, rti = render.batch_ids(987654321, 4, 3, 5, 7, "cpu")
    assert torch.equal(sl, rsl) and torch.equal(ti, rti)
    for i in range(3):
        ids = rti[i] + rsl[i] * (7 + render.HELDOUT_SPAN)
        assert torch.equal(corpus.render(sl[i], ti[i]), render.render(123456789, latents[rsl[i]], ids, 32))
