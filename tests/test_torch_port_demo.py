"""The end-to-end demo on the port (``tools/demo_e2e_torch.py``), on the CPU:
all 8 steps of ``docs/WORKFLOWS.md`` in miniature through the port's CLIs,
each output present, and the stop at step 1 that names PIL where it is missing."""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import demo_e2e_torch as demo  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_demo_runs_every_step(tmp_path):
    wd = tmp_path / "demo"
    cwd = os.getcwd()
    out = demo.main([str(wd), "--device", "cpu"])
    assert os.getcwd() == cwd
    slides = [f"GTEX-T{t}-{i:04d}" for t in range(2) for i in range(4)]
    # 1. slides and CSVs; 2. one tile store a slide
    for name in slides:
        assert (wd / "wsi" / f"{name}.png").exists()
        assert (wd / "tiles" / name / f"{name}.db").exists()
    assert (wd / "tissue0.csv").exists() and (wd / "tissue1.csv").exists()
    # 3. the VAE; 4. the RNA-GAN
    assert (wd / "vae_ckpt" / "model_dict_best.pt").exists() and out["vae"]["best_epoch"] >= 0
    assert (wd / "gan_ckpt" / "gan_last.model").exists() and len(out["gan"]["history"]) == 2
    assert all(np.isfinite(out["gan"]["history"][-1][k]) for k in ("d_loss", "g_loss", "gp"))
    # 5. both condition modes; 6. FID
    for mode in ("reference", "population"):
        assert (wd / f"generated_{mode}.png").stat().st_size > 0
    assert np.isfinite(out["fid"]).all()
    # 7. interpolation and sampling
    with open(wd / "expr.pkl", "rb") as f:
        assert np.asarray(pickle.load(f)["expression"]).shape == (5, demo.GENES)
    assert (wd / "interp.pkl").exists()
    # 8. the CV
    assert len(out["cv"]["folds"]) == 2 and 0.0 <= out["cv"]["mean_accuracy"] <= 1.0


def test_demo_without_pil_stops_at_step_one(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        demo.main([str(tmp_path / "demo"), "--device", "cpu"])
    assert not (tmp_path / "demo" / "tiles").exists()
