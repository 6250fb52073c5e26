"""A run whose timed path is broken underneath comes out not correct: for each
fault a cell's driver declares (``perfbench/faults.py``), planted in the
program and driven through the rest of a run on the CPU at tiny widths (the
look for a card skipped)."""

import pytest

from perfbench import faults
from perfbench.core import spec
from perfbench.tests import tiny

CASES = [(cell, fault) for cell in tiny.CELLS
         for fault in faults.declared(spec.Cell(spec.load_benchmark(), cell).traffic["driver"])]
#: the cases of the tables that drivers' declarations replaced; a later cell adds to them
HELD = {("rnagan-dcgan256.cli-train-b8", f) for f in ("gan_state_unchanged", "gan_half_batch", "gan_half_real",
                                                       "gan_tiles_01")} \
    | {("rnagan-biggan256.cond-cli-train-b8", f) for f in ("gan_state_unchanged", "gan_half_batch", "gan_half_real",
                                                             "gan_tiles_01")} \
    | {("rnagan-dcgan256.quality-train-b32", f) for f in ("gan_state_unchanged", "gan_half_batch", "gan_half_real")} \
    | {("betavae-gtex.resident-train-b128", f) for f in ("vae_state_unchanged", "vae_half_batch")} \
    | {("rnagan-dcgan256.synth-b128", "synth_altered_tile")}


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.plant(fault):
        result = tiny.run(cell)
    assert result["correct"] is False, result["checks"]


def test_the_declared_cases_hold_every_earlier_case():
    assert len(HELD) == 14
    assert HELD <= set(CASES), sorted(HELD - set(CASES))


def test_every_declared_fault_is_defined_once_and_its_patches_restored():
    defined = faults.defined()
    for cell, fault in CASES:
        assert fault in defined, (cell, fault)
    for fault in defined:
        patches = defined[fault]()
        before = [owner.__dict__[attr] for owner, attr, _ in patches]
        with faults.plant(fault):
            assert all(owner.__dict__[attr] is not b for (owner, attr, _), b in zip(patches, before)), fault
        assert [owner.__dict__[attr] for owner, attr, _ in patches] == before, fault


def test_an_unknown_fault_or_one_defined_twice_is_refused(tmp_path):
    with pytest.raises(KeyError, match="no_such_fault"):
        with faults.plant("no_such_fault"):
            pass
    (tmp_path / "drivers").mkdir()
    for name in ("one", "two"):
        (tmp_path / "drivers" / f"{name}.py").write_text(
            f"def _{name}():\n    return []\n\n\nPATCHES = {{'same_name': _{name}}}\n")
    with pytest.raises(ValueError, match="same_name"):
        faults.defined(tmp_path)
    # the same code found through a second file is one definition
    (tmp_path / "drivers" / "two.py").write_text(
        "from pathlib import Path\n\nfrom perfbench.core import spec\n\n"
        "PATCHES = spec.load_module(Path(__file__).with_name('one.py')).PATCHES\n")
    assert list(faults.defined(tmp_path)) == ["same_name"]
