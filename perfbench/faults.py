"""Faults planted in the program's timed path, for the tests and the readings.

Each is a way a later change could break a cell while it still runs: a step
that leaves the state unchanged, half of each batch left out, an input
converted wrongly, an answer altered where it is made. A driver declares them,
found by its name as its mix names it: ``drivers/<driver>.py`` holds

- ``FAULTS``: the names of the faults its cells can have;
- ``CONTROL``: the key of its ``Runner.controls()`` whose numbers must fail the
  cell's limits (the reference a step below the stated precision).

Any file under ``drivers/`` may define faults in ``PATCHES``: a fault's name
to a function of no arguments that imports the port and returns the
``(owner, attribute, broken)`` triples that break it, so loading a driver
imports nothing of the port. ``plant(name)`` finds the name among those files
and patches the port until the context ends. No list here names a driver.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Tuple

from perfbench.core import spec


def kept(tensors, step, *args):
    """``step(*args)`` with ``tensors`` written back as they were before it."""
    import torch

    saved = [t.detach().clone() for t in tensors]
    out = step(*args)
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)
    return out


def unchanged_optimizer(self, *args, **kwargs):
    """An optimizer step that counts the step and moves nothing."""
    self.count += 1


def driver(name: str, base: Path = spec.HERE) -> ModuleType:
    return spec.load_module(base / "drivers" / f"{name}.py")


def declared(name: str, base: Path = spec.HERE) -> Tuple[str, ...]:
    """The faults the cells of the driver ``name`` can have."""
    return tuple(driver(name, base).FAULTS)


def control(name: str, base: Path = spec.HERE) -> str:
    """The key of the driver's ``Runner.controls()`` whose numbers must fail its cells' limits."""
    return driver(name, base).CONTROL


def defined(base: Path = spec.HERE) -> Dict[str, Callable[[], List[tuple]]]:
    """Every fault that a file under ``drivers/`` defines, by name. A name that
    two files define with different code is an error."""
    found: Dict[str, Callable[[], List[tuple]]] = {}
    where: Dict[str, Tuple[str, int]] = {}
    for path in sorted((base / "drivers").glob("*.py")):
        for name, patches in getattr(spec.load_module(path), "PATCHES", {}).items():
            at = (patches.__code__.co_filename, patches.__code__.co_firstlineno)
            if where.setdefault(name, at) != at:
                raise ValueError(f"the fault {name!r} is defined twice: {where[name][0]} and {path}")
            found[name] = patches
    return found


@contextlib.contextmanager
def plant(name: str, base: Path = spec.HERE):
    found = defined(base)
    if name not in found:
        raise KeyError(f"no file under {base / 'drivers'} defines the fault {name!r}; there are {sorted(found)}")
    patches = found[name]()
    originals = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in patches]
    for owner, attr, broken in patches:
        setattr(owner, attr, broken)
    try:
        yield
    finally:
        for owner, attr, original in originals:
            setattr(owner, attr, original)
