"""Shared CLI plumbing (port of ``rnagan_tpu/cli/common.py``)."""

from __future__ import annotations

import os
import pickle
from typing import Any


def dump_pickle(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)
