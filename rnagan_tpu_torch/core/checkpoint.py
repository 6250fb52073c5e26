"""Best-on-validation checkpoints of the β-VAE (the port's counterpart of
``rnagan_tpu/core/checkpoint.py::BestKeeper``).

The reference writes ``torch.save(state_dict)`` files, ``model_dict_best.pt``
and ``model_last.pt`` (``betaVAE.py:270-275``). :class:`BestKeeper` writes the
same: plain reference-layout state_dicts, which
``convert.load_betavae_state_dict`` and ``GANConfig(vae_checkpoint=...)`` read
unchanged. What a state_dict cannot hold goes beside it:

* ``scaler.npz``, the fitted normalization :class:`~rnagan_tpu_torch.data.rna.Scaler`
  (the JAX package bundles it into each checkpoint; the reference re-fits it
  in every script);
* ``model_dict_best.json``, the best epoch, its validation loss and the
  caller's metadata.

Every file is written to a temporary name and renamed, so a crash never
leaves a torn checkpoint. Under a mesh only rank 0 writes (:func:`on_writer`,
then a barrier); every rank reads.

The JAX package's own format is here too: :func:`save_pytree` /
:func:`load_pytree` and :func:`save_bundle` / :func:`load_bundle` are the
counterparts of ``rnagan_tpu/core/checkpoint.py``'s, over the
standard-library msgpack codec (``core/msgpack.py``). A tree is written in
flax's state-dict form (a list or tuple becomes ``{"0": ..., "1": ...}``,
every leaf an array); a string leaf is the uint8 array ``b"\xffSTR" +
utf-8`` (``checkpoint.py:28-46``) and a bundle's ``__meta__`` is JSON. So
the JAX ``load_bundle`` reads what :func:`save_bundle` writes, and
:func:`load_bundle` reads the JAX ``model_best.ckpt`` and ``gan_last.model``.

:class:`AsyncSaver` (``rnagan_tpu/core/checkpoint.py:89-130``) writes a
bundle on a worker thread while training goes on: the caller's stream copies
the state's tensors on the device first, so a later step that updates them
in place cannot change what is written.
"""

from __future__ import annotations

import json
import os
import threading
import weakref
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from rnagan_tpu_torch.core import msgpack
from rnagan_tpu_torch.parallel.collectives import barrier

SCALER_NAME = "scaler.npz"


def _atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def on_writer(mesh, write) -> None:
    """``write()`` on the mesh's writer (rank 0), then a barrier, so no rank
    reads a file before it is whole; ``write()`` alone without a mesh."""
    if mesh is None or mesh.writer:
        write()
    barrier(mesh)


def save_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """``torch.save`` of CPU copies, atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    _atomic(path, lambda tmp: torch.save(cpu, tmp))


class BestKeeper:
    """Best and last checkpoints in ``save_dir``."""

    def __init__(self, save_dir: str, best_name: str = "model_dict_best.pt",
                 last_name: str = "model_last.pt"):
        self.save_dir = save_dir
        self.best_path = os.path.join(save_dir, best_name)
        self.last_path = os.path.join(save_dir, last_name)
        self.scaler_path = os.path.join(save_dir, SCALER_NAME)
        self.best_loss = float("inf")
        self.best_epoch = -1
        os.makedirs(save_dir, exist_ok=True)

    def _save_scaler(self, scaler) -> None:
        if scaler is not None:
            _atomic(self.scaler_path, scaler.save)

    def update(self, epoch: int, val_loss: float, state_dict: Dict[str, torch.Tensor], scaler=None,
               metadata: Optional[Dict[str, Any]] = None) -> bool:
        """Write the best files when ``val_loss`` improves on the best so far."""
        improved = val_loss < self.best_loss
        if improved:
            self.best_loss, self.best_epoch = val_loss, epoch
            save_state_dict(self.best_path, state_dict)
            meta = {**(metadata or {}), "epoch": epoch, "val_loss": val_loss}
            meta_path = os.path.splitext(self.best_path)[0] + ".json"

            def write(tmp):
                with open(tmp, "w") as f:
                    json.dump(meta, f)

            _atomic(meta_path, write)
            self._save_scaler(scaler)
        return improved

    def save_last(self, state_dict: Dict[str, torch.Tensor], scaler=None) -> None:
        save_state_dict(self.last_path, state_dict)
        self._save_scaler(scaler)


# ------------------------------------------- the JAX package's msgpack format

_STR_TAG = b"\xffSTR"


def _to_state_dict(tree):
    """flax ``to_state_dict`` + the JAX package's ``_to_numpy``: dicts keep
    their (str) keys, lists and tuples become ``{"0": ...}``, strings become
    tagged uint8 arrays and every other leaf an array (None stays None)."""
    if isinstance(tree, dict):
        return {str(k): _to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (str, bytes)):
        raw = tree.encode("utf-8") if isinstance(tree, str) else tree
        return np.frombuffer(_STR_TAG + raw, np.uint8).copy()
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    return np.asarray(tree)


def _from_state_dict(tree):
    if isinstance(tree, dict):
        return {k: _from_state_dict(v) for k, v in tree.items()}
    if (isinstance(tree, np.ndarray) and tree.dtype == np.uint8 and tree.ndim == 1
            and tree.size >= 4 and bytes(tree[:4]) == _STR_TAG):
        return bytes(tree[4:]).decode("utf-8")
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """``tree`` as flax msgpack at ``path``, atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = _to_state_dict(tree)

    def write(tmp):
        with open(tmp, "wb") as f:
            msgpack.pack(payload, f.write)

    _atomic(path, write)


def load_pytree(path: str) -> Any:
    """The tree of a flax msgpack file: numpy leaves (``torch.bfloat16``
    tensors for bfloat16 arrays), tagged strings decoded."""
    with open(path, "rb") as f:
        return _from_state_dict(msgpack.unpackb(f.read()))


def save_bundle(path: str, trees: Dict[str, Any], metadata: Optional[Dict[str, Any]] = None) -> None:
    """A named bundle with its JSON ``__meta__``, as the JAX package writes one."""
    save_pytree(path, {"__meta__": json.dumps(metadata or {}), **trees})


def load_bundle(path: str):
    """``(trees, metadata)`` of a bundle written by :func:`save_bundle` or by
    the JAX package's ``save_bundle`` (``BestKeeper``, ``GANTrainer.save_model``)."""
    raw = load_pytree(path)
    meta = json.loads(raw.pop("__meta__", "{}"))
    return raw, meta


# ------------------------------------------------------------ async saving


def map_tensors(fn, tree):
    """``fn`` over the tensors of a tree of dicts, lists and tuples; other
    leaves kept."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def to_host(tree):
    """The tree with every tensor copied to the CPU (detached)."""
    return map_tensors(lambda t: t.detach().cpu(), tree)


class AsyncSaver:
    """Background-thread checkpoint writer (``rnagan_tpu/core/checkpoint.py:89-130``).

    :meth:`save` snapshots every tensor of the tree by a device copy on the
    caller's stream, before a later step can update the state in place (the
    JAX saver's ``jnp.copy`` against donation); a worker thread waits for
    the copies, moves them to the host on a stream of its own and calls
    ``write(path, host_tree)``, while the caller goes on enqueuing steps. One
    save in flight at a time: a newer request waits for the previous write,
    so disk writes never interleave. A worker's error is raised by the next
    :meth:`wait` (or save)."""

    _live: "weakref.WeakSet[AsyncSaver]" = weakref.WeakSet()

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        AsyncSaver._live.add(self)

    def save(self, path: str, tree: Any, write: Callable[[str, Any], None]) -> None:
        self.wait()
        with torch.no_grad():
            snapshot = map_tensors(lambda t: t.detach().clone(), tree)
        devices = set()
        map_tensors(lambda t: devices.add(t.device) if t.is_cuda else None, snapshot)
        events = []
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append((dev, ev))

        def work():
            try:
                for dev, ev in events:
                    ev.synchronize()
                if devices:
                    dev = next(iter(devices))
                    with torch.cuda.stream(torch.cuda.Stream(dev)):
                        host = to_host(snapshot)
                else:
                    host = to_host(snapshot)
                write(path, host)
            except BaseException as e:  # re-raised on the caller's side
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_bundle(self, path: str, trees: Dict[str, Any], metadata: Optional[Dict[str, Any]] = None) -> None:
        """:func:`save_bundle` of ``trees`` on the worker."""
        self.save(path, trees, lambda p, host: save_bundle(p, host, metadata))

    def wait(self) -> None:
        """Block until the save in flight is written; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @classmethod
    def wait_all(cls) -> None:
        """:meth:`wait` on every live saver (before a CUDA graph capture: a
        worker's device copy during one would invalidate it)."""
        for saver in list(cls._live):
            saver.wait()
