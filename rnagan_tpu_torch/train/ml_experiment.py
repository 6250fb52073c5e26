"""Downstream ML experiment: tile classification, TCGA-GBM vs TCGA-LUAD
(port of ``rnagan_tpu/train/ml_experiment.py``).

A ResNet (``MLConfig.arch``, ResNet50 by default) classifies tiles under
5-fold stratified CV: AdamW at lr 3e-5 and weight decay 0.01 (``optax.adamw``,
one K3 launch a step over every parameter tensor), cross-entropy, random
horizontal and vertical flips and ImageNet normalization on the card,
best-on-val keeping, accuracy and weighted F1 (reference
``ml_experiments.py:282-362``).

One :meth:`TileClassifierTrainer.train_step` is the JAX package's
``_train_step_impl`` on one card. It updates the state in place (BatchNorm's
running statistics, the parameters, AdamW's moments) and returns it, so
``fit`` keeps a deep copy of the best state, as the JAX loop copies its
donated buffers. The flips are Philox uniforms from the step's seed
(``core/rng.py``, stream ``"ml"``), or are given as ``draws={"flip_h",
"flip_v"}`` (bool (N,)), which is how the tests hand both packages the same
draws; ``fit_resident``'s per-epoch permutations likewise (a Philox sort
key from ``("ml_epoch", epoch)``, or ``draws["perms"]``).

On a CUDA device with one rank the train and eval steps replay captured
CUDA graphs (``train/graph_steps.py``): ``fit`` enqueues an epoch's host
batches in chunks of pinned tables, and ``fit_resident`` an epoch's steps
as replays that read the permutation's rows from one index table, then
the validation as eval replays; one copy an epoch comes off the card, its
metrics and predictions, as the JAX scan returns them
(``rnagan_tpu/train/ml_experiment.py:231-313``). :meth:`TileClassifierTrainer.train_step_eager`
is the plain version (the CPU, a mesh of several ranks).

Under a mesh (``MLConfig.mesh``; the data axis) ``train_step`` takes this
rank's rows of the global batch, the flips are drawn (or given) for the
global batch and sliced, BatchNorm reduces over the data group, the masked
cross-entropy is this rank's share over the global count and the gradients
are summed over the data group before AdamW (``parallel/collectives.py``).
``fit`` and ``fit_resident`` pad and slice the global batches; validation
runs whole on every rank and rank 0's accuracy decides the best epoch.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rnagan_tpu_torch.core import rng
from rnagan_tpu_torch.core.config import MLConfig
from rnagan_tpu_torch.core.metrics import MetricsLogger, epoch_means
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.data.batching import batch_indices
from rnagan_tpu_torch.models.resnet import ARCHS, ResNet
from rnagan_tpu_torch.optim.adam import AdamW
from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.parallel.mesh import Mesh, local_rows, make_mesh, module_tensors, replicated
from rnagan_tpu_torch.train.graph_steps import GraphSteps
from rnagan_tpu_torch.train.step_graph import StepGraphs, chunk_steps

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

Metrics = Dict[str, torch.Tensor]


@dataclass
class MLTrainState:
    """``model`` holds the parameters and BatchNorm statistics, ``opt`` AdamW's state."""

    step: int
    model: ResNet
    opt: AdamW


def stratified_folds(labels: np.ndarray, n_folds: int, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, val_idx) per fold, class-stratified (the reference uses
    sklearn StratifiedKFold, ``ml_experiments.py:282``)."""
    rng = np.random.RandomState(seed)
    per_class = {}
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        per_class[c] = np.array_split(idx, n_folds)
    folds = []
    for f in range(n_folds):
        val = np.concatenate([per_class[c][f] for c in per_class])
        train = np.concatenate([np.concatenate([per_class[c][g] for g in range(n_folds) if g != f])
                                for c in per_class])
        folds.append((np.sort(train), np.sort(val)))
    return folds


def weighted_f1(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int) -> float:
    """Support-weighted F1 (sklearn's weighted F1, ``ml_experiments.py:211-216``)."""
    total = len(y_true)
    score = 0.0
    for c in range(num_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        score += f1 * (np.sum(y_true == c) / total)
    return float(score)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                         group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, accuracy)`` over the valid rows (``mask`` 1), the JAX loss_fn's;
    with a data ``group``, this rank's shares of them over the global count."""
    logp = torch.log_softmax(logits.float(), dim=1)
    per = -logp.gather(1, labels[:, None])[:, 0]
    count = collectives.global_count(mask, group)
    acc = ((logits.argmax(1) == labels).float() * mask).sum() / count
    return (per * mask).sum() / count, acc


def unit_from_uint8(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 ``x / 255``, an IEEE division on any device (PyTorch's
    CUDA division by a Python number multiplies by the reciprocal)."""
    return images.float() / torch.full((), 255.0, device=images.device)


def as_draw(x) -> torch.Tensor:
    """A given draw as a tensor (a numpy or JAX array is copied: it may be read-only)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def flip_views(x: torch.Tensor, flip_h: torch.Tensor, flip_v: torch.Tensor) -> torch.Tensor:
    """Per-sample horizontal then vertical flips of NHWC ``x`` (the JAX
    ``_augment``, branchless)."""
    flip_h = flip_h.to(x.device, torch.bool).reshape(-1, 1, 1, 1)
    flip_v = flip_v.to(x.device, torch.bool).reshape(-1, 1, 1, 1)
    x = torch.where(flip_h, x.flip(2), x)
    return torch.where(flip_v, x.flip(1), x)


def draw_flips(seed, n: int, device) -> torch.Tensor:
    """Horizontal and vertical flips of ``n`` tiles, bool (2, n), from
    ``seed`` (an int or a one-element int tensor on ``device``): Philox
    uniforms (``core/rng.py::uniform``) below 0.5."""
    return rng.uniform(seed, (2, n), device) < 0.5


def given_flips(draws: Dict[str, Any]) -> torch.Tensor:
    """Given ``{"flip_h", "flip_v"}`` (bool (N,) each) as one bool (2, N) tensor."""
    return torch.stack([as_draw(draws[k]).reshape(-1).to(torch.bool) for k in ("flip_h", "flip_v")])


class TileClassifierTrainer(GraphSteps):
    """Tile classifier on one card, or data-parallel over ``mesh`` (default
    ``make_mesh(cfg.mesh, device)``); ``device="cuda"``, the default, raises
    without CUDA. ``model`` builds the ResNet (called with ``seed=`` and
    ``device=``; default ``cfg.arch`` with ``cfg.num_classes``), anew for
    each ``init_state``; ``backbone_variables`` is a state_dict overlaid on
    it (a torchvision backbone through ``models/resnet.py::
    state_dict_from_torchvision``, or ``SimCLRTrainer.backbone_variables``)."""

    stream, stages, draw_table, metric_keys = "ml", 1, "flips", ("loss", "acc")

    def __init__(self, cfg: MLConfig, *, model: Optional[Callable[..., ResNet]] = None,
                 logger: Optional[MetricsLogger] = None,
                 backbone_variables: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh, device)
        self.device = self.mesh.device
        self.model = model or partial(ARCHS[cfg.arch], num_classes=cfg.num_classes)
        self.logger = logger or MetricsLogger()
        self.seeds = SeedStream(cfg.seed)
        self._backbone_variables = backbone_variables
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)
        self.step_graphs = StepGraphs(self.device, self.mesh)

    def init_state(self) -> MLTrainState:
        model = self.model(seed=self.seeds.seed("init"), device=self.device)
        if self._backbone_variables:  # the JAX trainers' overlay (ml_experiment.py:114-125)
            extra = model.load_state_dict(self._backbone_variables, strict=False).unexpected_keys
            if extra:
                raise ValueError(f"backbone_variables has entries the model lacks: {extra[:3]}")
        replicated(module_tensors(model), self.mesh)
        return MLTrainState(0, model, AdamW(list(model.parameters()), self.cfg.lr, self.cfg.weight_decay))

    def state_from_jax(self, tree) -> MLTrainState:
        """A JAX ``MLTrainState`` (``step``, ``params``, ``batch_stats``,
        ``opt_state``; numpy or JAX leaves) on this trainer's device."""
        from rnagan_tpu_torch import convert

        state = self.init_state()
        state.model.load_state_dict(convert.resnet_state_dict_from_jax(
            state.model, {"params": tree.params, "batch_stats": tree.batch_stats}))
        load_adamw(state.opt, [n for n, _ in state.model.named_parameters()], tree.opt_state)
        state.step = int(np.asarray(tree.step))
        return state

    # ------------------------------------------------------------- transforms
    def normalize(self, x01: torch.Tensor) -> torch.Tensor:
        """ImageNet normalization of NHWC ``x01``."""
        return (x01 - self._mean) / self._std

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype)

    def _nchw(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2)  # a channels-last view: cuDNN's NHWC kernels take it as it is

    # ------------------------------------------------------------------ steps
    def _step(self, state: MLTrainState, inputs, given: Optional[torch.Tensor], seeds, corr) -> Metrics:
        """One train step in place on ``inputs`` = (NHWC [0, 1] images,
        labels, mask), this rank's rows; ``given`` the global batch's flips
        (bool (2, N): horizontal, vertical) or None to draw them from
        ``seeds[0]`` (a host int, or an int64 on the device in a graph);
        ``corr`` AdamW's device corrections, or None for host floats.
        ``state.step`` does not advance."""
        x01, y, m = inputs
        mesh = self.mesh
        n = len(x01) * mesh.data
        flips = draw_flips(seeds[0], n, self.device) if given is None else given.to(self.device, torch.bool)
        flips = flips[:, local_rows(n, mesh)]
        model = state.model.train()
        loss, acc = masked_cross_entropy(model(self._nchw(self.normalize(flip_views(x01, flips[0], flips[1])))),
                                         y, m, mesh.data_group)
        params = list(model.parameters())
        grads = collectives.all_reduce_grads(torch.autograd.grad(loss, params), mesh.data_group)
        state.opt.step(params, grads, corr=corr)
        return collectives.reduce_metrics({"loss": loss.detach(), "acc": acc.detach()}, mesh.data_group)

    @torch.no_grad()
    def _eval(self, state: MLTrainState, inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = state.model.eval()(self._nchw(self.normalize(inputs[0])))
        return logits.argmax(1), torch.log_softmax(logits.float(), dim=1)

    def train_step(self, state: MLTrainState, images01, labels, mask,
                   draws: Optional[Dict[str, Any]] = None) -> Tuple[MLTrainState, Metrics]:
        """One step on NHWC ``images01`` in [0, 1] with int ``labels`` and
        ``mask`` (1 on valid rows): under a mesh, this rank's rows of the
        global batch. ``draws`` may give the global batch's ``flip_h``/``flip_v``.
        Where :meth:`captures`, a replay of the step's graph; else
        :meth:`train_step_eager`."""
        if not self.captures():
            return self.train_step_eager(state, images01, labels, mask, draws)
        x = torch.as_tensor(images01, dtype=torch.float32)
        tables = {"images": x[None], "labels": torch.as_tensor(labels, dtype=torch.int64)[None],
                  "mask": torch.as_tensor(mask, dtype=torch.float32)[None]}
        if draws and "flip_h" in draws:
            tables["flips"] = given_flips(draws)[None]
        vec = self.run_steps(state, tables, self._host_prepare(len(x), shard=True), 1)[0]
        return state, dict(zip(self.metric_keys, vec.unbind(0)))

    def train_step_eager(self, state: MLTrainState, images01, labels, mask,
                         draws: Optional[Dict[str, Any]] = None) -> Tuple[MLTrainState, Metrics]:
        """:meth:`train_step` op by op from the host (a host-int seed,
        AdamW's corrections as host floats): its plain version, and the step
        of the CPU and of a mesh of several ranks."""
        given = given_flips(draws) if draws and "flip_h" in draws else None
        inputs = (self._tensor(images01), self._tensor(labels, torch.int64), self._tensor(mask))
        with collectives.active(self.mesh):
            metrics = self._step(state, inputs, given, self._step_seeds(state.step), None)
        state.step += 1
        return state, metrics

    def eval_step(self, state: MLTrainState, images01) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(argmax prediction, log-softmax)`` of a batch in eval mode; a
        replay of the eval graph where :meth:`captures`."""
        if not self.captures():
            return self.eval_step_eager(state, images01)
        x = torch.as_tensor(images01, dtype=torch.float32)
        pred, logp = self.run_eval(state, {"images": x[None]}, self._host_prepare(len(x), shard=False), 1)
        return pred[0], logp[0]

    def eval_step_eager(self, state: MLTrainState, images01) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`eval_step` op by op."""
        return self._eval(state, (self._tensor(images01),))

    # --------------------------------------------------------------- prepares
    def _host_prepare(self, rows: int, shard: bool):
        """Steps whose tables hold the batch (``images``, and ``labels`` and
        ``mask`` for a train step): this rank's rows of it when ``shard``."""
        def build():
            mesh, dev = self.mesh, self.device

            def fn(step_rows):
                local = local_rows(rows, mesh) if shard else slice(None)
                return tuple(step_rows[k].to(dev)[local] for k in ("images", "labels", "mask") if k in step_rows)
            return fn
        return self.step_graphs.prepared(("host", rows, shard), build)

    def _resident_prepare(self, images: torch.Tensor, labels: Optional[torch.Tensor], rows: int, shard: bool):
        """Steps whose ``idx`` table holds row indices into a uint8 NHWC set
        on the card (``x / 255`` there): with ``labels`` a train step's
        inputs (the mask all ones), without them an eval step's."""
        key = ("idx", images.data_ptr(), tuple(images.shape), None if labels is None else labels.data_ptr(), rows,
               shard)

        def build():
            mesh, dev = self.mesh, self.device
            ones = torch.ones(rows // mesh.data if shard else rows, device=dev)

            def fn(step_rows):
                idx = step_rows["idx"].to(dev)
                if shard:
                    idx = idx[local_rows(rows, mesh)]
                x = unit_from_uint8(images.index_select(0, idx))
                return (x,) if labels is None else (x, labels.index_select(0, idx), ones)
            return fn
        return self.step_graphs.prepared(key, build)

    # ------------------------------------------------------------------ loops
    def _batches(self, n: int, epoch: int, shuffle: bool, pad_to: int = 1):
        yield from batch_indices(n, self.cfg.batch_size, shuffle=shuffle, seed=self.cfg.seed, epoch=epoch,
                                 pad_to=pad_to)

    def _keep_best(self, state, history, best_acc, best_state, epoch):
        history[-1].update(collectives.broadcast_scalars(history[-1], self.mesh))  # one decision
        self.logger.scalars("ml", history[-1], epoch)
        if history[-1]["val_acc"] > best_acc:
            return history[-1]["val_acc"], copy.deepcopy(state)  # the next epoch updates `state` in place
        return best_acc, best_state

    def _train_pass(self, state: MLTrainState, images01: np.ndarray, labels: np.ndarray,
                    epoch: int) -> torch.Tensor:
        """An epoch of host-fed train steps (shuffled batches, the last
        wrap-padded and masked, padded to the data-axis size), in chunks of
        at most ``CHUNK_BYTES`` of tables: the steps' metrics (steps, 2)."""
        batches = list(self._batches(len(images01), epoch, True, self.mesh.data))
        if not batches:
            return torch.zeros((0, len(self.metric_keys)), device=self.device)
        idx, masks = np.stack([i for i, _ in batches]), np.stack([m for _, m in batches])
        steps, rows = idx.shape
        cap = chunk_steps(steps, rows * (images01[0].size * 4 + 12))
        prepare = self._host_prepare(rows, shard=True)
        out = []
        for s in range(0, steps, cap):
            k = min(cap, steps - s)
            tables = {"images": torch.from_numpy(images01[idx[s:s + k]]),
                      "labels": torch.from_numpy(labels[idx[s:s + k]].astype(np.int64)),
                      "mask": torch.from_numpy(masks[s:s + k])}
            out.append(self.run_steps(state, tables, prepare, k, capacity=cap))
        return torch.cat(out)

    def _predict_pass(self, images01: np.ndarray, state: MLTrainState) -> Tuple[Optional[torch.Tensor], np.ndarray]:
        """Eval steps over host data in batches (the last wrap-padded), in
        chunks: the predictions (steps, rows) on the device and the masks."""
        batches = list(self._batches(len(images01), 0, False))
        if not batches:
            return None, np.zeros((0, 0), np.float32)
        idx, masks = np.stack([i for i, _ in batches]), np.stack([m for _, m in batches])
        steps, rows = idx.shape
        cap = chunk_steps(steps, rows * images01[0].size * 4)
        prepare = self._host_prepare(rows, shard=False)
        preds = [self.run_eval(state, {"images": torch.from_numpy(images01[idx[s:s + cap]])}, prepare,
                               min(cap, steps - s), capacity=cap)[0] for s in range(0, steps, cap)]
        return torch.cat(preds), masks

    def fit(self, images01: np.ndarray, labels: np.ndarray, val_images01: np.ndarray, val_labels: np.ndarray,
            state: Optional[MLTrainState] = None) -> Tuple[MLTrainState, Dict[str, Any]]:
        """Host-fed epochs with best-on-val-accuracy keeping (reference
        ``ml_experiments.py:152-158``); a short last batch is wrap-padded
        and masked (``data/batching.py``). An epoch's steps and its
        validation are enqueued in chunks of tables; its metrics and
        predictions come off the card in one copy."""
        state = state if state is not None else self.init_state()
        images01, labels = np.asarray(images01, np.float32), np.asarray(labels)
        val_images01 = np.asarray(val_images01, np.float32)
        best_acc, best_state, history = -1.0, None, []
        for epoch in range(self.cfg.num_epochs):
            rows = self._train_pass(state, images01, labels, epoch)
            preds, masks = self._predict_pass(val_images01, state)
            means, val_pred = epoch_means(rows, self.metric_keys, preds)
            val_pred = np.zeros(0, np.int64) if preds is None else val_pred.reshape(masks.shape)[masks > 0]
            history.append({**(means or {"loss": 0.0, "acc": 0.0}),
                            "val_acc": float(np.mean(val_pred == val_labels))})
            best_acc, best_state = self._keep_best(state, history, best_acc, best_state, epoch)
        if best_state is None:
            best_state = state  # no epoch, or every validation accuracy NaN: the final state
        return best_state, {"history": history, "best_val_acc": best_acc}

    def resident_epoch(self, state: MLTrainState, images: torch.Tensor, labels: torch.Tensor, val: torch.Tensor,
                       epoch: int, perm: Optional[torch.Tensor] = None,
                       flips: Sequence[Dict[str, Any]] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
        """One epoch of :meth:`fit_resident`, enqueued: the epoch's
        permutation (``perm`` on the device, or drawn there from the
        ``("ml_epoch", epoch)`` seed), ``len(images) // batch`` train steps on
        its rows (the remainder dropped; ``flips`` the steps' given flips, or
        none), and the predictions over ``val``. Returns the steps' metrics
        (steps, 2) and the predictions (len(val),) on the device: nothing
        here waits for the card (where :meth:`captures`, the steps and the
        validation are graph replays from one table each)."""
        batch = self.cfg.batch_size
        steps = max(len(images) // batch, 1)
        if perm is None:
            perm = rng.permutation(self.seeds.seed("ml_epoch", epoch), len(images), self.device)
        tables = {"idx": perm[: steps * batch].reshape(steps, batch)}
        if flips:
            tables["flips"] = torch.stack([given_flips(f) for f in flips])
        rows = self.run_steps(state, tables, self._resident_prepare(images, labels, batch, shard=True), steps)
        return rows, self._predict_resident(val, state)

    def fit_resident(self, images_u8, labels, val_images_u8, val_labels,
                     state: Optional[MLTrainState] = None, verbose: bool = False,
                     draws: Optional[Dict[str, Sequence]] = None) -> Tuple[MLTrainState, Dict[str, Any]]:
        """Epochs over a uint8 NHWC tile set held on the card: one permutation
        an epoch (remainder dropped), ``x / 255`` on the card, and one copy
        off the card an epoch, its metrics and validation predictions
        (:meth:`resident_epoch`). ``draws`` may give ``perms`` (one
        permutation of ``len(images_u8)`` an epoch) and ``flips`` (one
        ``{"flip_h", "flip_v"}`` a step, in order, whole epochs of them)."""
        cfg, batch = self.cfg, self.cfg.batch_size
        images = torch.as_tensor(images_u8).to(self.device)
        labs = self._tensor(labels, torch.int64)
        val = torch.as_tensor(val_images_u8).to(self.device)
        val_labels = np.asarray(val_labels)
        n_steps = max(images.shape[0] // batch, 1)
        if batch % self.mesh.data:
            raise ValueError(f"batch_size {batch} does not split over {self.mesh.data} data ranks")
        state = state if state is not None else self.init_state()
        draws = draws or {}
        flips = list(draws.get("flips", ()))
        best_acc, best_state, history = -1.0, None, []
        for epoch in range(cfg.num_epochs):
            epoch_flips, flips = flips[:n_steps], flips[n_steps:]
            if 0 < len(epoch_flips) < n_steps:
                raise ValueError(f"given flips cover whole epochs of {n_steps} steps; {len(epoch_flips)} left")
            perm = as_draw(draws["perms"][epoch]).to(self.device) if "perms" in draws else None
            rows, preds = self.resident_epoch(state, images, labs, val, epoch, perm, epoch_flips)
            means, val_pred = epoch_means(rows, self.metric_keys, preds)
            val_acc = float(np.mean(val_pred == val_labels))
            history.append({**means, "val_acc": val_acc})
            if verbose:
                print(f"  [ml epoch {epoch}] loss={means['loss']:.4f} acc={means['acc']:.4f} "
                      f"val_acc={val_acc:.4f}", flush=True)
            best_acc, best_state = self._keep_best(state, history, best_acc, best_state, epoch)
        if best_state is None:
            best_state = state
        return best_state, {"history": history, "best_val_acc": best_acc}

    def _predict_resident(self, images: torch.Tensor, state: MLTrainState) -> torch.Tensor:
        """Predictions (len(images),) on the device over a uint8 set there,
        a batch a step (the tail batch padded by repeating the last row)."""
        batch = self.cfg.batch_size
        n = int(images.shape[0])
        idx = torch.clamp(torch.arange(-(-n // batch) * batch, device=self.device), max=n - 1).reshape(-1, batch)
        pred = self.run_eval(state, {"idx": idx}, self._resident_prepare(images, None, batch, shard=False),
                             len(idx))[0]
        return pred.reshape(-1)[:n]

    def predict_resident(self, images_u8, state: MLTrainState) -> np.ndarray:
        """Predictions over a uint8 set on the card, a batch at a time (the
        tail batch padded by repeating the last row; its extra rows dropped)."""
        return self._predict_resident(torch.as_tensor(images_u8).to(self.device), state).cpu().numpy()

    def predict(self, images01: np.ndarray, state: MLTrainState) -> np.ndarray:
        preds, masks = self._predict_pass(np.asarray(images01, np.float32), state)
        return np.zeros(0, np.int64) if preds is None else preds.cpu().numpy()[masks > 0]

    def evaluate(self, images01: np.ndarray, labels: np.ndarray, state: MLTrainState) -> Dict[str, float]:
        pred = self.predict(images01, state)
        return {"accuracy": float(np.mean(pred == labels)),
                "weighted_f1": weighted_f1(labels, pred, self.cfg.num_classes)}


def load_adamw(opt: AdamW, names: Sequence[str], opt_state) -> None:
    """An optax adamw state (``convert.adamw_state_from_jax``) into ``opt``,
    whose tensors are the parameters ``names``."""
    from rnagan_tpu_torch import convert

    moved = convert.adamw_state_from_jax(names, opt_state)
    opt.count = moved["count"]
    for dst, src in zip([*opt.mu, *opt.nu], [*moved["mu"], *moved["nu"]], strict=True):
        dst.copy_(src.reshape(dst.shape))


def run_cv_experiment(images01: np.ndarray, labels: np.ndarray, cfg: Optional[MLConfig] = None, *,
                      test_images01: Optional[np.ndarray] = None, test_labels: Optional[np.ndarray] = None,
                      backbone_variables: Optional[Dict[str, torch.Tensor]] = None,
                      model: Optional[Callable[..., ResNet]] = None, device="cuda",
                      mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The 5-fold CV protocol (reference ``ml_experiments.py:282-362``): per
    fold a fresh model trained on the other folds, its best-on-val state
    evaluated on the fold (and on a held-out test set when given, e.g. real
    tiles for a model trained on synthetic ones); data-parallel over
    ``mesh`` when given."""
    cfg = cfg or MLConfig()
    results: Dict[str, Any] = {"folds": []}
    for f, (tr_idx, va_idx) in enumerate(stratified_folds(labels, cfg.folds, cfg.seed)):
        trainer = TileClassifierTrainer(cfg, model=model, backbone_variables=backbone_variables, device=device,
                                        mesh=mesh)
        state, _ = trainer.fit(images01[tr_idx], labels[tr_idx], images01[va_idx], labels[va_idx])
        fold = {"fold": f, **trainer.evaluate(images01[va_idx], labels[va_idx], state)}
        if test_images01 is not None:
            fold["test"] = trainer.evaluate(test_images01, test_labels, state)
        results["folds"].append(fold)
        trainer.step_graphs.release()  # the fold's graphs and their pools, before the next fold captures its own
        del state
    results["mean_accuracy"] = float(np.mean([x["accuracy"] for x in results["folds"]]))
    results["mean_weighted_f1"] = float(np.mean([x["weighted_f1"] for x in results["folds"]]))
    return results
