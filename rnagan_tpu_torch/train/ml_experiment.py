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
donated buffers. The flips come from a ``core/rng.py`` generator per step
(``"ml"``), or are given as ``draws={"flip_h", "flip_v"}`` (bool (N,)), which
is how the tests hand both packages the same draws; ``fit_resident``'s
per-epoch permutations likewise (``"ml_epoch"``, or ``draws["perms"]``).

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

from rnagan_tpu_torch.core.config import MLConfig
from rnagan_tpu_torch.core.metrics import MetricsLogger, epoch_means
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.data.batching import batch_indices
from rnagan_tpu_torch.models.resnet import ARCHS, ResNet
from rnagan_tpu_torch.optim.adam import AdamW
from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.parallel.mesh import Mesh, local_rows, make_mesh, module_tensors, replicated, shard_batch

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


class TileClassifierTrainer:
    """Tile classifier on one card, or data-parallel over ``mesh`` (default
    ``make_mesh(cfg.mesh, device)``); ``device="cuda"``, the default, raises
    without CUDA. ``model`` builds the ResNet (called with ``seed=`` and
    ``device=``; default ``cfg.arch`` with ``cfg.num_classes``), anew for
    each ``init_state``; ``backbone_variables`` is a state_dict overlaid on
    it (a torchvision backbone through ``models/resnet.py::
    state_dict_from_torchvision``, or ``SimCLRTrainer.backbone_variables``)."""

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
    def train_step(self, state: MLTrainState, images01, labels, mask,
                   draws: Optional[Dict[str, Any]] = None) -> Tuple[MLTrainState, Metrics]:
        """One step on NHWC ``images01`` in [0, 1] with int ``labels`` and
        ``mask`` (1 on valid rows): under a mesh, this rank's rows of the
        global batch. ``draws`` may give the global batch's ``flip_h``/``flip_v``."""
        mesh = self.mesh
        x = self._tensor(images01)
        y, m = self._tensor(labels, torch.int64), self._tensor(mask)
        draws = draws or {}
        n = len(x) * mesh.data
        if "flip_h" not in draws:
            gen = self.seeds.generator("ml", state.step, device=self.device)
            draws = {"flip_h": torch.rand(n, generator=gen, device=self.device) < 0.5,
                     "flip_v": torch.rand(n, generator=gen, device=self.device) < 0.5}
        rows = local_rows(n, mesh)
        x = self.normalize(flip_views(x, as_draw(draws["flip_h"])[rows], as_draw(draws["flip_v"])[rows]))
        model = state.model.train()
        with collectives.active(mesh):
            loss, acc = masked_cross_entropy(model(self._nchw(x)), y, m, mesh.data_group)
            params = list(model.parameters())
            grads = collectives.all_reduce_grads(torch.autograd.grad(loss, params), mesh.data_group)
        state.opt.step(params, grads)
        state.step += 1
        return state, collectives.reduce_metrics({"loss": loss.detach(), "acc": acc.detach()},
                                                 mesh.data_group)

    @torch.no_grad()
    def eval_step(self, state: MLTrainState, images01) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(argmax prediction, log-softmax)`` of a batch in eval mode."""
        logits = state.model.eval()(self._nchw(self.normalize(self._tensor(images01))))
        return logits.argmax(1), torch.log_softmax(logits.float(), dim=1)

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

    def fit(self, images01: np.ndarray, labels: np.ndarray, val_images01: np.ndarray, val_labels: np.ndarray,
            state: Optional[MLTrainState] = None) -> Tuple[MLTrainState, Dict[str, Any]]:
        """Host-fed epochs with best-on-val-accuracy keeping (reference
        ``ml_experiments.py:152-158``); a short last batch is wrap-padded
        and masked (``data/batching.py``)."""
        state = state if state is not None else self.init_state()
        best_acc, best_state, history = -1.0, None, []
        for epoch in range(self.cfg.num_epochs):
            per_step = []
            for idx, mask in self._batches(len(images01), epoch, True, self.mesh.data):
                idx, mask = shard_batch((idx, mask), self.mesh)
                state, metrics = self.train_step(state, images01[idx], labels[idx], mask)
                per_step.append(metrics)
            means = epoch_means(per_step) or {"loss": 0.0, "acc": 0.0}
            val_acc = float(np.mean(self.predict(val_images01, state) == val_labels))
            history.append({**means, "val_acc": val_acc})
            best_acc, best_state = self._keep_best(state, history, best_acc, best_state, epoch)
        if best_state is None:
            best_state = state  # no epoch, or every validation accuracy NaN: the final state
        return best_state, {"history": history, "best_val_acc": best_acc}

    def fit_resident(self, images_u8, labels, val_images_u8, val_labels,
                     state: Optional[MLTrainState] = None, verbose: bool = False,
                     draws: Optional[Dict[str, Sequence]] = None) -> Tuple[MLTrainState, Dict[str, Any]]:
        """Epochs over a uint8 NHWC tile set held on the card: one permutation
        an epoch (remainder dropped), ``x / 255`` on the card, no host traffic
        a step but the metrics at the epoch's end. ``draws`` may give
        ``perms`` (one permutation of ``len(images_u8)`` an epoch) and
        ``flips`` (one ``{"flip_h", "flip_v"}`` a step, in order)."""
        cfg, batch = self.cfg, self.cfg.batch_size
        images = torch.as_tensor(images_u8).to(self.device)
        labs = self._tensor(labels, torch.int64)
        val = torch.as_tensor(val_images_u8).to(self.device)
        n = images.shape[0]
        n_steps = max(n // batch, 1)
        if batch % self.mesh.data:
            raise ValueError(f"batch_size {batch} does not split over {self.mesh.data} data ranks")
        ones = torch.ones(batch // self.mesh.data, device=self.device)
        state = state if state is not None else self.init_state()
        draws = draws or {}
        flips = iter(draws.get("flips", ()))
        best_acc, best_state, history = -1.0, None, []
        for epoch in range(cfg.num_epochs):
            if "perms" in draws:
                perm = as_draw(draws["perms"][epoch]).to(self.device)
            else:
                gen = self.seeds.generator("ml_epoch", epoch, device=self.device)
                perm = torch.randperm(n, generator=gen, device=self.device)
            per_step = []
            for idx in perm[: n_steps * batch].reshape(n_steps, batch):
                idx = shard_batch(idx, self.mesh)
                state, metrics = self.train_step(state, unit_from_uint8(images[idx]), labs[idx], ones,
                                                 next(flips, None))
                per_step.append(metrics)
            means = epoch_means(per_step)
            val_acc = float(np.mean(self.predict_resident(val, state) == np.asarray(val_labels)))
            history.append({**means, "val_acc": val_acc})
            if verbose:
                print(f"  [ml epoch {epoch}] loss={means['loss']:.4f} acc={means['acc']:.4f} "
                      f"val_acc={val_acc:.4f}", flush=True)
            best_acc, best_state = self._keep_best(state, history, best_acc, best_state, epoch)
        if best_state is None:
            best_state = state
        return best_state, {"history": history, "best_val_acc": best_acc}

    def predict_resident(self, images_u8, state: MLTrainState) -> np.ndarray:
        """Predictions over a uint8 set on the card, a batch at a time (the
        tail batch padded by repeating the last row; its extra rows dropped)."""
        batch = self.cfg.batch_size
        images = torch.as_tensor(images_u8).to(self.device)
        n = int(images.shape[0])
        idxs = torch.clamp(torch.arange(-(-n // batch) * batch, device=self.device), max=n - 1)
        preds = [self.eval_step(state, unit_from_uint8(images[idx]))[0] for idx in idxs.reshape(-1, batch)]
        return torch.cat(preds).cpu().numpy()[:n]

    def predict(self, images01: np.ndarray, state: MLTrainState) -> np.ndarray:
        preds = []
        for idx, mask in self._batches(len(images01), 0, False):
            p, _ = self.eval_step(state, images01[idx])
            preds.append(p.cpu().numpy()[mask > 0])
        return np.concatenate(preds) if preds else np.zeros(0, np.int64)

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
        del state
    results["mean_accuracy"] = float(np.mean([x["accuracy"] for x in results["folds"]]))
    results["mean_weighted_f1"] = float(np.mean([x["weighted_f1"] for x in results["folds"]]))
    return results
