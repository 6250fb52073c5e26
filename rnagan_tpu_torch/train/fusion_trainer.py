"""Multimodal fusion training (port of ``rnagan_tpu/train/fusion_trainer.py``).

Bags of tiles per slide and the patient's RNA profile go through a ResNet
backbone and the β-VAE's ``RNAEncoder`` into :class:`~rnagan_tpu_torch.models.fusion.FusionModel`,
trained with cross-entropy (reference ``main.py:84-96,136-164``). The
backbone's ``conv1``, ``bn1``, ``layer1`` and ``layer2`` are frozen
(``main.py:136-143``): the JAX package gives them zero updates through
``optax.multi_transform``; here they never enter AdamW's table (one K3
launch a step over the trainable tensors only), keep no moments, stay
bit-unchanged and are left out of autograd. Their BatchNorm running
statistics still move in train mode, as flax's ``mutable=["batch_stats"]``
moves them.

Inputs are ``tiles_to_float(bags) * 0.5 + 0.5`` ([0, 1], no ImageNet
normalization, as in the JAX trainer), computed on the card from the uint8
bags with the same float32 arithmetic. The RNA encoder's dropout mask is
drawn from the step's seed (``core/rng.py``, stream ``"fusion"``;
``models/betavae.py::draw_keep``, four Philox words a counter) or is given
as ``draws={"keep"}``.

On a CUDA device with one rank the train and eval steps replay captured
CUDA graphs (``train/graph_steps.py``); ``fit`` and ``predict`` enqueue an
epoch's bags in chunks of pinned tables. K3 runs once a step over the
trainable tensors; the frozen ones are in the graph's state only as what
its BatchNorms read. :meth:`FusionTrainer.train_step_eager` is the plain
version.

Under a mesh (``FusionConfig.mesh``; the data axis) the bags are split over
the ranks: ``train_step`` takes this rank's bags of the global batch, the
dropout mask is drawn (or given) for the global batch and sliced, every
BatchNorm (the frozen stages' included) reduces over the data group, the
masked cross-entropy is this rank's share and the trainable gradients are
summed over the group before AdamW.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from rnagan_tpu_torch.core.config import MeshConfig
from rnagan_tpu_torch.core.metrics import MetricsLogger, epoch_means
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.data.batching import batch_indices
from rnagan_tpu_torch.data.patches import BagData
from rnagan_tpu_torch.models.betavae import draw_keep
from rnagan_tpu_torch.models.fusion import FusionModel
from rnagan_tpu_torch.models.resnet import ResNet, resnet50
from rnagan_tpu_torch.optim.adam import AdamW
from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.parallel.mesh import Mesh, local_rows, make_mesh, module_tensors, replicated
from rnagan_tpu_torch.train.graph_steps import GraphSteps
from rnagan_tpu_torch.train.step_graph import StepGraphs, chunk_steps
from rnagan_tpu_torch.train.ml_experiment import as_draw, load_adamw, masked_cross_entropy, unit_from_uint8

#: top-level backbone modules frozen by ``freeze_backbone_early``
FROZEN_STAGES = ("conv1", "bn1", "layer1", "layer2")


@dataclass(frozen=True)
class FusionConfig:
    num_classes: int = 2
    lr: float = 3e-4
    weight_decay: float = 0.0
    num_epochs: int = 10
    batch_size: int = 4
    bag_size: int = 40
    rna_hidden_dims: Tuple[int, ...] = (6000, 4000, 2048)
    #: freeze every backbone stage except layer3/layer4 (+ heads), main.py:136-143
    freeze_backbone_early: bool = True
    seed: int = 99
    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass
class FusionTrainState:
    step: int
    model: FusionModel
    opt: AdamW


def _trainable_mask(names: Iterable[str], freeze_early: bool) -> Dict[str, bool]:
    """True where trainable, over the backbone's parameter names: only the
    top-level module decides (a block's inner ``conv1``/``bn1`` do not)."""
    return {n: not (freeze_early and n.split(".")[0] in FROZEN_STAGES) for n in names}


def trainable_names(model: FusionModel, freeze_early: bool):
    """The model's trainable parameter names, in ``named_parameters`` order."""
    mask = _trainable_mask([n for n, _ in model.backbone.named_parameters()], freeze_early)
    return [n for n, _ in model.named_parameters()
            if not n.startswith("backbone.") or mask[n[len("backbone."):]]]


class FusionTrainer(GraphSteps):
    """Fusion training on one card, or data-parallel over ``mesh`` (default
    ``make_mesh(cfg.mesh, device)``); ``device="cuda"``, the default, raises
    without CUDA. ``backbone`` builds the headless ResNet (called with
    ``num_classes=0``, ``seed=`` and ``device=``; default ResNet50)."""

    stream, stages, draw_table, metric_keys = "fusion", 1, "keep", ("loss", "acc")

    def __init__(self, cfg: FusionConfig, *, backbone: Optional[Callable[..., ResNet]] = None,
                 logger: Optional[MetricsLogger] = None, device="cuda", mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh, device)
        self.device = self.mesh.device
        self.backbone = backbone or resnet50
        self.logger = logger or MetricsLogger()
        self.seeds = SeedStream(cfg.seed)
        self.step_graphs = StepGraphs(self.device, self.mesh)

    def init_state(self, bag_shape: Tuple[int, ...], rna_features: int) -> FusionTrainState:
        """A fresh state for bags of ``bag_shape`` (bag, H, W, C) and
        ``rna_features`` genes; the frozen parameters set not to require grad."""
        cfg = self.cfg
        if bag_shape[-1] != 3:
            raise ValueError(f"bags must be (bag, H, W, 3), got {tuple(bag_shape)}")
        bb = self.backbone(num_classes=0, seed=self.seeds.seed("init"), device=self.device)
        model = FusionModel(bb, rna_features, cfg.rna_hidden_dims, cfg.num_classes,
                            seed=self.seeds.seed("init", stage=1), device=self.device)
        replicated(module_tensors(model), self.mesh)
        names = set(trainable_names(model, cfg.freeze_backbone_early))
        params = []
        for n, p in model.named_parameters():
            p.requires_grad_(n in names)
            if n in names:
                params.append(p)
        return FusionTrainState(0, model, AdamW(params, cfg.lr, cfg.weight_decay))

    def state_from_jax(self, tree, bag_shape, rna_features) -> FusionTrainState:
        """A JAX ``FusionTrainState`` (its ``multi_transform`` state holds
        moments of the trainable leaves only) on this trainer's device."""
        from rnagan_tpu_torch import convert

        state = self.init_state(bag_shape, rna_features)
        state.model.load_state_dict(convert.resnet_state_dict_from_jax(
            state.model, {"params": tree.params, "batch_stats": tree.batch_stats}))
        load_adamw(state.opt, trainable_names(state.model, self.cfg.freeze_backbone_early), tree.opt_state)
        state.step = int(np.asarray(tree.step))
        return state

    def _inputs(self, bags_u8, rna) -> Tuple[torch.Tensor, torch.Tensor]:
        x = unit_from_uint8(torch.as_tensor(bags_u8).to(self.device))
        x = (x - 0.5) / 0.5 * 0.5 + 0.5  # data/tiles.py::tiles_to_float, then * 0.5 + 0.5
        return x, torch.as_tensor(rna).to(self.device, torch.float32)

    def _step(self, state: FusionTrainState, inputs, given: Optional[torch.Tensor], seeds,
              corr) -> Dict[str, torch.Tensor]:
        """One train step in place on ``inputs`` = (bags in [0, 1], rna,
        labels, mask), this rank's bags; ``given`` the global batch's dropout
        mask (bool) or None to draw it from ``seeds[0]``; ``corr`` AdamW's
        device corrections or None. ``state.step`` does not advance."""
        x, r, y, m = inputs
        mesh = self.mesh
        n = len(r) * mesh.data
        rate = state.model.rna_encoder.encoder[0].rate
        keep = None
        if given is not None:
            keep = given.to(self.device, torch.bool)[local_rows(n, mesh)]
        elif rate:  # the global batch's mask, drawn as the encoder draws it
            keep = draw_keep(seeds[0], (n, r.shape[1]), rate, self.device)[local_rows(n, mesh)]
        model = state.model.train()
        loss, acc = masked_cross_entropy(model(x, r, keep), y, m, mesh.data_group)
        params = [p for p in model.parameters() if p.requires_grad]
        grads = collectives.all_reduce_grads(torch.autograd.grad(loss, params), mesh.data_group)
        state.opt.step(params, grads, corr=corr)
        return collectives.reduce_metrics({"loss": loss.detach(), "acc": acc.detach()}, mesh.data_group)

    @torch.no_grad()
    def _eval(self, state: FusionTrainState, inputs) -> Tuple[torch.Tensor]:
        return (state.model.eval()(*inputs).argmax(1),)

    def train_step(self, state: FusionTrainState, bags_u8, rna, labels, mask,
                   draws: Optional[Dict[str, Any]] = None) -> Tuple[FusionTrainState, Dict[str, torch.Tensor]]:
        """One step on uint8 ``bags_u8`` (B, bag, H, W, 3), ``rna`` (B, G),
        int ``labels`` and ``mask`` (under a mesh, this rank's bags of the
        global batch); ``draws`` may give ``keep``, the RNA encoder's dropout
        mask of the global batch (bool). Where :meth:`captures`, a replay of
        the step's graph; else :meth:`train_step_eager`."""
        if not self.captures():
            return self.train_step_eager(state, bags_u8, rna, labels, mask, draws)
        tables = {"bags": torch.as_tensor(bags_u8)[None], "rna": torch.as_tensor(rna, dtype=torch.float32)[None],
                  "labels": torch.as_tensor(labels, dtype=torch.int64)[None],
                  "mask": torch.as_tensor(mask, dtype=torch.float32)[None]}
        if (draws or {}).get("keep") is not None:
            tables["keep"] = as_draw(draws["keep"]).to(torch.bool)[None]
        vec = self.run_steps(state, tables, self._host_prepare(len(tables["rna"][0]), shard=True), 1)[0]
        return state, dict(zip(self.metric_keys, vec.unbind(0)))

    def train_step_eager(self, state: FusionTrainState, bags_u8, rna, labels, mask,
                         draws: Optional[Dict[str, Any]] = None) -> Tuple[FusionTrainState, Dict[str, torch.Tensor]]:
        """:meth:`train_step` op by op from the host (a host-int seed, host-float
        corrections): its plain version, and the step of the CPU and of a
        mesh of several ranks."""
        keep = (draws or {}).get("keep")
        inputs = (*self._inputs(bags_u8, rna), torch.as_tensor(labels).to(self.device, torch.int64),
                  torch.as_tensor(mask).to(self.device, torch.float32))
        with collectives.active(self.mesh):
            metrics = self._step(state, inputs, None if keep is None else as_draw(keep),
                                 self._step_seeds(state.step), None)
        state.step += 1
        return state, metrics

    def eval_step(self, state: FusionTrainState, bags_u8, rna) -> torch.Tensor:
        """Eval-mode class predictions of a batch of bags; a replay of the
        eval graph where :meth:`captures`."""
        if not self.captures():
            return self.eval_step_eager(state, bags_u8, rna)
        rna = torch.as_tensor(rna, dtype=torch.float32)
        tables = {"bags": torch.as_tensor(bags_u8)[None], "rna": rna[None]}
        return self.run_eval(state, tables, self._host_prepare(len(rna), shard=False), 1)[0][0]

    def eval_step_eager(self, state: FusionTrainState, bags_u8, rna) -> torch.Tensor:
        """:meth:`eval_step` op by op."""
        return self._eval(state, self._inputs(bags_u8, rna))[0]

    def _host_prepare(self, rows: int, shard: bool):
        """Steps whose tables hold the bags and RNA (and a train step's
        ``labels`` and ``mask``): this rank's bags when ``shard``."""
        def build():
            mesh, dev = self.mesh, self.device

            def fn(step_rows):
                local = local_rows(rows, mesh) if shard else slice(None)
                x, r = self._inputs(step_rows["bags"][local], step_rows["rna"][local])
                if "labels" not in step_rows:
                    return x, r
                return x, r, step_rows["labels"].to(dev)[local], step_rows["mask"].to(dev)[local]
            return fn
        return self.step_graphs.prepared(("host", rows, shard), build)

    def _pass(self, state: FusionTrainState, bags: BagData, *, train: bool, epoch: int = 0):
        """An epoch of train steps (shuffled, padded to the data-axis size)
        or the eval steps over every bag, in chunks of at most
        ``CHUNK_BYTES`` of tables: the train metrics (steps, 2), or the
        predictions (steps, batch) and the masks."""
        batches = list(batch_indices(len(bags), self.cfg.batch_size, shuffle=train, seed=self.cfg.seed,
                                     epoch=epoch, pad_to=self.mesh.data if train else 1))
        if not batches:
            return None, np.zeros((0, 0), np.float32)
        idx, masks = np.stack([i for i, _ in batches]), np.stack([m for _, m in batches])
        steps, rows = idx.shape
        step_bytes = rows * (bags.bags[0].nbytes + bags.rna.shape[1] * 4 + 12)
        cap = chunk_steps(steps, step_bytes)
        prepare = self._host_prepare(rows, shard=train)
        out = []
        for s in range(0, steps, cap):
            k = min(cap, steps - s)
            chunk = idx[s:s + k]
            tables = {"bags": torch.from_numpy(bags.bags[chunk]),
                      "rna": torch.from_numpy(np.asarray(bags.rna[bags.slide_idx[chunk]], np.float32))}
            if train:
                tables.update(labels=torch.from_numpy(np.asarray(bags.labels[chunk], np.int64)),
                              mask=torch.from_numpy(masks[s:s + k]))
                out.append(self.run_steps(state, tables, prepare, k, capacity=cap))
            else:
                out.append(self.run_eval(state, tables, prepare, k, capacity=cap)[0])
        return torch.cat(out), masks

    def fit(self, bags: BagData, *, num_epochs: Optional[int] = None,
            state: Optional[FusionTrainState] = None) -> Tuple[FusionTrainState, Dict[str, Any]]:
        """Epochs of shuffled batches of bags; an epoch's metrics come off the card in one copy."""
        if bags.rna is None:
            raise ValueError("fusion training needs per-slide RNA")
        cfg = self.cfg
        state = state if state is not None else self.init_state(bags.bags.shape[1:], bags.rna.shape[1])
        history = []
        for epoch in range(num_epochs or cfg.num_epochs):
            rows, _ = self._pass(state, bags, train=True, epoch=epoch)
            means = {} if rows is None else epoch_means(rows, self.metric_keys)[0]
            history.append(means or {"loss": 0.0, "acc": 0.0})
            self.logger.scalars("fusion", history[-1], epoch)
        return state, {"history": history}

    def predict(self, bags: BagData, state: FusionTrainState) -> np.ndarray:
        preds, masks = self._pass(state, bags, train=False)
        return np.zeros(0, np.int64) if preds is None else preds.cpu().numpy()[masks > 0]
