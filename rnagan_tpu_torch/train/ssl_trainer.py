"""Self-supervised (SimCLR) pre-training on histology tiles (port of
``rnagan_tpu/train/ssl_trainer.py``).

Two stochastic views per tile (random resized crop, horizontal and vertical
flips, brightness and contrast jitter) are made on the card; a ResNet
backbone and a 2-layer projection head map both through flax's BatchNorm
(one batch of 2N views); NT-Xent over the 2N views is the loss; AdamW
(``optax.adamw``, one K3 launch a step) updates every parameter. The
pretrained backbone goes to :class:`~rnagan_tpu_torch.train.ml_experiment.TileClassifierTrainer`
as a state_dict (:meth:`SimCLRTrainer.backbone_variables`).

Each view's seven draws (``scale``, ``off_x``, ``off_y``, ``flip_h``,
``flip_v``, ``brightness``, ``contrast``, the values ``jax.random`` draws in
``augment_views``) are Philox uniforms from the step's seeds
(``core/rng.py``, stream ``"ssl"``: stage 0 view A, stage 1 view B) or are
given as ``draws={"a": {...}, "b": {...}}``.

On a CUDA device with one rank the train step replays a captured CUDA graph
(``train/graph_steps.py``); ``fit`` enqueues an epoch in chunks of tables
that hold the batches (a host corpus: one step a chunk at ``SSLConfig()``,
256 x 224² float32 is 154 MB) or row indices into a corpus on the card.
:meth:`SimCLRTrainer.train_step_eager` is the plain version.

Under a mesh (``SSLConfig.mesh``; the data axis) each rank augments its rows
of the global batch with its slice of the global draws, and NT-Xent runs
over the **global** batch, as pjit makes it in the JAX package
(``rnagan_tpu/train/ssl_trainer.py:14``): the projections of both views are
gathered over the data group (the ``"sum"`` gather of
``parallel/collectives.py``: every rank's anchors see every negative, and
each rank's anchors are its share of the loss), BatchNorm reduces over the
group and the gradients are summed over it. SimCLR never pads: ``fit``
clamps the batch to the corpus, rounded down to a multiple of the data-axis
size.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rnagan_tpu_torch.core import rng
from rnagan_tpu_torch.core.config import MeshConfig
from rnagan_tpu_torch.core.metrics import MetricsLogger, epoch_means
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.data.batching import batch_indices
from rnagan_tpu_torch.models.resnet import ResNet, lecun_normal_, resnet50
from rnagan_tpu_torch.optim.adam import AdamW
from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.parallel.mesh import Mesh, local_rows, make_mesh, module_tensors, replicated
from rnagan_tpu_torch.train.graph_steps import GraphSteps
from rnagan_tpu_torch.train.step_graph import StepGraphs, chunk_steps
from rnagan_tpu_torch.train.ml_experiment import IMAGENET_MEAN, IMAGENET_STD, as_draw, flip_views, load_adamw

VIEW_DRAWS = ("scale", "off_x", "off_y", "flip_h", "flip_v", "brightness", "contrast")


@dataclass(frozen=True)
class SSLConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-6
    temperature: float = 0.5
    num_epochs: int = 100
    batch_size: int = 256
    image_size: int = 224
    crop_scale_min: float = 0.6
    projection_dim: int = 128
    projection_hidden: int = 512
    seed: int = 99
    mesh: MeshConfig = field(default_factory=MeshConfig)


class ProjectionHead(nn.Module):
    """Dense -> ReLU -> Dense (flax's ``Dense_0``, ``Dense_1``), float32."""

    def __init__(self, fan_in: int, hidden: int, out: int, gen: torch.Generator, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(fan_in, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, out, device=device)
        lecun_normal_(self.Dense_0, gen)
        lecun_normal_(self.Dense_1, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))


class SimCLRModel(nn.Module):
    """Headless backbone -> pooled features -> projection."""

    def __init__(self, backbone: ResNet, hidden: int, out: int, *, seed: int = 0, device=None):
        super().__init__()
        if backbone.fc is not None:
            raise ValueError("the SimCLR backbone has no fc head: build it with num_classes=0")
        self.backbone = backbone
        self.projection = ProjectionHead(backbone.out_features, hidden, out,
                                         torch.Generator().manual_seed(seed), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW views -> projections (N, out), float32."""
        return self.projection(self.backbone(x, extract=True))


@dataclass
class SSLTrainState:
    step: int
    model: SimCLRModel
    opt: AdamW


def nt_xent_loss(z: torch.Tensor, temperature: float, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """NT-Xent over 2N stacked views (first N = view A, last N = view B):
    ``(loss, contrastive accuracy)``. ``z @ z.T`` is a plain product
    (``torch.matmul``), as the JAX package leaves it to XLA.

    With a data ``group`` each rank holds its 2n rows (its n of view A, then
    its n of view B) of the global batch: both views are gathered over the
    group into the global [A; B], this rank's rows are the anchors against
    every row, and the results are this rank's shares of the global loss and
    accuracy (they sum over the group to the one-rank values)."""
    n = z.shape[0] // 2
    size = collectives.group_size(group)
    index = 0 if group is None else torch.distributed.get_rank(group)
    z = z / (torch.linalg.vector_norm(z, dim=1, keepdim=True) + 1e-8)
    views = [collectives.gather(v, group, dim=0, backward="sum") for v in (z[:n], z[n:])]
    everything = torch.cat(views)  # the global [A; B], 2N rows
    big_n = n * size
    mine = torch.cat([torch.arange(index * n, (index + 1) * n, device=z.device),
                      torch.arange(big_n + index * n, big_n + (index + 1) * n, device=z.device)])
    sim = (everything[mine] @ everything.T) / temperature
    sim = sim - 1e9 * torch.nn.functional.one_hot(mine, 2 * big_n).to(z.dtype)  # mask self-similarity
    pos = (mine + big_n) % (2 * big_n)
    logp = torch.log_softmax(sim, dim=1)
    loss = -logp.gather(1, pos[:, None]).sum() / (2 * big_n)
    acc = (sim.argmax(1) == pos).float().sum() / (2 * big_n)
    return loss, acc


def unit_linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32 as XLA computes it: ``i * (1 / (n - 1))``
    with the reciprocal rounded once, the last value 1."""
    out = torch.arange(n, dtype=torch.float32, device=device) * float(np.float32(1) / np.float32(n - 1))
    out[-1:].fill_(1.0)  # a fill, not an assignment: that copies a host scalar, which a graph capture refuses
    return out


def _random_resized_crop(images01: torch.Tensor, scale: torch.Tensor, off_x: torch.Tensor,
                         off_y: torch.Tensor) -> torch.Tensor:
    """Per-sample square crop of NHWC ``images01``, side ``scale`` (N,) of the
    tile at offsets ``off * (1 - scale)`` (``off_x``, ``off_y`` uniform in
    [0, 1), (N,)), resized back bilinearly on ``linspace`` grids: sample
    rows and columns clipped at ``h - 2`` / ``w - 2`` (the JAX package's
    ``_random_resized_crop``)."""
    n, h, w, c = images01.shape
    dev = images01.device
    scale = scale.to(dev, torch.float32).reshape(n, 1, 1)
    max_off = 1.0 - scale
    oy = off_y.to(dev, torch.float32).reshape(n, 1, 1) * max_off
    ox = off_x.to(dev, torch.float32).reshape(n, 1, 1) * max_off
    src_y = (oy + unit_linspace(h, dev)[None, :, None] * scale) * (h - 1)  # (n, h, 1)
    src_x = (ox + unit_linspace(w, dev)[None, None, :] * scale) * (w - 1)  # (n, 1, w)
    y0 = torch.clamp(torch.floor(src_y), 0, h - 2)
    x0 = torch.clamp(torch.floor(src_x), 0, w - 2)
    fy = (src_y - y0).to(images01.dtype)[..., None]  # (n, h, 1, 1)
    fx = (src_x - x0).to(images01.dtype)[:, 0, :, None][:, None]  # (n, 1, w, 1)
    yi = y0.long().reshape(n, h, 1, 1).expand(n, h, w, c)
    r0 = torch.take_along_dim(images01, yi, dim=1)
    r1 = torch.take_along_dim(images01, yi + 1, dim=1)
    rows = r0 * (1 - fy) + r1 * fy
    xi = x0.long().reshape(n, 1, w, 1).expand(n, h, w, c)
    c0 = torch.take_along_dim(rows, xi, dim=2)
    c1 = torch.take_along_dim(rows, xi + 1, dim=2)
    return c0 * (1 - fx) + c1 * fx


def draw_view(n: int, scale_min: float, seed, device) -> Dict[str, torch.Tensor]:
    """The seven draws of one view of ``n`` tiles from ``seed`` (an int or a
    one-element int tensor on ``device``): row i of Philox uniforms (7, n)
    (``core/rng.py::uniform``) is draw i of ``VIEW_DRAWS``, spread over its range."""
    rows = iter(rng.uniform(seed, (len(VIEW_DRAWS), n), device))
    u = lambda lo=0.0, hi=1.0: lo + (hi - lo) * next(rows)  # noqa: E731
    return {"scale": u(scale_min), "off_x": u(), "off_y": u(),
            "flip_h": u() < 0.5, "flip_v": u() < 0.5, "brightness": u(-0.2, 0.2), "contrast": u(0.8, 1.2)}


def given_views(draws: Dict[str, Dict[str, Any]]) -> torch.Tensor:
    """Given views ``{"a": {...}, "b": {...}}`` as one float32 (2, 7, N)
    tensor (``VIEW_DRAWS`` order; a flip as 0 or 1). Every draw is float32
    where the augmentation reads it, so the table holds them exactly."""
    return torch.stack([torch.stack([as_draw(draws[v][k]).reshape(-1).to(torch.float32) for k in VIEW_DRAWS])
                        for v in "ab"])


def augment_views(images01: torch.Tensor, draws: Dict[str, Any]) -> torch.Tensor:
    """One stochastic view of NHWC ``images01``: crop, flips, then brightness
    and contrast jitter about each view's mean, clipped to [0, 1]."""
    dev = images01.device
    d = {k: as_draw(draws[k]) for k in VIEW_DRAWS}
    x = _random_resized_crop(images01, d["scale"], d["off_x"], d["off_y"])
    x = flip_views(x, d["flip_h"].reshape(-1), d["flip_v"].reshape(-1))
    n = x.shape[0]
    brightness = d["brightness"].to(dev, torch.float32).reshape(n, 1, 1, 1)
    contrast = d["contrast"].to(dev, torch.float32).reshape(n, 1, 1, 1)
    mean = x.mean((1, 2, 3), keepdim=True)
    return torch.clamp((x - mean) * contrast + mean + brightness, 0.0, 1.0)


class SimCLRTrainer(GraphSteps):
    """SimCLR on one card, or data-parallel over ``mesh`` (default
    ``make_mesh(cfg.mesh, device)``); ``device="cuda"``, the default, raises
    without CUDA. ``backbone`` builds the headless ResNet (called with
    ``seed=`` and ``device=``; default ResNet50)."""

    stream, stages, draw_table, metric_keys = "ssl", 2, "views", ("loss", "contrastive_acc")

    def __init__(self, cfg: SSLConfig, *, backbone: Optional[Callable[..., ResNet]] = None,
                 logger: Optional[MetricsLogger] = None, device="cuda", mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh, device)
        self.device = self.mesh.device
        self.backbone = backbone or resnet50
        self.logger = logger or MetricsLogger()
        self.seeds = SeedStream(cfg.seed)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)
        self.step_graphs = StepGraphs(self.device, self.mesh)

    def init_state(self) -> SSLTrainState:
        bb = self.backbone(num_classes=0, seed=self.seeds.seed("init"), device=self.device)
        model = SimCLRModel(bb, self.cfg.projection_hidden, self.cfg.projection_dim,
                            seed=self.seeds.seed("init", stage=1), device=self.device)
        replicated(module_tensors(model), self.mesh)
        return SSLTrainState(0, model, AdamW(list(model.parameters()), self.cfg.lr, self.cfg.weight_decay))

    def state_from_jax(self, tree) -> SSLTrainState:
        """A JAX ``SSLTrainState`` (numpy or JAX leaves) on this trainer's device."""
        from rnagan_tpu_torch import convert

        state = self.init_state()
        state.model.load_state_dict(convert.resnet_state_dict_from_jax(
            state.model, {"params": tree.params, "batch_stats": tree.batch_stats}))
        load_adamw(state.opt, [n for n, _ in state.model.named_parameters()], tree.opt_state)
        state.step = int(np.asarray(tree.step))
        return state

    def _step(self, state: SSLTrainState, inputs, given: Optional[torch.Tensor], seeds,
              corr) -> Dict[str, torch.Tensor]:
        """One train step in place on ``inputs`` = (NHWC [0, 1] images,),
        this rank's rows; ``given`` the global batch's views (float32 (2, 7,
        N), :func:`given_views`) or None to draw view A from ``seeds[0]`` and
        view B from ``seeds[1]``; ``corr`` AdamW's device corrections or None.
        ``state.step`` does not advance."""
        (x,) = inputs
        mesh = self.mesh
        n = len(x) * mesh.data
        if given is None:
            views = [draw_view(n, self.cfg.crop_scale_min, seeds[i], self.device) for i in range(2)]
        else:
            views = [dict(zip(VIEW_DRAWS, given.to(self.device)[i])) for i in range(2)]
        rows = local_rows(n, mesh)
        both = torch.cat([augment_views(x, {k: v[rows] for k, v in view.items()}) for view in views])
        both = (both - self._mean) / self._std
        model = state.model.train()
        loss, acc = nt_xent_loss(model(both.permute(0, 3, 1, 2)).float(), self.cfg.temperature, mesh.data_group)
        params = list(model.parameters())
        grads = collectives.all_reduce_grads(torch.autograd.grad(loss, params), mesh.data_group)
        state.opt.step(params, grads, corr=corr)
        return collectives.reduce_metrics({"loss": loss.detach(), "contrastive_acc": acc.detach()},
                                          mesh.data_group)

    def train_step(self, state: SSLTrainState, images01,
                   draws: Optional[Dict[str, Dict[str, Any]]] = None) -> Tuple[SSLTrainState, Dict[str, torch.Tensor]]:
        """One step on NHWC ``images01`` in [0, 1] (under a mesh, this rank's
        rows of the global batch): views A and B, normalized as the downstream
        classifier normalizes, through the model in train mode, NT-Xent,
        AdamW. ``draws`` may give the global batch's view draws. Where
        :meth:`captures`, a replay of the step's graph; else
        :meth:`train_step_eager`."""
        if not self.captures():
            return self.train_step_eager(state, images01, draws)
        x = torch.as_tensor(images01, dtype=torch.float32)
        tables = {"images": x[None]}
        if draws is not None:
            tables["views"] = given_views(draws)[None]
        vec = self.run_steps(state, tables, self._host_prepare(len(x)), 1)[0]
        return state, dict(zip(self.metric_keys, vec.unbind(0)))

    def train_step_eager(self, state: SSLTrainState, images01, draws: Optional[Dict[str, Dict[str, Any]]] = None
                         ) -> Tuple[SSLTrainState, Dict[str, torch.Tensor]]:
        """:meth:`train_step` op by op from the host (host-int seeds, host-float
        corrections): its plain version, and the step of the CPU and of a
        mesh of several ranks."""
        x = torch.as_tensor(images01).to(self.device, torch.float32)
        given = None if draws is None else given_views(draws)
        with collectives.active(self.mesh):
            metrics = self._step(state, (x,), given, self._step_seeds(state.step), None)
        state.step += 1
        return state, metrics

    def _host_prepare(self, rows: int):
        """Steps whose ``images`` table holds the global batch: this rank's rows."""
        def build():
            mesh, dev = self.mesh, self.device
            return lambda step_rows: (step_rows["images"].to(dev)[local_rows(rows, mesh)],)
        return self.step_graphs.prepared(("host", rows), build)

    def _resident_prepare(self, images: torch.Tensor, rows: int):
        """Steps whose ``idx`` table holds row indices into a float NHWC
        corpus on the card: this rank's rows."""
        def build():
            mesh, dev = self.mesh, self.device
            return lambda step_rows: (images.index_select(0, step_rows["idx"].to(dev)[local_rows(rows, mesh)]),)
        return self.step_graphs.prepared(("idx", images.data_ptr(), tuple(images.shape), images.dtype, rows), build)

    def fit(self, images01, *, num_epochs: Optional[int] = None,
            state: Optional[SSLTrainState] = None) -> Tuple[SSLTrainState, Dict[str, Any]]:
        """Epochs of full batches: NT-Xent takes every row as a real negative,
        so the batch is clamped to the corpus (rounded down to a multiple of
        the data-axis size) and the remainder dropped. ``images01`` is a
        host array, or a tensor on this trainer's device (the tables then
        hold row indices into it); an epoch's steps are enqueued in chunks
        and its metrics come off the card in one copy."""
        cfg, mesh = self.cfg, self.mesh
        state = state if state is not None else self.init_state()
        n = len(images01)
        bs = min(cfg.batch_size, n) // mesh.data * mesh.data
        if bs == 0:
            raise ValueError(f"a corpus of {n} images cannot fill one batch over {mesh.data} data ranks")
        resident = isinstance(images01, torch.Tensor) and images01.device == self.device
        if resident:
            prepare, step_bytes = self._resident_prepare(images01, bs), bs * 8
        else:
            host = np.asarray(images01.cpu() if isinstance(images01, torch.Tensor) else images01, np.float32)
            prepare, step_bytes = self._host_prepare(bs), bs * host[0].size * 4
        history = []
        for epoch in range(num_epochs or cfg.num_epochs):
            idx = np.stack([i for i, _ in batch_indices(n, bs, shuffle=True, seed=cfg.seed, epoch=epoch,
                                                          drop_remainder=True)])
            steps = len(idx)
            cap = chunk_steps(steps, step_bytes)
            rows = []
            for s in range(0, steps, cap):
                k = min(cap, steps - s)
                chunk = idx[s:s + k]
                tables = {"idx": torch.from_numpy(chunk)} if resident else {"images": torch.from_numpy(host[chunk])}
                rows.append(self.run_steps(state, tables, prepare, k, capacity=cap))
            history.append(epoch_means(torch.cat(rows), self.metric_keys)[0])
            self.logger.scalars("ssl", history[-1], epoch)
        return state, {"history": history}

    @staticmethod
    def backbone_variables(state: SSLTrainState) -> Dict[str, torch.Tensor]:
        """The pretrained backbone's state_dict (copies), for
        ``TileClassifierTrainer(backbone_variables=...)``."""
        return copy.deepcopy(state.model.backbone.state_dict())
