"""GAN trainer (port of ``rnagan_tpu/train/gan_trainer.py``).

One :meth:`GANTrainer.train_step` is the JAX package's ``_train_step_impl``
(``:207-386``), stage by stage, on one card:

* uint8 NHWC tiles are normalized on the device (``x/127.5 - 1``);
* ``wgan`` clamps D's parameters at the start of the step;
* **D stage**: G forward in train mode (G's BatchNorm statistics update); D
  on the real tiles, then on the fakes, each updating D's statistics; the
  critic loss; with the fused GP, the per-sample penalty on
  ``eps*real + (1-eps)*fake`` (eps of shape (N,1,1,1)), its D forward in
  train mode with its statistics update discarded; one Adam step of D;
* **GP stage** (``compat_reference_gp``): a fresh G forward, one scalar
  eps, the global-norm penalty and a second Adam step of D. The penalty's
  forward updates D's statistics with the pre-step weights, the update the
  JAX package replays (``:333``);
* **G stage**: G forward from the post-D-stage statistics, D with its
  updated weights in train mode (both keep their statistics), one Adam step
  of G. With ``n_critic > 1`` only every ``n_critic``-th step runs it;
* the EMA of G's weights, on steps that updated G.

G and D come from the model registry: ``dcgan``, ``dcgan_up`` (the
resize-conv generator with the plain discriminator), ``condgan``, ``sagan``,
``biggan`` and ``biggan_pub`` (the published BigGAN). ``condgan``'s and
``biggan_pub``'s batch ``labels``, and ``biggan``'s when ``num_classes`` > 0,
go into G and D at every stage, the GP's included.
SAGAN and the BigGANs keep spectral-norm state ``(u, sigma)`` beside the
BatchNorm statistics in ``g_stats``/``d_stats`` and thread it the same way:
D's real pass gives ``s1``, its fake pass ``s2``, the GP reads ``s2`` and its
update is dropped.

Every Adam step is one launch of the K3 kernel (``optim/adam.py``); every
stage's noise is one launch of the K1 kernel (``kernels/infusion.py``), its
uniforms drawn from a seed of ``core/rng.py`` or given in ``draws``. The
frozen VAE encodes z_mean once a step: JAX encodes it per stage, with the
same result. ``fused_critic_batch=True`` is accepted and runs this two-pass
step: in the JAX package it is a TPU schedule of the same function, and its
test shows the two agree (``tests/test_gan_trainer.py:337``). For ``sagan``
and ``biggan`` it raises the JAX package's ValueError (its closed-form
statistics blend would corrupt the power-iteration state).

Under a mesh (``parallel/mesh.py``; ``GANConfig.mesh``, every rank of the
process group on the data axis by default) the step is data-parallel, with
the numbers of the one-rank step on the global batch up to the order of
reductions (the JAX package's sharding claim,
``tests/test_sharding_equivalence.py:1-5``):

* ``train_step`` takes this rank's rows of the global batch (``fit`` slices
  them with ``shard_batch``) and every draw is made for the global batch and
  sliced: K1's Philox rows from this rank's first global row (K1's group
  mode, which standardizes over the global batch), the GP's eps and the
  normal noise from generators of the global shape, ``draws``' arrays of
  the global batch;
* BatchNorm reduces its statistics over the data group; each rank's loss is
  its share of the global loss (``parallel/collectives.py``), the gradients
  are summed over the data group and every rank runs one K3 launch per model
  on the same sums, so the replicas stay bit-equal;
* the metrics are the global ones on every rank; only rank 0 writes sample
  grids and bundles; every rank reads them.

One program a step (the JAX trainer's ``jax.jit(_train_step_impl,
donate_argnums=(0,))``, ``:148``): on a CUDA device with one rank, the steps
of every arch (every loss, ``compat_reference_gp``, ``n_critic``, the EMA,
the projection critic, ``clip``, BigGAN's remat) replay a CUDA graph of the
step (``train/step_graph.py``), captured at the first step of a state.
SAGAN's and BigGAN's spectral-norm pairs ``(u, sigma)`` are ``copy_``'d into
the state's own tensors with BatchNorm's statistics; BigGAN's checkpointed
blocks keep ``preserve_rng_state=False`` (reading a CUDA generator's state
during a capture raises, and the blocks draw nothing).
The step's seeds (``SeedStream.table``) and Adam bias corrections are rows
of device tables that K1 and K3 read on the device; the GP's eps and the
normal noise come from Philox streams keyed by those seeds
(``core/rng.py``). :meth:`GANTrainer.train_step_eager`, the step op by op
from the host with host-int seeds, is its plain version: it runs on the CPU
and under a mesh of more than one rank (gloo's collectives cannot be
captured), and draws the same bits. A failed capture
raises; nothing falls back to the eager step.

Unlike the JAX step, which is pure, ``train_step`` updates the state in place
and returns it. ``fit`` writes a sample grid PNG and ``gan_last.model`` per
epoch through an ``AsyncSaver`` (``core/checkpoint.py``: the state copied on
the device, written by a worker thread while the next epoch trains) and
waits for it before returning, as the JAX trainer does (``:601``).
"""

from __future__ import annotations

import copy
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from rnagan_tpu_torch import convert
from rnagan_tpu_torch.core import profiling, rng
from rnagan_tpu_torch.core.checkpoint import AsyncSaver, load_bundle, on_writer, to_host
from rnagan_tpu_torch.core.config import GANConfig, VAEModelConfig
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.losses import gan as gan_losses
from rnagan_tpu_torch.losses.rna_infusion import (encode_z_mean, infused_noise,
                                                  infused_noise_population, z_population_stats)
from rnagan_tpu_torch.models.batchnorm import Stats
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.models.dcgan import make_discriminator, make_generator
from rnagan_tpu_torch.optim.adam import Adam, bias_corrections
from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.parallel.mesh import Mesh, local_rows, make_mesh, module_tensors, replicated, shard_batch
from rnagan_tpu_torch.train.step_graph import StepGraph
from rnagan_tpu_torch.utils.images import save_image_grid

log = logging.getLogger(__name__)

#: the stages that draw noise, and their index in a step's seeds
_STAGES = {"d": 0, "gp": 1, "g": 2, "eps": 3}
#: a step's metrics, in the order of its vectors (``gp`` for the wgan family only)
METRICS = ("d_loss", "dx", "dgz", "gp", "g_loss")
#: the archs whose one-rank CUDA step is a captured graph
CAPTURED_ARCHS = ("dcgan", "dcgan_up", "condgan", "sagan", "biggan", "biggan_pub")
#: the step graphs a trainer keeps (a graph pins its state and its memory pool)
MAX_GRAPHS = 4
#: a step's given draws, as ``draws`` keys and table names
DRAW_KEYS = ("u_d", "u_gp", "u_g", "eps")


def given_batch(rows: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch of a step whose tables hold it: its ``image``,
    ``rna_data`` and ``labels`` rows (``GANTrainer.run_steps``' ``prepare``
    for given batches)."""
    return {k: rows[k] for k in ("image", "rna_data", "labels") if k in rows}


def _draws_of(rows: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    return {k: rows[k] for k in DRAW_KEYS if k in rows} or None


@dataclass
class GANTrainState:
    """The training state. ``generator``/``discriminator`` hold the live
    parameters; ``g_stats``/``d_stats`` the nets' state pairs in module order
    (``(mean, var)`` per BatchNorm, ``(u, sigma)`` per spectral norm);
    ``g_ema`` the EMA of G's parameters in ``parameters()`` order, or None
    when it is off."""

    step: int
    generator: torch.nn.Module
    discriminator: torch.nn.Module
    g_stats: Stats
    d_stats: Stats
    g_opt: Adam
    d_opt: Adam
    g_ema: Optional[List[torch.Tensor]] = None


def load_frozen_vae(path: str, vae_cfg: VAEModelConfig) -> Dict[str, torch.Tensor]:
    """The frozen betaVAE of the wganvae loss family as a state_dict, routed by
    extension as the JAX loader routes it (``rnagan_tpu/train/gan_trainer.py:79-90``):
    a ``.pt``/``.pth`` is a reference or JAX-exported state_dict; any other
    file is a JAX bundle (``model_best.ckpt`` of its ``VAETrainer.fit``) whose
    ``params`` and ``batch_stats`` are moved by ``betavae_state_dict_from_jax``."""
    if path.endswith((".pt", ".pth")):
        return convert.load_betavae_state_dict(path)
    trees, _ = load_bundle(path)
    return convert.betavae_state_dict_from_jax(
        vae_cfg, {"params": trees["params"], "batch_stats": trees["batch_stats"]})



def _copy_stats(stats: Stats) -> Stats:
    return [(m.detach().clone(), v.detach().clone()) for m, v in stats]


def _map_leaves(fn, tree):
    """``fn`` over the leaves of a tree of dicts."""
    return {k: _map_leaves(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


class GANTrainer:
    """RNA-GAN training on one card, or data-parallel over the ranks of a
    ``mesh`` (default ``make_mesh(cfg.mesh, device)``: the one-card mesh
    outside a process group). ``device="cuda"``, the default, raises without
    CUDA; the tests pass ``"cpu"``.

    ``vae_state_dict`` is the frozen betaVAE of the wganvae loss family (or
    ``cfg.vae_checkpoint`` names its ``.pt`` or JAX bundle)."""

    def __init__(self, cfg: GANConfig, vae_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", image_dir: Optional[str] = None, model_dir: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        if cfg.loss_type not in gan_losses.DISCRIMINATOR_LOSSES:
            raise ValueError(f"unknown loss_type {cfg.loss_type}")
        if cfg.model.critic == "projection" and cfg.loss_type != "wganvae":
            raise ValueError("critic='projection' conditions on the frozen VAE embedding; "
                             "it requires loss_type=wganvae")
        if cfg.adam_mu_dtype not in (None, "float32", "bfloat16"):
            raise ValueError("adam_mu_dtype must be None, 'float32' or 'bfloat16'")
        if cfg.fused_critic_batch and cfg.model.arch in ("sagan", "biggan", "biggan_pub"):
            raise ValueError("fused_critic_batch is unsupported for spectral-norm architectures "
                             "(sagan/biggan/biggan_pub)")
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh, device)
        if self.mesh.model != 1:
            raise ValueError("the GAN trainer splits the batch only: MeshConfig.model must be 1")
        self.device = self.mesh.device
        self.image_dir = image_dir
        self.model_dir = model_dir
        self.seeds = SeedStream(cfg.seed)
        self.vae: Optional[BetaVAE] = None
        if cfg.loss_type == "wganvae":
            if vae_state_dict is None:
                if not cfg.vae_checkpoint:
                    raise ValueError("loss_type=wganvae requires vae_state_dict or cfg.vae_checkpoint")
                vae_state_dict = load_frozen_vae(cfg.vae_checkpoint, cfg.vae)
            self.vae = BetaVAE(cfg.vae, device=self.device)
            self.vae.load_state_dict(vae_state_dict)
            self.vae.eval().requires_grad_(False)
        #: (mean, std) of z_mean over the training population, for generation
        #: that keeps the patient signal; saved into every checkpoint
        self.z_pop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._mu_dtype = torch.bfloat16 if cfg.adam_mu_dtype == "bfloat16" else torch.float32
        self._graphs: Dict[Any, StepGraph] = {}
        self._saver = AsyncSaver()

    # ------------------------------------------------------------------ state
    def init_state(self) -> GANTrainState:
        cfg, dev = self.cfg, self.device
        g = make_generator(cfg.model, seed=self.seeds.seed("init", stage=0), device=dev)
        d = make_discriminator(cfg.model, seed=self.seeds.seed("init", stage=1), device=dev)
        betas = dict(b1=cfg.adam_b1, b2=cfg.adam_b2, mu_dtype=self._mu_dtype)
        replicated(module_tensors(g) + module_tensors(d), self.mesh)
        return GANTrainState(
            step=0, generator=g, discriminator=d,
            g_stats=_copy_stats(g.bn_stats()), d_stats=_copy_stats(d.bn_stats()),
            g_opt=Adam(list(g.parameters()), lr=cfg.g_lr, **betas),
            d_opt=Adam(list(d.parameters()), lr=cfg.d_lr, **betas),
            g_ema=([p.detach().clone() for p in g.parameters()]
                   if cfg.g_ema_decay is not None else None))

    # ------------------------------------------------------------------ noise
    def _noise(self, seeds, stage: str, n: int, z_mean, draws) -> torch.Tensor:
        """A stage's noise prior for this rank's ``n`` rows: VAE-infused through
        K1 for wganvae (reference ``wgan_loss.py:97-106``), standard normal
        otherwise (``core/rng.py::normal``). ``draws["u_<stage>"]`` holds the
        global batch's uniforms (or normals) when given; else the stage's
        seed ``seeds[stage index]`` (an int, or a device scalar) draws them."""
        mesh, rows = self.mesh, local_rows(n * self.mesh.data, self.mesh)
        seed = seeds[_STAGES[stage]]
        given = None if draws is None else draws["u_" + stage][rows]
        if self.cfg.loss_type == "wganvae":
            kw = dict(noise_range=self.cfg.noise_range, group=mesh.data_group, row0=rows.start)
            if given is not None:
                return infused_noise(z_mean, n, u=given.contiguous(), **kw)
            return infused_noise(z_mean, n, seed=seed, **kw)
        if given is not None:
            return given
        return rng.normal(seed, (n * mesh.data, self.cfg.model.encoding_dims), self.device)[rows]

    def _eps(self, seeds, n: Optional[int], draws) -> torch.Tensor:
        """The GP's interpolation weights: (n, 1, 1, 1) for this rank's rows of
        the global batch's draw, or one scalar (``n`` None)."""
        rows = None if n is None else local_rows(n * self.mesh.data, self.mesh)
        given = None if draws is None else draws["eps"]
        if given is None:
            shape = () if n is None else (n * self.mesh.data, 1, 1, 1)
            given = rng.uniform(seeds[_STAGES["eps"]], shape, self.device)
        return given.reshape(()) if n is None else given.reshape(-1, 1, 1, 1)[rows]

    def _conditional(self) -> bool:
        m = self.cfg.model
        return m.arch in ("condgan", "biggan_pub") or (m.arch == "biggan" and m.num_classes > 0)

    def _host_batch(self, batch, draws) -> Dict[str, torch.Tensor]:
        """A step's inputs as tensors where the caller holds them: the batch's
        ``image``, ``rna_data`` (wganvae) and ``labels`` (``condgan``,
        ``biggan_pub``, and ``biggan`` with ``num_classes`` > 0, JAX's ``_labels``,
        ``gan_trainer.py:184-189``), and the draws when given."""
        out = {"image": torch.as_tensor(batch["image"])}
        if self.cfg.loss_type == "wganvae":
            out["rna_data"] = torch.as_tensor(batch["rna_data"], dtype=torch.float32)
        if self._conditional():
            if batch.get("labels") is None:
                raise ValueError(f"arch={self.cfg.model.arch!r} with classes trains on batches with 'labels'")
            out["labels"] = torch.as_tensor(batch["labels"]).long()
        for key in (draws or {}):
            out[key] = torch.as_tensor(draws[key], dtype=torch.float32)
        return out

    def metric_keys(self) -> Tuple[str, ...]:
        """The step's metrics, in the order of :meth:`run_steps`' vectors."""
        wgan_family = self.cfg.loss_type in ("wgan", "wganvae")
        return tuple(k for k in METRICS if k != "gp" or wgan_family)

    def _runs_g(self, step: int) -> bool:
        return self.cfg.n_critic <= 1 or step % self.cfg.n_critic == self.cfg.n_critic - 1

    def captures(self) -> bool:
        """Whether :meth:`train_step` runs as a captured CUDA graph: on a
        CUDA device with one rank (every arch of ``CAPTURED_ARCHS``)."""
        return (self.device.type == "cuda" and self.mesh.world == 1
                and self.cfg.model.arch in CAPTURED_ARCHS)

    # ------------------------------------------------------------- train step
    def train_step(self, state: GANTrainState, batch: Dict[str, Any],
                   draws: Optional[Dict[str, Any]] = None):
        """One step on ``batch`` (``"image"`` (N, H, W, C) uint8 or float in
        [-1, 1]; ``"rna_data"`` (N, F) for wganvae; ``"labels"`` (N,) int for
        condgan, into G and D at every stage, the GP's included): under a
        mesh, this rank's N rows of the global batch. ``draws`` optionally
        gives the global batch's stage noise ``u_d``, ``u_gp``, ``u_g``
        (uniforms in [-noise_range, noise_range] for wganvae, else normals)
        and ``eps``. Returns ``(state, metrics)``, the state updated in place;
        the metrics (``d_loss``, ``dx``, ``dgz``, ``gp``, ``g_loss``, of the
        global batch) are 0-dim float tensors.

        On a CUDA device with one rank, every arch (every loss and option)
        runs as a captured CUDA graph (:meth:`run_steps`); a mesh of several
        ranks and the CPU run :meth:`train_step_eager`. Both draw the same
        bits."""
        with profiling.span("gan.train_step"):
            if not self.captures():
                return self.train_step_eager(state, batch, draws)
            with profiling.span("gan.plan"):
                rows = {k: t[None] for k, t in self._host_batch(batch, draws).items()}
            vec = self.run_steps(state, rows, given_batch, 1)
            return state, dict(zip(self.metric_keys(), vec.unbind(0)))

    def train_step_eager(self, state: GANTrainState, batch: Dict[str, Any],
                         draws: Optional[Dict[str, Any]] = None):
        """:meth:`train_step` op by op from the host: the step's plain
        version, and the step of the CPU and of meshes of several ranks.
        Its seeds are host ints (K1's group mode takes them so), the graph's
        device scalars of the same values."""
        dev = self.device
        with profiling.span("gan.plan"):
            given = {k: t.to(dev) for k, t in self._host_batch(batch, draws).items()}
            step = state.step
            seeds = [self.seeds.seed("train", step, i) for i in range(len(_STAGES))]
        with collectives.active(self.mesh):
            metrics = self._step(state, given_batch(given), _draws_of(given), seeds, None, self._runs_g(step))
        state.step += 1
        return state, collectives.reduce_metrics(metrics, self.mesh.data_group)

    def run_steps(self, state: GANTrainState, tables: Dict[str, torch.Tensor],
                  prepare: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]], steps: int,
                  sums: Optional[torch.Tensor] = None, capacity: Optional[int] = None) -> torch.Tensor:
        """``steps`` training steps; step i takes row i of every table
        (``tables[name][i]``: the batch's tensors, or what ``prepare``
        renders it from; ``u_d``/``u_gp``/``u_g``/``eps`` rows are given
        draws). ``prepare(rows)`` returns the step's batch dict from its rows
        with device ops only (:func:`given_batch` passes the batch through).
        Each step's metrics vector (:meth:`metric_keys` order) is added to
        ``sums`` (a device tensor) when given; returns the last one.

        Where :meth:`captures`, the steps replay a CUDA graph of the step
        (``train/step_graph.py``), one per G-stage choice, built at the first
        use for this state, these table shapes, ``prepare`` and ``capacity``
        rows (default ``steps``): the host fills the tables (with the
        steps' seeds and Adam bias corrections) once and enqueues ``steps``
        replays with no synchronization. Otherwise each step runs
        :meth:`train_step_eager` on ``prepare``'s batch."""
        if not self.captures():
            vec = None
            for i in range(steps):
                given = {k: t[i] for k, t in tables.items()}
                batch = prepare(given)
                _, metrics = self.train_step_eager(state, batch, _draws_of(given))
                vec = torch.stack([metrics[k].float().reshape(()) for k in self.metric_keys()])
                if sums is not None:
                    sums.add_(vec)
            return vec
        with profiling.span("gan.plan"):
            runs, seeds, corr, after = self._plan(state, steps)
        graph = self._graph(state, {**tables, "seeds": seeds, "corr": corr}, prepare, capacity or steps)
        graph.load({**tables, "seeds": seeds, "corr": corr}, steps)
        for run_g in runs:
            vec = graph.replay(run_g)
            if sums is not None:
                sums.add_(vec)
        state.step, state.d_opt.count, state.g_opt.count = after
        return vec.clone()

    def _plan(self, state: GANTrainState, steps: int):
        """The host's part of ``steps`` steps from ``state``: whether each
        runs the G stage, the seeds table (steps, stages), the Adam bias
        corrections (steps, 3, 2) of D's step, D's second step (the GP
        stage's) and G's step, and (step, D count, G count) after them."""
        wgan_family = self.cfg.loss_type in ("wgan", "wganvae")
        d_steps = 2 if wgan_family and self.cfg.compat_reference_gp else 1
        step, dc, gc = state.step, state.d_opt.count, state.g_opt.count
        d, g = state.d_opt, state.g_opt
        runs, corr = [], []
        for i in range(steps):
            runs.append(self._runs_g(step + i))
            corr.append([bias_corrections(dc + 1, d.b1, d.b2), bias_corrections(dc + 2, d.b1, d.b2),
                         bias_corrections(gc + 1, g.b1, g.b2)])
            dc, gc = dc + d_steps, gc + int(runs[-1])
        seeds = self.seeds.table("train", step, steps, len(_STAGES))
        return runs, seeds, torch.tensor(corr, dtype=torch.float32), (step + steps, dc, gc)

    @staticmethod
    def _state_tensors(state: GANTrainState) -> List[torch.Tensor]:
        """Every tensor a step reads and writes in place."""
        return [*state.generator.parameters(), *state.discriminator.parameters(),
                *(t for pair in state.g_stats + state.d_stats for t in pair),
                *state.g_opt.mu, *state.g_opt.nu, *state.d_opt.mu, *state.d_opt.nu, *(state.g_ema or [])]

    def _graph(self, state: GANTrainState, tables, prepare, capacity: int) -> StepGraph:
        """The state's graphs for these tables, ``prepare`` and capacity
        (built here at the first use; the last ``MAX_GRAPHS`` are kept). The
        key holds the nets' configs too: replacing ``net.cfg`` (BigGAN's
        ``remat``) changes the program."""
        live = self._state_tensors(state)
        flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                 torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        key = (id(state.generator), id(state.discriminator), state.generator.cfg, state.discriminator.cfg,
               tuple(t.data_ptr() for t in live), id(prepare),
               tuple((k, tuple(t.shape[1:]), t.dtype) for k, t in sorted(tables.items())), capacity, flags)
        graph = self._graphs.pop(key, None)
        if graph is None:
            # the body holds state and prepare: the ids in the key stay theirs while the graph lives
            graph = StepGraph(self._body(state, prepare), tables, capacity, live, self.device)
            while len(self._graphs) >= MAX_GRAPHS:
                self._graphs.pop(next(iter(self._graphs)))
        self._graphs[key] = graph
        return graph

    def _body(self, state: GANTrainState, prepare) -> Callable[[bool, Dict[str, torch.Tensor]], torch.Tensor]:
        """What a graph captures: ``body(run_g, rows)`` runs one step from a
        row of every table (the seeds and bias corrections as device
        tensors) and returns its metrics vector."""
        keys = self.metric_keys()

        def body(run_g, rows):
            with collectives.active(self.mesh):
                metrics = self._step(state, prepare(rows), _draws_of(rows), rows["seeds"], rows["corr"], run_g)
            return torch.stack([metrics[k].float().reshape(()) for k in keys])
        return body

    def _step(self, state: GANTrainState, batch: Dict[str, torch.Tensor], draws, seeds, corr, run_g: bool):
        """The step's device work (``_train_step_impl``): ``batch`` and
        ``draws`` on the device, ``seeds`` the stages' seeds (host ints, or an
        int64 (stages,) device tensor), ``corr`` None (Adam computes its bias
        corrections from its counts) or a float32 (3, 2) device tensor of
        them. The state's tensors are updated in place (statistics by
        ``copy_``) and the Adam counts advance; ``state.step`` does not.
        Each stage begins with its device mark (``core/profiling.py``)."""
        cfg, dev, group = self.cfg, self.device, self.mesh.data_group
        mark = lambda stage: profiling.mark(stage, dev)  # noqa: E731
        mark("gan_ingest")
        G, D = state.generator, state.discriminator
        real = batch["image"]
        if real.dtype == torch.uint8:
            real = real.float() / 127.5 - 1.0
        real = real.float().permute(0, 3, 1, 2)  # NHWC: a channels-last view
        if not getattr(D, "channels_last", False):
            real = real.contiguous()
        n = real.shape[0]
        g_params, d_params = list(G.parameters()), list(D.parameters())
        g_stats, d_stats = state.g_stats, state.d_stats
        z_mean = None
        if cfg.loss_type == "wganvae":
            mark("gan_encode")
            with torch.no_grad():
                z_mean = encode_z_mean(self.vae, batch["rna_data"])
        cond = z_mean if cfg.model.critic == "projection" else None
        labels = batch.get("labels")
        wgan_family = cfg.loss_type in ("wgan", "wganvae")
        fused_gp = wgan_family and not cfg.compat_reference_gp
        adam_corr = (lambda i: None) if corr is None else (lambda i: corr[i])  # noqa: E731
        metrics: Dict[str, torch.Tensor] = {}

        if cfg.loss_type == "wgan" and cfg.clip is not None:
            gan_losses.clip_params(d_params, *cfg.clip)

        # ---------------- D stage (critic loss, fused with the GP by default)
        mark("gan_noise")
        noise = self._noise(seeds, "d", n, z_mean, draws)
        mark("gan_g_forward")
        with torch.no_grad():
            fake, g_stats = G.forward_stats(noise, g_stats, True, labels=labels)
        mark("gan_d_forward")
        dx, s1 = D(real, d_stats, True, cond, labels)
        dgz, s2 = D(fake, s1, True, cond, labels)
        loss = self._share(gan_losses.DISCRIMINATOR_LOSSES[cfg.loss_type](dx, dgz))
        metrics.update(d_loss=loss.detach(), dx=self._share(dx.detach().mean()),
                       dgz=self._share(dgz.detach().mean()))
        if fused_gp:
            mark("gan_gp")
            eps = self._eps(seeds, n, draws)
            interp = eps * real + (1.0 - eps) * fake
            gp = gan_losses.gradient_penalty(lambda x: D(x, s2, True, cond, labels)[0], interp,
                                             per_sample=True, group=group)
            metrics["gp"] = gp.detach()
            loss = loss + cfg.gp_lambda * gp
        mark("gan_d_backward")
        grads = collectives.all_reduce_grads(torch.autograd.grad(loss, d_params), group)
        mark("gan_d_adam")
        state.d_opt.step(d_params, grads, corr=adam_corr(0))
        d_stats = s2

        # ---------------- GP stage (a second D step: the reference's dynamics)
        if wgan_family and not fused_gp:
            mark("gan_noise")
            noise = self._noise(seeds, "gp", n, z_mean, draws)
            mark("gan_g_forward")
            with torch.no_grad():
                fake_gp, g_stats = G.forward_stats(noise, g_stats, True, labels=labels)
            mark("gan_gp")
            eps = self._eps(seeds, None, draws)
            interp = eps * real + (1.0 - eps) * fake_gp
            kept: List[Stats] = []

            def critic(x):
                out, s = D(x, d_stats, True, cond, labels)
                kept.append(s)
                return out

            gp = gan_losses.gradient_penalty(critic, interp, per_sample=False, group=group)
            mark("gan_d_backward")
            grads = collectives.all_reduce_grads(torch.autograd.grad(cfg.gp_lambda * gp, d_params), group)
            d_stats = kept[0]
            mark("gan_d_adam")
            state.d_opt.step(d_params, grads, corr=adam_corr(1))
            metrics["gp"] = gp.detach()

        # ---------------- G stage
        if run_g:
            mark("gan_noise")
            noise = self._noise(seeds, "g", n, z_mean, draws)
            mark("gan_g_step")
            fake, gs = G.forward_stats(noise, g_stats, True, labels=labels)
            dgz, ds = D(fake, d_stats, True, cond, labels)
            g_loss = self._share(gan_losses.GENERATOR_LOSSES[cfg.loss_type](dgz))
            grads = collectives.all_reduce_grads(torch.autograd.grad(g_loss, g_params), group)
            mark("gan_g_adam")
            state.g_opt.step(g_params, grads, corr=adam_corr(2))
            g_stats, d_stats = gs, ds
            metrics["g_loss"] = g_loss.detach().float()
            if state.g_ema is not None:
                decay = cfg.g_ema_decay
                with torch.no_grad():
                    for e, p in zip(state.g_ema, g_params):
                        e.copy_(e * decay + (1.0 - decay) * p)
        else:
            metrics["g_loss"] = torch.zeros((), device=dev)
        mark("gan_stats")
        with torch.no_grad():  # into the state's own tensors: a captured step writes where it reads
            for old, new in ((state.g_stats, g_stats), (state.d_stats, d_stats)):
                for pair, new_pair in zip(old, new, strict=True):
                    for t, v in zip(pair, new_pair):
                        t.copy_(v)
        mark("end")
        return metrics

    def _share(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of a mean over the global batch (the convention
        of ``parallel/collectives.py``)."""
        return x if self.mesh.data_group is None else x / self.mesh.data

    # -------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample(self, state: GANTrainState, n: int, gene=None, z_pop=None,
               use_ema: Optional[bool] = None, seed: int = 0, labels=None) -> torch.Tensor:
        """``n`` images (n, H, W, C) float32 in [-1, 1], generated in eval mode.
        With ``gene`` (wganvae) the noise is the infusion prior of the
        patients' z_mean ((B, F) rows, B = n or 1), standardized over the batch,
        or with ``z_pop = (mean, std)`` by population statistics; both through
        K1 with Philox ``seed``. Without ``gene`` it is standard normal.
        ``condgan``, ``biggan_pub`` and ``biggan`` with ``num_classes`` > 0 draw the labels
        uniformly from their ``num_classes`` with a generator of ``seed``, or
        take ``labels`` (n,) when given.
        ``use_ema=None`` picks the EMA generator whenever the state has one."""
        if use_ema is None:
            use_ema = state.g_ema is not None
        elif use_ema and state.g_ema is None:
            raise ValueError("use_ema=True but the state carries no EMA (set GANConfig.g_ema_decay)")
        dev, r = self.device, self.cfg.noise_range
        if gene is not None:
            if self.vae is None:
                raise ValueError("sampling from gene expression needs the wganvae loss family")
            z = encode_z_mean(self.vae, torch.as_tensor(gene, dtype=torch.float32).to(dev))
            if z_pop is not None:
                mean, std = (torch.as_tensor(t, dtype=torch.float32).to(dev).contiguous()
                             for t in z_pop)
                noise = infused_noise_population(z, mean, std, n, seed=seed, noise_range=r)
            else:
                noise = infused_noise(z, n, seed=seed, noise_range=r)
        else:
            gen = self.seeds.generator("sample", seed, device=dev)
            noise = torch.randn((n, self.cfg.model.encoding_dims), generator=gen, device=dev)
        if not self._conditional():
            labels = None
        elif labels is not None:
            labels = torch.as_tensor(labels).to(dev, torch.long)
        else:
            gen = self.seeds.generator("sample_labels", seed, device=dev)
            labels = torch.randint(0, self.cfg.model.num_classes, (n,), generator=gen, device=dev)
        imgs, _ = state.generator.forward_stats(noise, state.g_stats, False,
                                                params=state.g_ema if use_ema else None, labels=labels)
        return imgs.permute(0, 2, 3, 1)

    def set_z_population(self, rna_matrix) -> None:
        """z_mean statistics of the (normalized) training expression matrix,
        kept for generation and saved into every checkpoint."""
        if self.vae is None:
            raise ValueError("z population statistics need the wganvae loss family")
        self.z_pop = z_population_stats(self.vae, rna_matrix)

    # ------------------------------------------------------------ checkpoints
    @staticmethod
    def _state_dict(module, stats: Stats) -> Dict[str, torch.Tensor]:
        module.load_bn_stats(stats)
        return module.state_dict()

    def save_model(self, state: GANTrainState, path: str, epoch: int = 0, async_: bool = False) -> None:
        """The whole training state as a torchgan-layout ``.model`` bundle
        (``convert.save_training_bundle``). ``async_``: through the trainer's
        ``AsyncSaver`` (the state copied on the device now, written by a
        worker thread; :meth:`wait_saves` waits for it), byte-equal to the
        synchronous write of the same state."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        g_ema = None
        if state.g_ema is not None:
            names = [name for name, _ in state.generator.named_parameters()]
            g_ema = dict(zip(names, state.g_ema))
        opt_device = self.device if async_ else "cpu"  # the saver copies on the device, then to the host
        tree = dict(generator=self._state_dict(state.generator, state.g_stats),
                    discriminator=self._state_dict(state.discriminator, state.d_stats),
                    optimizer_generator=state.g_opt.state_dict(opt_device),
                    optimizer_discriminator=state.d_opt.state_dict(opt_device),
                    epoch=epoch, step=state.step, g_ema=g_ema, z_pop=self.z_pop)
        write = lambda p, t: convert.save_training_bundle(p, **t)  # noqa: E731
        if async_:
            self._saver.save(path, tree, write)
        else:
            write(path, to_host(tree))

    def wait_saves(self) -> None:
        """Block until the trainer's asynchronous save is written (raise its error)."""
        self._saver.wait()

    def load_model(self, path: str) -> GANTrainState:
        """Resume from a bundle. The file's magic picks the format, as the JAX
        loader picks it (``rnagan_tpu/train/gan_trainer.py:466-509``): a
        torch file is a torchgan-layout ``.model`` written by :meth:`save_model`
        or by the JAX package's ``export_torchgan_bundle``; anything else is
        the JAX package's own msgpack bundle (its ``GANTrainer.save_model``),
        moved by :meth:`state_from_jax`. A torchgan bundle without ``step``
        resumes at step 0 (as the JAX importer does); a bundle without
        ``g_ema`` seeds the EMA from the loaded weights when the EMA is on."""
        with open(path, "rb") as f:
            magic = f.read(4)
        if not (magic[:2] == b"PK" or magic[:1] == b"\x80"):  # torch.save: a zip or a pickle
            trees, _ = load_bundle(path)
            return self.state_from_jax(trees)
        bundle = convert.load_training_bundle(path)
        state = self.init_state()
        g, d = state.generator, state.discriminator
        g.load_state_dict(bundle["generator"])
        d.load_state_dict(bundle["discriminator"])
        state.g_stats, state.d_stats = _copy_stats(g.bn_stats()), _copy_stats(d.bn_stats())
        state.g_opt.load_state_dict(bundle["optimizer_generator"])
        state.d_opt.load_state_dict(bundle["optimizer_discriminator"])
        state.step = int(bundle.get("step", 0))
        if state.g_ema is not None:
            ema = bundle.get("g_ema")
            state.g_ema = [(ema[name] if ema is not None else p).detach().to(self.device).clone()
                           for name, p in g.named_parameters()]
        if "z_pop" in bundle:
            self.z_pop = (bundle["z_pop"]["mean"].to(self.device),
                          bundle["z_pop"]["std"].to(self.device))
        return state

    def state_from_jax(self, tree: Dict[str, Any]) -> GANTrainState:
        """A JAX ``GANTrainState`` in the form its ``save_model`` bundles it
        (``g_params``, ``g_stats``, ``g_opt``, ``d_params``, ``d_stats``,
        ``d_opt``, ``step``, optionally ``g_ema`` and ``z_pop``; optax's
        ``adam`` state as ``{"0": {"count", "mu", "nu"}, "1": {}}``), on this
        trainer's device. ``mu`` takes this trainer's ``adam_mu_dtype``; an
        EMA-less tree seeds the EMA from the weights when the EMA is on, and a
        tree's EMA is dropped when it is off (``:497-502``)."""
        m = self.cfg.model
        state = self.init_state()
        g, d = state.generator, state.discriminator
        g.load_state_dict(convert.generator_state_dict_from_jax(m, tree["g_params"], tree["g_stats"]))
        d.load_state_dict(convert.discriminator_state_dict_from_jax(m, tree["d_params"], tree["d_stats"]))
        state.g_stats, state.d_stats = _copy_stats(g.bn_stats()), _copy_stats(d.bn_stats())
        for opt, net, key in ((state.g_opt, "generator", "g_opt"), (state.d_opt, "discriminator", "d_opt")):
            adam = tree[key]["0"]
            mus, nus = convert.adam_moments_from_jax(m, net, adam["mu"], adam["nu"])
            for dst, src in zip(opt.mu + opt.nu, mus + nus):
                dst.copy_(src)
            opt.count = int(np.asarray(adam["count"]))
        state.step = int(np.asarray(tree["step"]))
        if state.g_ema is not None:
            ema = tree.get("g_ema")
            state.g_ema = ([t.to(self.device) for t in convert.param_list_from_jax(m, "generator", ema)]
                           if ema is not None else [p.detach().clone() for p in g.parameters()])
        if "z_pop" in tree:
            self.z_pop = tuple(torch.as_tensor(np.array(tree["z_pop"][k], np.float32)).to(self.device)
                               for k in ("mean", "std"))
        return state

    def state_to_jax(self, state: GANTrainState) -> Dict[str, Any]:
        """The inverse of :meth:`state_from_jax`: the trees the JAX
        ``GANTrainer.save_model`` bundles (``rnagan_tpu/train/gan_trainer.py:448-463``),
        numpy leaves in the flax layout, ``mu`` in this trainer's
        ``adam_mu_dtype`` (a bfloat16 ``mu`` as ``torch.bfloat16`` CPU tensors,
        which ``core/checkpoint.py::save_bundle`` writes as flax does), counts
        and the step int32; ``g_ema`` when the EMA is on and ``z_pop`` when set.
        ``core/checkpoint.py::save_bundle(path, trainer.state_to_jax(state))``
        writes a bundle the JAX ``load_model`` reads."""
        m = self.cfg.model
        trees: Dict[str, Any] = {}
        for key, net, module, stats, opt in (
                ("g", "generator", state.generator, state.g_stats, state.g_opt),
                ("d", "discriminator", state.discriminator, state.d_stats, state.d_opt)):
            to_jax = convert.generator_state_dict_to_jax if key == "g" else convert.discriminator_state_dict_to_jax
            params, stats_tree = to_jax(m, self._state_dict(module, stats))
            mu, nu = convert.adam_moments_to_jax(m, net, opt.mu, opt.nu)
            if self._mu_dtype == torch.bfloat16:  # exact: the float32 values came from bfloat16
                mu = _map_leaves(lambda a: torch.from_numpy(a).to(torch.bfloat16), mu)
            trees.update({f"{key}_params": params, f"{key}_stats": stats_tree,
                          f"{key}_opt": {"0": {"count": np.asarray(opt.count, np.int32), "mu": mu, "nu": nu},
                                         "1": {}}})
        trees["step"] = np.asarray(state.step, np.int32)
        if state.g_ema is not None:
            trees["g_ema"] = convert.param_list_to_jax(m, "generator", state.g_ema)
        if self.z_pop is not None:
            trees["z_pop"] = {k: t.detach().cpu().numpy().astype(np.float32)
                              for k, t in zip(("mean", "std"), self.z_pop)}
        return trees

    # ------------------------------------------------------------------- fit
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, batches_per_epoch_fn: Callable[[int], Iterable[Dict[str, Any]]], *,
            num_epochs: Optional[int] = None, state: Optional[GANTrainState] = None,
            sample_every: int = 1, save_every: int = 1, auto_resume: bool = False,
            eval_fn=None, eval_every: int = 0,
            keep_best_metric: Optional[str] = None) -> Tuple[GANTrainState, Dict[str, Any]]:
        """Epoch loop (``rnagan_tpu/train/gan_trainer.py:512-608``).
        ``batches_per_epoch_fn(epoch)`` yields global batch dicts (each rank
        steps on its rows, ``shard_batch``; pad them to a multiple of the
        data-axis size, ``pad_to``). Per epoch: the
        metric means (read from the card once, at the epoch's end),
        ``eval_fn(epoch, state, trainer) -> dict`` every ``eval_every`` epochs,
        a ``sample_size`` grid PNG into ``image_dir`` and ``gan_last.model``
        into ``model_dir``. ``auto_resume`` starts from
        ``model_dir/gan_last.model`` when it exists. ``keep_best_metric`` names
        an ``eval_fn`` scalar (lower is better): the state at its best value
        is kept and written to ``model_dir/gan_best.model``. Every rank runs
        ``eval_fn`` and takes rank 0's numbers, so every rank keeps the same
        best state; rank 0 writes the grids and bundles, through the
        ``AsyncSaver`` (a bundle is written while the next epoch trains),
        and ``fit`` waits for the last write before it returns."""
        cfg, mesh = self.cfg, self.mesh
        if state is None and auto_resume and self.model_dir:
            last = os.path.join(self.model_dir, "gan_last.model")
            if os.path.exists(last):
                log.info("auto-resuming from %s", last)
                state = self.load_model(last)
        state = state if state is not None else self.init_state()
        num_epochs = cfg.num_epochs if num_epochs is None else num_epochs
        history: List[Dict[str, float]] = []
        best_val, best_state, best_epoch = math.inf, None, -1
        for epoch in range(num_epochs):
            sums: Dict[str, torch.Tensor] = {}
            count = 0
            t0 = time.perf_counter()
            for batch in batches_per_epoch_fn(epoch):
                state, metrics = self.train_step(state, shard_batch(batch, mesh))
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
                count += 1
            with profiling.span("gan.fit.sync"):
                self._sync()
                epoch_s = time.perf_counter() - t0
                means = {k: float(v) / max(count, 1) for k, v in sums.items()}
            means["steps_per_sec"] = count / max(epoch_s, 1e-9)
            means["step_ms_mean"] = 1e3 * epoch_s / max(count, 1)
            if eval_fn is not None and eval_every and (epoch + 1) % eval_every == 0:
                means.update(collectives.broadcast_scalars(eval_fn(epoch, state, self), mesh))
                if keep_best_metric and means.get(keep_best_metric, math.inf) < best_val:
                    best_val, best_state, best_epoch = means[keep_best_metric], copy.deepcopy(state), epoch
            history.append(means)
            log.info("epoch %d: %s", epoch, " ".join(f"{k} {v:.4f}" for k, v in means.items()))
            if self.image_dir and (epoch + 1) % sample_every == 0 and mesh.writer:
                imgs = self.sample(state, cfg.sample_size, seed=self.seeds.seed("grid", epoch))
                save_image_grid(imgs, os.path.join(self.image_dir, f"epoch_{epoch}.png"), nrow=8)
            if self.model_dir and (epoch + 1) % save_every == 0 and mesh.writer:
                self.save_model(state, os.path.join(self.model_dir, "gan_last.model"), epoch=epoch, async_=True)
        out: Dict[str, Any] = {"history": history}
        if best_state is not None:
            if self.model_dir and mesh.writer:
                self.save_model(best_state, os.path.join(self.model_dir, "gan_best.model"), epoch=best_epoch,
                                async_=True)
            out["best"] = {"state": best_state, "epoch": best_epoch, keep_best_metric: best_val}
        if self.model_dir:
            on_writer(mesh, self.wait_saves)  # every bundle whole before any rank reads one
        return state, out
