"""PyTorch/CUDA port of the RNA-GAN framework, for NVIDIA Hopper cards.

The JAX package ``rnagan_tpu`` is the reference; this package mirrors its
module names (``core/``, ``models/``, ``losses/``, ``eval/``, ``train/``,
``parallel/``: the trainers over a ``torch.distributed`` mesh) and carries its
own copy of everything it needs: it imports ``torch``, ``numpy`` and the
standard library only. The Pallas kernels of the reference become CUDA C++
kernels under ``csrc/``, built with ``nvcc`` at their first launch and bound
with ``ctypes`` (``kernels/``).

Entry points: tile synthesis, :class:`rnagan_tpu_torch.eval.generate.Synthesizer`;
GAN training, :class:`rnagan_tpu_torch.train.gan_trainer.GANTrainer`; the
downstream tile classifier, SimCLR and fusion,
:mod:`rnagan_tpu_torch.train.ml_experiment`, ``ssl_trainer`` and
``fusion_trainer``; the command line, ``python -m rnagan_tpu_torch.cli.main
<command>``.
"""
