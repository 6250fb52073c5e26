"""Hand-written CUDA kernels of the port, one module per TPU kernel it replaces.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter (a plain int on the wrapper). A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. ``_build`` compiles
``csrc/*.cu`` with ``nvcc`` at the first launch and binds it with ``ctypes``.

| module        | kernel                    | replaces                                          |
|---------------|---------------------------|---------------------------------------------------|
| ``infusion``  | ``csrc/infusion.cu``      | ``rnagan_tpu/ops/infusion.py::pallas_infused_noise`` |
| ``quantize``  | ``csrc/quantize.cu``      | ``rnagan_tpu/ops/quantize.py::pallas_tanh_to_uint8`` |
| ``fused_adam``| ``csrc/fused_adam.cu``    | ``rnagan_tpu/ops/fused_adam.py::adam_update_flat`` |
| ``quant_matmul`` | ``csrc/quant_matmul.cu`` | ``rnagan_tpu/ops/quant_matmul.py::pallas_int8_matmul`` |

``csrc/marks.cu`` replaces no TPU kernel: its empty stage marks are launched
by ``core/profiling.py::mark``. Nor does ``csrc/batchnorm.cu`` (module
``batchnorm``): the train-mode BatchNorm (+ LeakyReLU) of a bf16
channels-last map and its backward, which XLA fuses on the TPU and
``models/batchnorm.py`` routes to on the card.
"""
