"""Build the CUDA sources under ``csrc/`` into one shared library and bind it.

``nvcc`` compiles each ``csrc/*.cu`` to an object for ``sm_90a`` (all
sources at once, in parallel) and links them into
``build/torch_kernels/librnagan_kernels-<hash>.so`` at the repository root.
The hash covers every source and the flags, so a changed source rebuilds and
an unchanged one loads the library already there. The sources have a plain C
interface (no PyTorch headers), which keeps a build to seconds; ``ctypes``
loads the result, with ``c_void_p`` for every pointer and the stream.

Nothing builds at import: the first CUDA launch calls :func:`library`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_longlong
#: C entry point -> argtypes; every entry point returns its cudaError_t as int
SIGNATURES = {
    # z, z_row_stride, u, pop_mean, pop_std, out, n, d, seed, seed_ptr, seed_bytes,
    # noise_range, var_u, rows_per_thread, stream
    "rnagan_infused_noise": [_P, _LL, _P, _P, _P, _P, _I, _I, _U, _P, _I, _F, _F, _I, _P],
    # z, z_row_stride, u, out, sums, sq, n, d, row0, seed, noise_range, phase, stream
    "rnagan_infused_noise_group": [_P, _LL, _P, _P, _P, _P, _I, _I, _LL, _U, _F, _I, _P],
    # x, out, n, hw, stream
    "rnagan_tanh_to_uint8": [_P, _P, _I, _I, _P],
    # table, count, mu_bf16, lr, b1, b2, 1-b1, 1-b2, eps, c1, c2, corr, corr_n, wd, stream
    "rnagan_fused_adam": [_P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _P, _I, _F, _P],
    # x, xb scratch, w_q, scale, bias, out, n, k, m, tile_n, stream
    "rnagan_int8_matmul_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, xb scratch, w_q, scale, bias, out, n, k, m, stream
    "rnagan_int8_matmul_bytewise": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # stage, stream
    "rnagan_mark": [_I, _P],
    # x, scale, mean, var, part and tickets scratch, stats, new_mean, new_var, rows, c, chunks, rows_per_chunk,
    # stream
    "rnagan_batch_norm_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, stats, bias, y, rows, c, chunks, rows_per_chunk, slope, act, stream
    "rnagan_batch_norm_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # g, x, stats, bias, part and tickets scratch, dbias, dscale, rows, c, chunks, rows_per_chunk, slope, act,
    # stream
    "rnagan_batch_norm_grad_sums": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # g, x, stats, bias, dbias, dscale, dx, rows, c, chunks, rows_per_chunk, slope, act, stream
    "rnagan_batch_norm_grad_input": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # g, x, u, stats, bias, dbias, dscale, a, b, part and tickets scratch, coef, dscale_grad, rows, c, chunks,
    # rows_per_chunk, slope, act, stream
    "rnagan_batch_norm_grad2_sums": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                     _P],
    # g, x, u, stats, bias, coef, gg, gx, rows, c, chunks, rows_per_chunk, slope, act, stream
    "rnagan_batch_norm_grad2_input": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
}


@dataclass(frozen=True)
class KernelBuild:
    path: Path
    seconds: float  # 0.0 when the library for these sources was already built
    log: str  # nvcc's output (ptxas register and shared-memory use)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    found = str(candidate) if candidate.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> KernelBuild:
    """Compile and link the kernels unless this exact build exists."""
    srcs = sources()
    lib = BUILD_DIR / f"librnagan_kernels-{_digest(srcs)}.so"
    if lib.exists():
        return KernelBuild(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, log) for src, p, log in zip(srcs, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}:\n{log}" for n, log in failed))
        staged = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", "-o", str(staged), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, lib)  # atomic: a concurrent loader sees all of it or nothing
    return KernelBuild(lib, time.perf_counter() - t0, "".join(logs))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The bound kernel library (built on first use, once per process)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    """Raise when a C entry point reports a CUDA error (its launch never ran)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
