"""Build and load the port's CUDA kernels: ``nvcc`` alone, one ``ctypes`` library.

Each ``csrc/*.cu`` source compiles to an object in its own ``nvcc`` process,
all started together, and one more ``nvcc`` call links the objects into a
shared library with a plain C interface (no PyTorch headers, which would
cost minutes of compile time). The library is built at first use into
``build/torch_kernels/`` beside the package (listed in ``.gitignore``); a
stamp file holds the hash of the sources and flags, so an unchanged tree
loads the existing library without rebuilding.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. :data:`LAUNCHES`
counts successful launches per kernel, so a run can show which kernels its
main path went through.

Every kernel is reached through an operator of the ``gdl`` namespace
(:func:`define`): the dispatcher sends a CUDA tensor to the kernel's
launch, a CPU tensor to its plain version, and a fake or meta tensor to a
shape function, so ``torch.export`` and other traces record one ``gdl::``
node a kernel call. Defining the operators builds nothing: the library is
built at the first CUDA call. :func:`load_ops` imports every module that
defines them (a saved program that names them needs that before it loads).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
LIB_NAME = "libgdl_torch_kernels.so"
BUILD_LOG = BUILD_DIR / "nvcc.log"
SOURCES = ("preprocess.cu", "layernorm.cu", "attention.cu", "attention_bwd.cu",
           "attention_hm.cu", "attention_hm_bwd.cu", "attention_f32.cu", "sr_attention.cu",
           "packed_conv.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

# kernel name -> launches since the last reset (see reset_launches)
LAUNCHES: collections.Counter = collections.Counter()

NAMESPACE = "gdl"
LIBRARY = torch.library.Library(NAMESPACE, "DEF")
# the modules that define the gdl:: operators
OP_MODULES = ("preprocess", "layernorm", "mha", "sr_attention", "packed_conv")

_P = ctypes.c_void_p
_SIGNATURES = {
    # img, mean, std, stat_stride, out, out_bf16, batch, n, c, bulk, stream
    "gdl_preprocess": (_P, _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P),
    # x, branch, gamma, beta, s, y, mu, rstd, rows, d, tile_rows, stages,
    # eps, is_bf16, stream
    "gdl_layernorm_fwd": (*(_P,) * 8, ctypes.c_longlong, *(ctypes.c_int,) * 3,
                          ctypes.c_float, ctypes.c_int, _P),
    # x, dy, ds_in, gamma, mu, rstd, dx, dgamma, dbeta, scratch,
    # scratch_floats, counters, rows, d, tile_rows, stages, is_bf16, stream
    "gdl_layernorm_bwd": (*(_P,) * 10, ctypes.c_longlong, _P, ctypes.c_longlong,
                          *(ctypes.c_int,) * 4, _P),
    # d, tile_rows, stages, is_bf16, residual, &scratch_floats, &counters
    "gdl_layernorm_bwd_workspace": (*(ctypes.c_int,) * 5, _P, _P),
    # qkv, out, lse, B, L, H, hd, scale, stream
    "gdl_attention_fwd_packed": (_P, _P, _P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float, _P),
    # qkv, o, g, lse, delta, dqkv, B, L, H, hd, scale, stream
    "gdl_attention_bwd_packed": (_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float, _P),
    # q, k, v, out, lse, B, L, H, hd, (batch, head, row) strides of q/k/v
    # and out, scale, stream
    "gdl_attention_fwd_hm": (*(_P,) * 5, *(ctypes.c_int,) * 4, *(ctypes.c_longlong,) * 6,
                             ctypes.c_float, _P),
    # q, k, v, o, g, lse, delta, dq, dk, dv, B, L, H, hd, (batch, head, row)
    # strides of q/k/v/dq/dk/dv, o and g, scale, stream
    "gdl_attention_bwd_hm": (*(_P,) * 10, *(ctypes.c_int,) * 4, *(ctypes.c_longlong,) * 9,
                             ctypes.c_float, _P),
    # the f32 instances (K4/K8 and K7/K9 on float32): the head-major
    # signatures above, over f32 views
    "gdl_attention_fwd_f32": (*(_P,) * 5, *(ctypes.c_int,) * 4, *(ctypes.c_longlong,) * 6,
                              ctypes.c_float, _P),
    "gdl_attention_bwd_f32": (*(_P,) * 10, *(ctypes.c_int,) * 4, *(ctypes.c_longlong,) * 9,
                              ctypes.c_float, _P),
    # hd, 0 (dK/dV kernel) or 1 (dQ kernel): its dynamic shared memory in bytes
    "gdl_attention_bwd_f32_smem": (ctypes.c_int, ctypes.c_int),
    # q, k, v, o, B, H, Lq, Lk, D, is_bf16, (batch, head, row) strides of
    # q, k, v and o, scale, stream
    "gdl_sr_attention_fwd": (_P, _P, _P, _P, *(ctypes.c_int,) * 6,
                             *(ctypes.c_longlong,) * 12, ctypes.c_float, _P),
    # B, H, Wp
    "gdl_packed_conv_blocks": (ctypes.c_int,) * 3,
    # x, kp, scale, shift, y, part, stats, B, H, Wp, blocks, apply_bn_relu, stream
    "gdl_packed_conv_bn_stats": (*(_P,) * 7, *(ctypes.c_int,) * 5, _P),
}


def reset_launches() -> None:
    LAUNCHES.clear()


def define(schema: str, cpu, cuda, fake) -> torch._ops.OpOverload:
    """Define ``gdl::<schema>`` with its plain version for CPU tensors, its
    kernel's launch for CUDA tensors and a shape function for fake and meta
    tensors; returns the operator, to be called as a function."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIBRARY)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def load_ops() -> None:
    """Import every module that defines a ``gdl::`` operator."""
    for name in OP_MODULES:
        importlib.import_module(f"{__package__}.{name}")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    msg = "nvcc not found: the port's CUDA kernels need the CUDA toolkit"
    raise RuntimeError(msg)


def _stamp() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def _run(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with the output of any that
    fails, else return their outputs joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed, outs = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            outs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} -> {proc.returncode}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        msg = "nvcc failed:\n" + "\n".join(failed)
        raise RuntimeError(msg)
    return "".join(outs)


def build() -> tuple[Path, float]:
    """Compile the library unless an up-to-date build exists.

    Returns the library path and the seconds spent compiling (0.0 when the
    stamped build was reused). Raises if ``nvcc`` fails. The compiler's
    output, with ``ptxas``'s registers, shared memory and spills of every
    kernel, is kept in :data:`BUILD_LOG`.
    """
    lib_path = BUILD_DIR / LIB_NAME
    stamp_path = BUILD_DIR / "stamp.txt"
    stamp = _stamp()
    if lib_path.exists() and stamp_path.exists() and stamp_path.read_text() == stamp:
        return lib_path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = os.getpid()
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                    for s, o in zip(SOURCES, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    BUILD_LOG.write_text(log)
    stamp_path.write_text(stamp)
    return lib_path, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.gdl_error_string.argtypes = [ctypes.c_int]
    lib.gdl_error_string.restype = ctypes.c_char_p
    return lib


def stream_ptr(t: torch.Tensor) -> int:
    """The raw pointer of the current stream of ``t``'s device (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    making a ``Stream`` object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error; count it otherwise."""
    if code != 0:
        err = library().gdl_error_string(code).decode()
        msg = f"CUDA kernel {kernel} failed to launch: {err} ({code})"
        raise RuntimeError(msg)
    LAUNCHES[kernel] += 1


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic type: f32, or the input's if wider."""
    return torch.promote_types(dtype, torch.float32)


def require_device(t: torch.Tensor, what: str) -> None:
    """The operators run on CUDA tensors (the kernel) and CPU tensors (its
    plain version); a tensor on any other device is refused before the
    call, so that no such tensor reaches the plain version."""
    if t.device.type not in ("cuda", "cpu"):
        msg = f"{what}: expected a CUDA or CPU tensor, got {t.device}"
        raise ValueError(msg)


def require_aligned(t: torch.Tensor, what: str) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        msg = f"{what}: the kernel needs a contiguous, 16-byte aligned tensor"
        raise ValueError(msg)


def require_rows_aligned(t: torch.Tensor, what: str) -> None:
    """For kernels that take strides: a contiguous last dimension and every
    row starting on a 16-byte boundary (a strided view passes)."""
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) or t.data_ptr() % 16:
        msg = f"{what}: the kernel needs a contiguous last dimension and 16-byte aligned rows"
        raise ValueError(msg)
