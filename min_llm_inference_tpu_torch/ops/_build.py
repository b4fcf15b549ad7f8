"""Build and load the port's native libraries.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library for Hopper (``sm_90a``), loaded with ctypes.
``csrc/*.cpp`` files (the native host scheduler) are compiled the same way
by the host C++ compiler (``c++``). Libraries are built at first use into
``_build/`` inside the package (listed in .gitignore), named by a hash of
the source, the ``csrc/*.cuh`` headers and the flags so that an edit
rebuilds. A source may also be built with preprocessor defines (the timing
variants of ``csrc/ring_partial.cuh``, ``RING_PARTIAL_SPLIT``) into a
library of its own. Nothing here runs at import time: the CPU tests import
every module, and the CPU has no ``nvcc``.

Each kernel wrapper counts its launches (``counted``, ``count_launch``):
on the host when it launches eagerly, on the device when the launch is
recorded into a CUDA graph (runtime/graph.py), so that every replay counts
the launches it makes.

No ``--use_fast_math``: the kernels' quantizers must round exactly as the
plain versions do (IEEE ``1.0f / s``, ``rintf``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("paged_attention_grouped.cu", "paged_attention_dgrid.cu",
           "ring_flush.cu", "prefill_scatter.cu", "paged_attention.cu",
           "paged_attention_flat.cu", "int4_probe.cu", "graph_cond.cu",
           "sample_next_token.cu", "prefill_attention.cu", "mla_decode.cu")
# host C++ sources (no CUDA): built by the host compiler
HOST_SOURCES = ("scheduler.cpp",)
# dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM = 232448
# widest q row the attention kernels take (csrc/ring_partial.cuh: a
# cluster of 16 blocks of 128 threads x 32 accumulators)
MAX_FEATURES = 65536
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wextra")


def _is_host(source: str) -> bool:
    return source.endswith(".cpp")


def _flags(source: str, defines: tuple = ()) -> tuple:
    if _is_host(source):
        return CXX_FLAGS
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def build_item(item) -> tuple:
    """(source, defines) of a build item: a source name, or (source,
    defines)."""
    return (item, ()) if isinstance(item, str) else (item[0], tuple(item[1]))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _cxx() -> str:
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++, g++, clang++) found: the "
                       "native scheduler cannot be built")


def library_path(source: str, defines: tuple = ()) -> str:
    """The library of ``source`` built with ``defines``, named by a hash of
    the source, the headers under csrc/ (a .cu may include them) and the
    flags."""
    digest = hashlib.sha256(" ".join(_flags(source, defines)).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in (source, *([] if _is_host(source) else headers)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(sources=SOURCES) -> dict:
    """Compile every item whose library is missing (an item: a source name,
    or (source, defines)), one compiler process per item (``nvcc`` for .cu,
    ``c++`` for .cpp), all started together. Returns {item: seconds} for
    the items compiled by this call; raises with the compiler's output on
    failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [i for i in sources
            if not os.path.exists(library_path(*build_item(i)))]
    if not todo:
        return {}
    compilers = {}
    procs = []
    for item in todo:
        src, defines = build_item(item)
        kind = "host" if _is_host(src) else "cuda"
        if kind not in compilers:
            compilers[kind] = _cxx() if kind == "host" else _nvcc()
        out = library_path(src, defines)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compilers[kind], *_flags(src, defines), "-o", tmp,
               os.path.join(CSRC_DIR, src)]
        procs.append((item, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    took, failed = {}, []
    for src, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        with open(out + ".log", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed\n" + "\n".join(failed))
    return took


def load(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """The library of one source (built with ``defines``), built first if
    needed."""
    build(((source, defines),))
    return ctypes.CDLL(library_path(source, defines))


def check_rows(name, t, B, D, dtype, device) -> None:
    """Raise unless t is a [B, D] ``dtype`` tensor on ``device`` with unit
    inner stride (a column slice of a wider projection is fine)."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() != 2 or tuple(t.shape) != (B, D) or t.stride(1) != 1:
        raise ValueError(f"{name} must be [{B}, {D}] with unit inner stride")


def check_contig(name, t, shape, dtype, device) -> None:
    """Raise unless t is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.mli_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


# the kernel wrappers that count their launches, in registration order: a
# captured graph counts on the device at these indices
COUNTED = []
MAX_COUNTED = 16
_device_counts = None


def counted(wrapper):
    """Register a kernel wrapper: ``wrapper.launches`` counts its kernel
    launches since the last reset."""
    if len(COUNTED) == MAX_COUNTED:
        raise RuntimeError("too many counted kernel wrappers")
    wrapper.launches = 0
    wrapper.count_index = len(COUNTED)
    COUNTED.append(wrapper)
    return wrapper


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel, where it launches it: on
    the host, or, while a graph is captured under ``counting_on_device``,
    on the device inside the graph (the launch is only recorded then, and
    the count with it: both run at each replay that runs the launch)."""
    if _device_counts is not None and torch.cuda.is_current_stream_capturing():
        _device_counts[wrapper.count_index].add_(1)
    else:
        wrapper.launches += 1


@contextlib.contextmanager
def counting_on_device(counts):
    """Inside, launches recorded into a graph under capture count into the
    device vector ``counts`` ([MAX_COUNTED], by ``count_index``); None
    leaves counting on the host."""
    global _device_counts
    prev, _device_counts = _device_counts, counts
    try:
        yield
    finally:
        _device_counts = prev


def add_device_counts(counts) -> None:
    """Add launches counted on the device (a host sequence by
    ``count_index``) to the wrappers' ``launches``."""
    for wrapper in COUNTED:
        wrapper.launches += int(counts[wrapper.count_index])
