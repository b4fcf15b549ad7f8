"""Probe: does one packed int4 KV page load into on-chip memory, dequantize
and feed a dot on this card?

Counterpart of the JAX package's tools/int4_probe.py, which asked the same
of Mosaic on a TPU with a Pallas kernel (``kernel``: DMA one native-int4
page into VMEM, dequantize, self-dot). Here the kernel is
``csrc/int4_probe.cu``: one block copies page 0 of a ``[4, 32, 512]`` int4
tensor into shared memory with one bulk copy (TMA), unpacks it to int8
values and writes the ``[32, 32]`` product x . x^T of the values times
0.25, from int8 tensor-core products (``mma.sync``, int32 sums: exact). The
plain version beside it unpacks, multiplies by 0.25 and calls
``torch.matmul``.

The values are packed two per byte as the port's pools pack them
(ops/quant.py: per head, byte c = 16*hi + lo), which holds values in
[-7, 7], the port's int4 range (``kv_qmax(True)``); the JAX probe drew
native int4 values in [-8, 7].

    python -m min_llm_inference_tpu_torch.tools.int4_probe           # the card
    python -m min_llm_inference_tpu_torch.tools.int4_probe --device cpu

Prints SUPPORTED with the stages that ran, or UNSUPPORTED with the stage
reached and the error; exits non-zero when unsupported. ``probe(strict=
True)`` raises instead (chip_smoke.py runs it so).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
import traceback

import numpy as np
import torch

from ..config import resolve_device
from ..ops import _build
from ..ops._build import check_contig
from ..ops.quant import INT4_MAX, pack_int4_rows, unpack_int4

_SOURCE = "int4_probe.cu"
SHAPE = (4, 32, 512)     # pages, rows per page, int4 values per row
SCALE = 0.25


def make_pages(seed: int = 0) -> torch.Tensor:
    """Random int4 values in [-7, 7] of SHAPE, packed (one head per row)
    into a [4, 32, 256] int8 CPU tensor."""
    vals = np.random.default_rng(seed).integers(
        -int(INT4_MAX), int(INT4_MAX) + 1, SHAPE)
    return pack_int4_rows(torch.from_numpy(vals.astype(np.int8)), 1)


def int4_page_self_dot(x):
    """Page 0 of the packed int4 tensor x [n, P, Dk] int8, dequantized
    (x 0.25) to [P, 2*Dk] float32, times its transpose: [P, P] float32."""
    if x.device.type == "cpu":
        return int4_page_self_dot_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x)


# kernel launches since the last reset (launches made by the wrapper only)
_build.counted(int4_page_self_dot)


def int4_page_self_dot_plain(x):
    """The plain version: unpack, dequantize, ``torch.matmul``."""
    xf = unpack_int4(x[0], 1) * SCALE
    return torch.matmul(xf, xf.t())


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built on first use) with its C signatures."""
    lib = _build.load(_SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mli_int4_probe.argtypes = [vp, vp, i, i, vp]
    lib.mli_int4_probe.restype = ctypes.c_int
    lib.mli_int4_probe_smem.argtypes = [i, i]
    lib.mli_int4_probe_smem.restype = ctypes.c_longlong
    lib.mli_error_string.argtypes = [i]
    lib.mli_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x):
    dev = x.device
    if x.dim() != 3:
        raise ValueError("x must be [n, P, Dk] packed int4")
    n, P, Dk = x.shape
    check_contig("x", x, (n, P, Dk), torch.int8, dev)
    if P % 16 or Dk % 16 or x.data_ptr() % 16:
        raise ValueError("the page must be 16-byte aligned, with P and Dk "
                         "multiples of 16 (the bulk copy and the m16n8k32 "
                         "tiles)")
    lib = _library()
    if lib.mli_int4_probe_smem(P, Dk) > _build.MAX_SMEM:
        raise ValueError(f"a [{P}, {2 * Dk}] page does not fit shared memory")
    out = torch.empty((P, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mli_int4_probe(x.data_ptr(), out.data_ptr(), P, Dk, stream)
    _build.check(lib, rc, "int4 probe kernel")
    _build.count_launch(int4_page_self_dot)
    return out


def probe(device=None, strict: bool = False) -> bool:
    """Run the probe on ``device`` (``cuda`` unless named; on the CPU only
    the plain version runs) and print SUPPORTED or UNSUPPORTED with the
    stages. ``strict``: raise on failure instead of returning False."""
    stages = []
    try:
        dev = resolve_device(device)
        x = make_pages().to(dev)
        stages.append(f"int4 pages packed: {list(SHAPE)} values as "
                      f"{list(x.shape)} int8 on {dev}")
        got = int4_page_self_dot(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            stages.append("bulk-copy page load + unpack + tensor-core dot "
                          "kernel ran")
        else:
            stages.append("plain version ran (the kernel runs on CUDA only)")
        want = int4_page_self_dot_plain(x)
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"kernel differs from the plain version "
                                 f"(max abs err {err})")
        stages.append("equal to unpack + torch.matmul")
        print("SUPPORTED:", "; ".join(stages), flush=True)
        return True
    except Exception as e:
        if strict:
            raise
        print("UNSUPPORTED after", stages, flush=True)
        traceback.print_exception(type(e), e, None, limit=3)
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device to probe (default cuda)")
    args = ap.parse_args(argv)
    return 0 if probe(args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
