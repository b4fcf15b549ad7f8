"""The port's int4 probe (``tools/int4_probe.py`` of the port package) vs
the JAX package's probe kernel.

The JAX kernel (tools/int4_probe.py::kernel) runs in interpret mode on a
native int4 array of the same values; the port's plain version unpacks its
packed pages and calls torch.matmul. Every product and partial sum of
quarter-integers is exact in float32, so the two agree bit for bit."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from min_llm_inference_tpu_torch.ops.quant import pack_int4_rows, unpack_int4
from min_llm_inference_tpu_torch.tools import int4_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_probe_kernel():
    spec = importlib.util.spec_from_file_location(
        "jax_int4_probe", os.path.join(ROOT, "tools", "int4_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel


def run_jax_kernel(values):
    """The JAX probe's pallas_call, as its main() builds it, in interpret
    mode, on int4 values [4, 32, 512]."""
    _, P, D = values.shape
    x = jnp.asarray(values, jnp.int4)
    out = pl.pallas_call(
        jax_probe_kernel(),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((P, P), lambda: (0, 0)),
            grid=(),
            scratch_shapes=[pltpu.VMEM((P, D), jnp.int4),
                            pltpu.SemaphoreType.DMA],
        ),
        out_shape=jax.ShapeDtypeStruct((P, P), jnp.float32),
        interpret=True,
    )(x)
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_plain_matches_jax_kernel(seed):
    x = int4_probe.make_pages(seed)
    values = unpack_int4(x, 1).numpy().astype(np.int8)
    assert values.shape == int4_probe.SHAPE
    assert values.min() >= -7 and values.max() <= 7
    before = int4_probe.int4_page_self_dot.launches
    got = int4_probe.int4_page_self_dot(x)
    assert int4_probe.int4_page_self_dot.launches == before  # plain on CPU
    np.testing.assert_array_equal(got.numpy(), run_jax_kernel(values))


def extreme_values(kind):
    """int4 values of the probe's SHAPE at the ends of the pools' range:
    every value +7, every value -7, or +-7 with random signs (the largest
    sums in size, positive on the diagonal)."""
    if kind == "mixed7":
        signs = np.random.default_rng(5).integers(0, 2, int4_probe.SHAPE)
        return (7 * (2 * signs - 1)).astype(np.int8)
    return np.full(int4_probe.SHAPE, 7 if kind == "plus7" else -7, np.int8)


@pytest.mark.parametrize("kind", ["plus7", "minus7", "mixed7"])
def test_probe_plain_matches_jax_kernel_at_the_range_ends(kind):
    """Pages of +-7 only: sums of 512 products of 49/16 (1568 in size) are
    still exact in float32, in both versions."""
    values = extreme_values(kind)
    x = pack_int4_rows(torch.from_numpy(values), 1)
    got = int4_probe.int4_page_self_dot(x)
    want = run_jax_kernel(values)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() == 512 * 49 / 16


def test_probe_packs_as_the_pools():
    """Byte c of a row holds value c as lo and value c + 256 as hi, 16 *
    hi + lo, as ops/quant.pack_int4_rows packs one head."""
    x = int4_probe.make_pages(3)
    v = unpack_int4(x, 1).to(torch.int32)
    assert x.shape == (4, 32, 256) and x.dtype == torch.int8
    assert torch.equal(x.to(torch.int32), 16 * v[..., 256:] + v[..., :256])


def test_probe_entry_point_on_cpu(capsys):
    assert int4_probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("SUPPORTED:") and "plain version" in out


def test_probe_reports_the_failing_stage(capsys):
    """Without a GPU the default device fails at the first stage: the
    probe prints UNSUPPORTED, or raises when strict."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    assert int4_probe.probe() is False
    assert capsys.readouterr().out.startswith("UNSUPPORTED after []")
    with pytest.raises(RuntimeError, match="CUDA"):
        int4_probe.probe(strict=True)


def test_probe_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        int4_probe.int4_page_self_dot(int4_probe.make_pages().to("meta"))
