"""The port's int8 prefill quantize + page scatter vs the JAX package's
Pallas kernel (interpret mode), and its wiring into the prefill writer.

Pool bytes must be bit-identical given identical float inputs and inverse
scales; pages with pid == NP (uncovered pages, padding rows) are never
written."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from min_llm_inference_tpu.ops.prefill_scatter import (
    prefill_quant_scatter as jax_prefill_quant_scatter,
)
from min_llm_inference_tpu_torch.models import paged as tp
from min_llm_inference_tpu_torch.ops import prefill_scatter as ps
from min_llm_inference_tpu_torch.ops.quant import inv_scale

NP, P, D, M, W_PRE = 24, 8, 32, 5, 2


def case(rng, in_dtype):
    pool = rng.integers(-127, 128, (NP, 2, P, D)).astype(np.int8)
    k = (rng.standard_normal((M, W_PRE * P, D)) * 2).astype(np.float32)
    v = (rng.standard_normal((M, W_PRE * P, D)) * 2).astype(np.float32)
    if in_dtype == "bfloat16":
        k = k.astype(ml_dtypes.bfloat16)
        v = v.astype(ml_dtypes.bfloat16)
    pid = rng.permutation(NP)[:M * W_PRE].reshape(M, W_PRE).astype(np.int32)
    pid[1, 1] = NP                    # page past the prompt
    pid[4, :] = NP                    # padding row
    # scales: zero (unset page -> inv 0), tiny (values clip), ordinary
    s = rng.uniform(0.005, 0.05, (2, M, W_PRE)).astype(np.float32)
    s[0, 0, 0] = 0.0
    s[1, 2, 1] = 1e-4
    inv = np.where(s > 0, np.float32(1) / np.maximum(s, np.float32(1e-30)),
                   np.float32(0)).astype(np.float32)
    return pool, k, v, pid, inv[0], inv[1]


def to_torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_prefill_quant_scatter_matches_jax(in_dtype):
    pool, k, v, pid, inv_k, inv_v = case(np.random.default_rng(4), in_dtype)
    want = np.asarray(jax_prefill_quant_scatter(
        *(jnp.asarray(x) for x in (pool, k, v, pid, inv_k, inv_v)),
        interpret=True))
    tpool = torch.from_numpy(pool.copy())
    before = ps.prefill_quant_scatter.launches
    got = ps.prefill_quant_scatter(tpool, *(to_torch(x) for x in
                                            (k, v, pid, inv_k, inv_v)))
    assert got is tpool and ps.prefill_quant_scatter.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    written = set(pid[pid < NP].tolist())
    untouched = [p for p in range(NP) if p not in written]
    np.testing.assert_array_equal(got.numpy()[untouched], pool[untouched])
    assert not np.array_equal(got.numpy(), pool)


def test_strided_kv_slices_take_the_same_path():
    """k and v as column slices of one fused [M, S, 2D] projection, as the
    prefill hands them over."""
    pool, k, v, pid, inv_k, inv_v = case(np.random.default_rng(8), "float32")
    kv = torch.from_numpy(np.concatenate([k, v], axis=-1))
    a = ps.prefill_quant_scatter(torch.from_numpy(pool.copy()),
                                 kv[..., :D], kv[..., D:], *(to_torch(x) for x
                                                             in (pid, inv_k,
                                                                 inv_v)))
    b = ps.prefill_quant_scatter(torch.from_numpy(pool.copy()),
                                 *(to_torch(x) for x in
                                   (k, v, pid, inv_k, inv_v)))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kv_dtype,s_pre,calls", [
    ("int8", 2 * P, 1), ("int8", 2 * P + 3, 0), ("int4", 2 * P, 0),
])
def test_prefill_writer_uses_the_kernel_for_int8_page_blocks(
        monkeypatch, kv_dtype, s_pre, calls):
    """int8 pools with a page-multiple block go through
    prefill_quant_scatter, with the inverses of the updated page scales;
    int4 pools and ragged blocks take the plain path."""
    seen = []
    real = tp.prefill_quant_scatter

    def spy(pool, k, v, pid, inv_k, inv_v):
        seen.append((pid.clone(), inv_k.clone()))
        return real(pool, k, v, pid, inv_k, inv_v)

    monkeypatch.setattr(tp, "prefill_quant_scatter", spy)
    rng = np.random.default_rng(1)
    feat = D // 2 if kv_dtype == "int4" else D
    state = tp.PagedKVState(
        (torch.zeros((NP, 2, P, feat), dtype=torch.int8),),
        (torch.zeros(NP),), (torch.zeros(NP),))
    rows = torch.from_numpy(
        rng.permutation(NP)[:M * 3].reshape(M, 3).astype(np.int32))
    plens = torch.tensor([s_pre, 1, P + 1, 0, s_pre - 1], dtype=torch.int32)
    write, finalize = tp.make_prefill_kv_writer(state, rows, plens, s_pre, P,
                                                NP, n_heads=2)
    k = torch.from_numpy(rng.standard_normal((M, s_pre, D)).astype(np.float32))
    write(0, k, k * 0.5)
    assert len(seen) == calls
    if calls:
        pid, inv_k = seen[0]
        covered = (torch.arange(2)[None, :] * P) < plens[:, None]
        assert torch.equal(pid, torch.where(covered, rows[:, :2], NP))
        ks = finalize().k_scales[0][pid.clamp(0, NP - 1).long()]
        assert torch.equal(inv_k, inv_scale(ks))
