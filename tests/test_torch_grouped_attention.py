"""The port's fused-write paged attention vs the JAX grouped Pallas kernel.

On the CPU the port's wrapper runs its plain version (quantize + pack +
scatter at lengths-1, then the gather oracle); the JAX kernel runs in
interpret mode, as the JAX package's own tests run it. Inputs come from one
numpy generator: contiguous page groups (the engine's allocator), dead
slots, and inserts at page boundaries. The written pool must be
bit-identical and o must agree within 1e-5.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py and by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from min_llm_inference_tpu.ops.paged_attention_grouped import (
    paged_decode_attention_grouped as jax_grouped,
)
from min_llm_inference_tpu.ops.quant import update_page_scales as jax_scales
from min_llm_inference_tpu.models.paged import decode_fresh_pid as jax_fresh
from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
    paged_decode_attention_grouped,
    paged_decode_attention_grouped_plain,
)

B, W, P, D = 8, 2, 16, 32


def make_inputs(rng, kv, H):
    """Numpy inputs; scales already updated for the fresh pages (the
    engine's write_kv does that before the kernel)."""
    NG = B + 2
    NP = NG * W
    packed = kv == "int4"
    Dk = D // 2 if packed else D
    gids = rng.permutation(NG)[:B]
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    # dead, fresh-page row 0 (len-1 % P == 0), mid-page, page-final rows
    lengths = np.array([0, 1, P - 1, P, P + 1, W * P, 0, 7], np.int32)
    if packed:
        pool = (16 * rng.integers(-7, 8, (NP, 2, P, Dk))
                + rng.integers(-7, 8, (NP, 2, P, Dk))).astype(np.int8)
    elif kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
    x = {
        "q": rng.standard_normal((B, D)).astype(np.float32),
        "pool": pool, "lengths": lengths, "table": table,
        "k_new": rng.standard_normal((B, D)).astype(np.float32),
        "v_new": rng.standard_normal((B, D)).astype(np.float32),
        "ks": None, "vs": None,
    }
    if kv != "float32":
        qmax = 7.0 if packed else 127.0
        jl, jt = jnp.asarray(lengths), jnp.asarray(table)
        fresh = jax_fresh(jt, jnp.maximum(jl - 1, 0), jl > 0, P, NP)
        for side, new in (("ks", "k_new"), ("vs", "v_new")):
            s = (rng.random(NP) * 0.05 + 0.001).astype(np.float32)
            x[side] = np.asarray(jax_scales(jnp.asarray(s),
                                            jnp.asarray(x[new]), fresh,
                                            qmax=qmax))
    return x


def run_jax(x, H, packed, fused):
    def a(v):
        return None if v is None else jnp.asarray(v)

    extra = (a(x["k_new"]), a(x["v_new"])) if fused else ()
    out = jax_grouped(a(x["q"]), a(x["pool"]), a(x["lengths"]), a(x["table"]),
                      a(x["ks"]), a(x["vs"]), *extra, n_heads=H,
                      contiguous_pages=True, packed_int4=packed,
                      interpret=True)
    if fused:
        return np.asarray(out[0]), np.asarray(out[1])
    return np.asarray(out), x["pool"]


def run_torch(x, H, packed, fused, fn=paged_decode_attention_grouped,
              device="cpu"):
    def a(v):
        return None if v is None else torch.from_numpy(np.array(v)).to(device)

    pool = a(x["pool"])
    extra = (a(x["k_new"]), a(x["v_new"])) if fused else ()
    out = fn(a(x["q"]), pool, a(x["lengths"]), a(x["table"]), a(x["ks"]),
             a(x["vs"]), *extra, n_heads=H, packed_int4=packed)
    o = out[0] if fused else out
    return o.cpu().numpy(), pool.cpu().numpy()


@pytest.mark.parametrize("kv,H,fused", [
    (kv, H, True) for kv in ("float32", "int8", "int4") for H in (1, 2)
] + [("int4", 2, False)])   # mode (a): no insert
def test_plain_matches_jax_grouped_kernel(kv, H, fused):
    rng = np.random.default_rng(100 + 10 * H + len(kv))
    x = make_inputs(rng, kv, H)
    packed = kv == "int4"
    o_j, pool_j = run_jax(x, H, packed, fused)
    o_t, pool_t = run_torch(x, H, packed, fused)
    np.testing.assert_array_equal(pool_t, pool_j)
    np.testing.assert_allclose(o_t, o_j, rtol=1e-5, atol=1e-5)
    assert np.all(o_t[x["lengths"] == 0] == 0.0)
    if fused:   # the insert really happened (pool changed at len-1)
        assert not np.array_equal(pool_t, x["pool"])


def test_cpu_tensor_takes_plain_version():
    x = make_inputs(np.random.default_rng(7), "int8", 1)
    before = paged_decode_attention_grouped.launches
    o_w, pool_w = run_torch(x, 1, False, True)
    o_p, pool_p = run_torch(x, 1, False, True,
                            fn=paged_decode_attention_grouped_plain)
    np.testing.assert_array_equal(o_w, o_p)
    np.testing.assert_array_equal(pool_w, pool_p)
    assert paged_decode_attention_grouped.launches == before

