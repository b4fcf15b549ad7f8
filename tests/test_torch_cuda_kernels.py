"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; tests/conftest.py imports JAX, hence ``--noconftest``:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from min_llm_inference_tpu_torch.models.paged import decode_fresh_pid
from min_llm_inference_tpu_torch.ops.paged_attention_grouped import (
    paged_decode_attention_grouped,
    paged_decode_attention_grouped_plain,
)
from min_llm_inference_tpu_torch.ops.quant import kv_qmax, update_page_scales


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def grouped_inputs(rng, dev, kv, B, W, P, D, in_dtype):
    """Fused-write inputs: contiguous page groups, dead slots, page-boundary
    inserts, scales already updated for the fresh pages."""
    NG = B + 2
    NP = NG * W
    packed = kv == "int4"
    Dk = D // 2 if packed else D
    gids = rng.permutation(NG)[:B]
    table = (gids[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    lengths = rng.integers(0, W * P + 1, B).astype(np.int32)
    lengths[:6] = [0, 1, P - 1, P, P + 1, W * P]
    if packed:
        pool = (16 * rng.integers(-7, 8, (NP, 2, P, Dk))
                + rng.integers(-7, 8, (NP, 2, P, Dk))).astype(np.int8)
    elif kv == "int8":
        pool = rng.integers(-127, 128, (NP, 2, P, Dk)).astype(np.int8)
    else:
        pool = rng.standard_normal((NP, 2, P, Dk)).astype(np.float32)
    x = {k: torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
         .to(dev, in_dtype) for k in ("q", "k_new", "v_new")}
    x.update(pool=torch.from_numpy(pool).to(dev),
             lengths=torch.from_numpy(lengths).to(dev),
             table=torch.from_numpy(table).to(dev), ks=None, vs=None)
    if kv != "float32":
        live = x["lengths"] > 0
        pos = torch.clamp_min(x["lengths"] - 1, 0)
        fresh = decode_fresh_pid(x["table"], pos, live, P, NP)
        for side, new in (("ks", "k_new"), ("vs", "v_new")):
            s = torch.from_numpy(
                (rng.random(NP) * 0.05 + 0.001).astype(np.float32)).to(dev)
            x[side] = update_page_scales(s, x[new], fresh, kv_qmax(packed))
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "int8", "int4"])
@pytest.mark.parametrize("H,in_dtype", [(1, torch.bfloat16),
                                        (2, torch.float32)])
def test_grouped_kernel_matches_plain(cuda, kv, H, in_dtype):
    """Pool bytes bit-identical; o within 1e-5 * max(1, |o|) (float32 sums
    in another order); dead slots exactly zero; mode (a) too."""
    x = grouped_inputs(np.random.default_rng(9), cuda, kv, 64, 4, 16, 64,
                       in_dtype)
    kw = dict(n_heads=H, packed_int4=kv == "int4")
    rest = (x["lengths"], x["table"], x["ks"], x["vs"])
    pool_k, pool_p = x["pool"].clone(), x["pool"].clone()
    before = paged_decode_attention_grouped.launches
    o_k, _ = paged_decode_attention_grouped(x["q"], pool_k, *rest, x["k_new"],
                                            x["v_new"], **kw)
    o_p, _ = paged_decode_attention_grouped_plain(
        x["q"], pool_p, *rest, x["k_new"], x["v_new"], **kw)
    assert paged_decode_attention_grouped.launches == before + 1
    assert torch.equal(pool_k, pool_p)
    tol = 1e-5 * max(1.0, o_p.abs().max().item())
    assert (o_k - o_p).abs().max().item() <= tol
    assert torch.all(o_k[x["lengths"] == 0] == 0)
    o_a = paged_decode_attention_grouped(x["q"], pool_k, *rest, **kw)
    o_ap = paged_decode_attention_grouped_plain(x["q"], pool_k, *rest, **kw)
    assert (o_a - o_ap).abs().max().item() <= tol


@pytest.mark.cuda
def test_grouped_kernel_rejects_unsupported_pool(cuda):
    x = grouped_inputs(np.random.default_rng(3), cuda, "float32", 8, 2, 16,
                       32, torch.float32)
    with pytest.raises(ValueError):
        paged_decode_attention_grouped(
            x["q"], x["pool"].to(torch.bfloat16), x["lengths"], x["table"],
            k_new=x["k_new"], v_new=x["v_new"])
