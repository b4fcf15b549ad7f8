"""The causal prefill attention kernel (ops/prefill_attention.py,
csrc/prefill_attention.cu): its dispatch predicate and the plain path on
the CPU, and on the card the kernel against its plain version
(models/model.causal_masked_attention) and the engines that prefill
through it.

On the card the kernel's float32 output must match the plain version's
within 2e-5 of each (row, head)'s largest magnitude (only the order of the
float32 sums differs: bf16 products are exact in float32 and P is split
into three bf16 terms whose sum is exact), its bfloat16 output within one
bf16 ulp (taken at the element, floored at 1/256 of that scale, below
which the float32 difference of the summation order outweighs an ulp), on
rows below each prompt's length; rows at or past it are zeros.

The ``cuda`` tests skip without a GPU; the module imports no JAX (the one
CPU test that compares with the JAX package imports it inside), so on the
card:

    python -m pytest --noconftest -m cuda -q tests/test_torch_prefill_attention.py
"""

import numpy as np
import pytest
import torch

import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.models.model import (
    causal_masked_attention,
    prefill_write_kv,
)
from min_llm_inference_tpu_torch.ops import _build
from min_llm_inference_tpu_torch.ops import prefill_attention as pa
from min_llm_inference_tpu_torch.runtime import graph as tgraph

# lengths the kernel's tiles (64 rows, 64 keys, 8-key groups) have edges at
EDGE_LENGTHS = (0, 1, 31, 32, 33, 512, 896, 1024)
F32_RTOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def qkv_block(gen, dev, M, S, D, dtype=torch.bfloat16):
    """q [M, S, D] and k, v as the two column halves of one fused
    [M, S, 2D] projection, as prefill_write_kv hands them over."""
    q = torch.randn((M, S, D), generator=gen, device=dev).to(dtype)
    kv = torch.randn((M, S, 2 * D), generator=gen, device=dev).to(dtype)
    return q, kv[..., :D], kv[..., D:]


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_heads", [1, 2])
def test_wrapper_on_cpu_is_the_plain_version(dtype, n_heads):
    """On the CPU the predicate leaves the attention to the plain version;
    the wrapper itself takes CUDA tensors only and raises here, with no
    launch counted."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = qkv_block(gen, "cpu", 4, 37, 32, dtype)
    lengths = torch.tensor([37, 0, 1, 20], dtype=torch.int32)
    assert not pa.kernel_takes(q.device, dtype, 32 // n_heads)
    before = pa.prefill_causal_attention.launches
    with pytest.raises(ValueError, match="the kernel takes"):
        pa.prefill_causal_attention(q, k, v, lengths, n_heads)
    with pytest.raises(ValueError, match="the kernel takes"):
        pa.prefill_causal_attention(q, k, v, lengths, n_heads,
                                    out=torch.zeros((4, 37, 32)))
    assert pa.prefill_causal_attention.launches == before


def test_wrapper_rejects_mismatched_shapes():
    q = torch.zeros((2, 8, 32))
    with pytest.raises(ValueError):
        pa.prefill_causal_attention(q, q[:, :4], q, torch.zeros(2), 2)
    with pytest.raises(ValueError):
        pa.prefill_causal_attention(q, q, q, torch.zeros(2), 3)


@pytest.mark.parametrize("device,dtype,head_dim,takes", [
    *[("cuda", torch.bfloat16, dh, True) for dh in range(16, 129, 16)],
    ("cuda", torch.bfloat16, 8, False), ("cuda", torch.bfloat16, 24, False),
    ("cuda", torch.bfloat16, 72, False), ("cuda", torch.bfloat16, 144, False),
    ("cuda", torch.float32, 64, False), ("cuda", torch.float16, 64, False),
    ("cpu", torch.bfloat16, 64, False), ("meta", torch.bfloat16, 64, False),
])
def test_kernel_takes(device, dtype, head_dim, takes):
    assert pa.kernel_takes(torch.device(device), dtype, head_dim) is takes


def test_prefill_write_kv_picks_by_the_predicate(monkeypatch):
    """The attending layers (all but the last) go to the wrapper exactly
    where the predicate holds; the K/V rows written are the plain path's."""
    model = T.ModelConfig(n_vocab=64, emb_dim=32, n_seq=16, n_layers=3,
                          n_heads=2, ffn_dim=64, use_output_proj=True,
                          use_layernorm=True, eof_token_id=63)
    params = T.init_params(0, model, device="cpu")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, 63, (3, 16)).astype(np.int32))
    plens = torch.tensor([16, 5, 0], dtype=torch.int32)
    calls = []

    def spy(*args):     # the kernel's stand-in: its plain version
        calls.append(args[-1])
        return causal_masked_attention(*args)

    monkeypatch.setattr(pa, "prefill_causal_attention", spy)
    rows = {}
    for takes in (False, True):
        monkeypatch.setattr(pa, "kernel_takes", lambda *a, t=takes: t)
        calls.clear()
        written = []
        prefill_write_kv(params, model, prompts, plens,
                         lambda li, k, v: written.append((k, v)))
        rows[takes] = written
        assert calls == ([2] * (model.n_layers - 1) if takes else [])
    for (k0, v0), (k1, v1) in zip(rows[False], rows[True]):
        assert torch.equal(k0, k1) and torch.equal(v0, v1)


def test_prefill_write_kv_through_the_wrapper_matches_jax():
    """prefill_write_kv on the CPU, where the predicate refuses the kernel
    and no launch is made, writes the K/V rows of the JAX package's
    prefill_write_kv, on valid positions, within float32 summation order
    (rtol 1e-5, atol 1e-6: tests/test_torch_ops.py's attention tolerance).
    The kernel is held to the plain version on the card (below)."""
    import jax
    import jax.numpy as jnp

    from min_llm_inference_tpu import ModelConfig as JModelConfig
    from min_llm_inference_tpu import init_params as jinit
    from min_llm_inference_tpu.models.model import (
        prefill_write_kv as jprefill,
    )

    kw = dict(n_vocab=64, emb_dim=32, n_seq=24, n_layers=3, n_heads=2,
              ffn_dim=64, use_output_proj=True, use_layernorm=True,
              eof_token_id=63)
    jparams = jinit(jax.random.PRNGKey(1), JModelConfig(**kw), eof_bias=0.05)
    model = T.ModelConfig(**kw)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 model, device="cpu")
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 63, (4, 24)).astype(np.int32)
    plens = np.array([24, 9, 1, 0], np.int32)
    jrows = []
    jprefill(jparams, JModelConfig(**kw), jnp.asarray(prompts),
             jnp.asarray(plens),
             lambda li, k, v: jrows.append((np.asarray(k), np.asarray(v))))
    before = pa.prefill_causal_attention.launches
    trows = []
    prefill_write_kv(params, model, torch.from_numpy(prompts),
                     torch.from_numpy(plens),
                     lambda li, k, v: trows.append((k, v)))
    assert pa.prefill_causal_attention.launches == before
    assert len(trows) == len(jrows) == kw["n_layers"]
    for (tk, tv), (jk, jv) in zip(trows, jrows):
        for m, n in enumerate(plens):
            np.testing.assert_allclose(tk[m, :n].numpy(), jk[m, :n],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tv[m, :n].numpy(), jv[m, :n],
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- card


def bf16_ulp(x):
    """One bfloat16 ulp at each |x| (x > 0, float32)."""
    _, exp = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), exp - 8)


def check_against_plain(q, k, v, lengths, H):
    """The kernel's float32 and bfloat16 outputs against the plain version
    on valid rows (module docstring), zeros on the others."""
    M, S, D = q.shape
    got32 = pa.prefill_causal_attention(
        q, k, v, lengths, H, out=torch.empty((M, S, D), device=q.device))
    got16 = pa.prefill_causal_attention(q, k, v, lengths, H)
    assert got16.dtype == torch.bfloat16
    want32 = causal_masked_attention(q.float(), k.float(), v.float(),
                                     lengths, H)
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths[:, None].long())
    for got in (got32, got16):
        assert torch.all(got[~valid] == 0), "rows past the length not zero"
    heads = (M, S, H, D // H)
    want = want32.reshape(heads)[valid]
    scale = want.abs().amax(dim=-1, keepdim=True)
    assert torch.all(scale > 0)
    rel = ((got32.reshape(heads)[valid] - want).abs() / scale).max().item()
    assert rel <= F32_RTOL, f"float32 output off by {rel:.3g} of its scale"
    w16 = want.to(torch.bfloat16).float()
    g16 = got16.reshape(heads)[valid].float()
    ulp = bf16_ulp(torch.maximum(w16.abs(), scale / 256))
    assert torch.all((g16 - w16).abs() <= ulp), "bfloat16 output off by > 1 ulp"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lengths", [
    # the gpt2-small long-prompt cell's prefill block: the edges, then
    # prompts of 512-896 as its traffic draws them
    ((64, 1024, 12, 64), EDGE_LENGTHS),
    ((8, 1024, 2, 64), EDGE_LENGTHS),
    # S not a multiple of the 64-row tile; every head dim the kernel takes
    *[((4, 100, 2, dh), (100, 65, 33, 0)) for dh in range(16, 129, 16)],
])
def test_kernel_matches_plain(cuda, shape, lengths):
    M, S, H, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(M * 1000 + dh)
    q, k, v = qkv_block(gen, cuda, M, S, H * dh)
    assert k.stride(1) == 2 * H * dh        # strided views, no copy
    lens = np.random.default_rng(M).integers(512, 897, M)
    lens[:len(lengths)] = lengths
    lengths = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    before = pa.prefill_causal_attention.launches
    check_against_plain(q, k, v, lengths, H)
    torch.cuda.synchronize()
    assert pa.prefill_causal_attention.launches == before + 2


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 64, 128), device=cuda, dtype=torch.bfloat16)
    lengths = torch.full((2,), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):     # head dim 8
        pa.prefill_causal_attention(q, q, q, lengths, 16)
    with pytest.raises(ValueError):     # float32 inputs
        pa.prefill_causal_attention(q.float(), q.float(), q.float(),
                                    lengths, 2)
    with pytest.raises(ValueError):     # int64 lengths
        pa.prefill_causal_attention(q, q, q, lengths.long(), 2)


@pytest.mark.cuda
def test_kernel_in_a_captured_if_node_counts_on_the_device(cuda):
    """One launch recorded inside a graph's IF node (as the prefill bucket's
    device_switch records it) is counted on the device at each replay that
    takes the branch, and writes what the eager launch wrote."""
    M, S, H, dh = 4, 256, 12, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = qkv_block(gen, cuda, M, S, H * dh)
    lengths = torch.tensor([256, 200, 7, 0], dtype=torch.int32, device=cuda)
    want = pa.prefill_causal_attention(q, k, v, lengths, H)
    out = torch.zeros_like(want)
    pred = torch.ones((), dtype=torch.bool, device=cuda)
    counts = torch.zeros(_build.MAX_COUNTED, dtype=torch.int64, device=cuda)
    idx = pa.prefill_causal_attention.count_index

    def body():
        pa.prefill_causal_attention(q, k, v, lengths, H, out=out)

    launches = pa.prefill_causal_attention.launches
    cap = tgraph.capture(lambda: tgraph.device_if(pred, body), cuda,
                         launch_counts=counts)
    assert pa.prefill_causal_attention.launches == launches
    cap.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert counts[idx].item() == 1 and counts.sum().item() == 1
    out.zero_()
    pred.fill_(False)
    cap.replay()
    torch.cuda.synchronize()
    assert torch.all(out == 0) and counts[idx].item() == 1
    _build.add_device_counts(counts.tolist())
    assert pa.prefill_causal_attention.launches == launches + 1


@pytest.mark.cuda
def test_kernel_takes_a_strided_lengths_column(cuda):
    """Lengths read as a column of one uploaded int32 block, as the host
    engines' _run_prefill hands them over (prompts, lengths and slot
    arguments in one row a prompt): the same output as contiguous
    lengths."""
    M, S, H, dh = 8, 192, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = qkv_block(gen, cuda, M, S, H * dh)
    lens = torch.tensor([192, 0, 1, 65, 100, 7, 130, 64], dtype=torch.int32)
    block = torch.zeros((M, S + 3), dtype=torch.int32)
    block[:, S] = lens
    column = block.to(cuda)[:, S]
    assert column.stride(0) == S + 3 and not column.is_contiguous()
    want = pa.prefill_causal_attention(q, k, v, lens.to(cuda), H)
    got = pa.prefill_causal_attention(q, k, v, column, H)
    assert torch.equal(got, want)


def _params_in(params, dtype):
    """A copy of params with every tensor cast to dtype."""
    if isinstance(params, dict):
        return {n: _params_in(x, dtype) for n, x in params.items()}
    if isinstance(params, list):
        return [_params_in(x, dtype) for x in params]
    return params.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("host", ["PagedEngine", "NativePagedEngine",
                                  "DenseEngine"])
def test_host_engines_prefill_through_the_kernel(cuda, host):
    """A bfloat16 model of three layers and head dim 64 on the card: a host
    engine (its prefill lengths a column of one uploaded block) and the
    AutonomousEngine (a CUDA graph a burst) both prefill through the
    kernel, one launch per attending layer and prefill block of a run
    (the second, past the warm burst), and give the same tokens. A request may differ only where its first differing token
    is a near-tie: the top-2 gap of the plain bfloat16 forward below the
    largest logit change that bfloat16 makes against float32 there (the
    decode paths sum in other orders), at most a quarter of them."""
    import dataclasses

    from min_llm_inference_tpu_torch.tools.fuzz_draws import (
        check_finished,
        plain_logits,
    )

    model = T.ModelConfig(n_vocab=256, emb_dim=256, n_seq=96, n_layers=3,
                          n_heads=4, ffn_dim=512, use_output_proj=True,
                          use_layernorm=True, eof_token_id=255,
                          dtype="bfloat16")
    cfg = T.EngineConfig(n_slots=16, page_size=16, n_pages=128,
                         n_forward_rounds=4, kv_dtype="bfloat16",
                         max_prefill_batch=8)
    params = T.init_params(7, model, eof_bias=0.05, device=cuda)
    rng = np.random.default_rng(7)
    # prompts of 40-88 tokens: several blocks of key tiles, and at most 56
    # decode steps a request
    prompts = [rng.integers(0, 255, int(rng.integers(40, 89))).tolist()
               for _ in range(24)]
    attending = model.n_layers - 1

    def tokens_of(eng):
        for _ in range(2):  # the second run has no warm burst to count
            store = T.ItemStorage()
            for i, p in enumerate(prompts):
                store.add_new_item(T.Request(i, list(p)))
            before = pa.prefill_causal_attention.launches
            kept = getattr(eng, "stats", None)
            p0 = 0 if kept is None else kept.prefills
            eng.run(store)
        # AutonomousEngine's stats run on across runs, a host engine's
        # start anew with each
        prefills = eng.stats.prefills - (p0 if eng.stats is kept else 0)
        assert prefills > 0
        assert (pa.prefill_causal_attention.launches - before
                == prefills * attending)
        got = [store.finished[i].tokens for i in range(len(prompts))]
        check_finished(got, prompts, model.n_seq, model.eof_token_id)
        return got

    want = tokens_of(T.AutonomousEngine(params, model, cfg, device=cuda))
    kw = {} if host == "DenseEngine" else {"attention_impl": "paged"}
    got = tokens_of(getattr(T, host)(params, model, cfg, device=cuda, **kw))
    differ = [i for i in range(len(prompts)) if got[i] != want[i]]
    assert len(differ) <= len(prompts) // 4, f"requests {differ} differ"
    model32 = dataclasses.replace(model, dtype="float32")
    params32 = _params_in(params, torch.float32)
    for i in differ:
        j = next(k for k, (a, b) in enumerate(zip(got[i], want[i]))
                 if a != b)
        logits = plain_logits(params, model, want[i][:j], "bfloat16",
                              cfg.page_size).float()
        exact = plain_logits(params32, model32, want[i][:j])
        top = torch.topk(logits, 2).values
        gap, noise = float(top[0] - top[1]), float((logits - exact).abs().max())
        assert gap < noise, (f"request {i} token {j}: {got[i][j]} vs "
                             f"{want[i][j]}, top-2 gap {gap} not below the "
                             f"noise {noise}")
