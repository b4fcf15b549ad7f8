"""DeepSeek-V2 on the port (models/deepseek_v2.py) against its plain float32
reference (models/deepseek_v2_ref.py), at a tiny size on the CPU; and, on
a card (``cuda`` tests), the latent decode kernel, the prefill kernel at
192 / 128 and the grouped expert product against their plain versions.

The tiny model: 3 layers (the first dense), hidden 64, 4 heads, latent 32,
rope 16, nope 16, v 16, 8 routed experts (2 a token) and 2 shared, float32.
Weights are N(0, 0.2), so that the logits spread and a served token is the
reference's argmax by a clear margin.
"""

import ast
import inspect
import math

import numpy as np
import pytest
import torch

import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.config import EngineConfig, ModelConfig
from min_llm_inference_tpu_torch.models import deepseek_v2 as ds
from min_llm_inference_tpu_torch.models import deepseek_v2_ref as ref
from min_llm_inference_tpu_torch.models.paged import (
    init_paged_state,
    make_latent_prefill_writer,
    make_latent_round_callbacks,
)
from min_llm_inference_tpu_torch.ops import mla_decode, moe
from min_llm_inference_tpu_torch.ops import prefill_attention as pa
from min_llm_inference_tpu_torch.ops.reference import greedy_next_token
from min_llm_inference_tpu_torch.runtime.autonomous import prompt_bucket

TINY = ModelConfig(
    arch="deepseek_v2", n_vocab=97, emb_dim=64, n_seq=48, n_layers=3,
    n_heads=4, ffn_dim=96, dtype="float32", eof_token_id=96,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
    n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=24,
    n_shared_experts=2,
    rope_scaling=dict(type="yarn", factor=40,
                      original_max_position_embeddings=16, beta_fast=32,
                      beta_slow=1, mscale=0.707, mscale_all_dim=0.707))
ENGINE = EngineConfig(n_slots=4, n_forward_rounds=4, page_size=8, n_pages=24,
                      kv_dtype="float32", decode_ring=False,
                      max_prefill_batch=4)
PUBLISHED = ModelConfig(arch="deepseek_v2", n_vocab=102400, emb_dim=2048,
                        n_seq=4096, n_layers=27, n_heads=16, ffn_dim=10944,
                        dtype="bfloat16", eof_token_id=100001)
# float32 logits of the absorbed, paged path against the reference's full
# forward pass: the two sum the same products in other orders (latent
# attention absorbed or not, experts grouped or per token), ~1e-6 of the
# logits' scale of ~1
LOGIT_ATOL = 1e-4


def cfg_map(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


@pytest.fixture(scope="module")
def params():
    return ds.init_params(TINY, 0, "cpu", std=0.2)


def prompts_for(seed, n, lo=2, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.eof_token_id, int(rng.integers(lo, hi)))
            .tolist() for _ in range(n)]


def gaps(params, prompt, served):
    """The reference's gap of each served token below its best, in
    standard deviations of the position's logits."""
    seq = torch.tensor(list(prompt) + list(served[:-1]))
    lg = ref.forward(cfg_map(TINY), params, seq, first=len(prompt) - 1)
    got = torch.tensor(served)
    best = lg.max(-1).values
    return (best - lg.gather(1, got[:, None])[:, 0]) / lg.std(-1)


# ------------------------------------------------------------ YaRN, config

def test_yarn_at_the_published_settings():
    """inv_freq, the ramp's ends and the score scale at DeepSeek-V2-Lite's
    rope settings, from the formulas of the published YaRN code."""
    cm = cfg_map(PUBLISHED)
    assert ref.yarn_range(cm) == (10, 23)
    lo = 64 * math.log(4096 / (32 * 2 * math.pi)) / (2 * math.log(10000))
    hi = 64 * math.log(4096 / (1 * 2 * math.pi)) / (2 * math.log(10000))
    assert (math.floor(lo), math.ceil(hi)) == (10, 23)
    assert abs(lo - 10.47) < 0.01 and abs(hi - 22.51) < 0.01
    i = np.arange(32)
    extra = 10000.0 ** (-2 * i / 64)
    ramp = np.clip((i - 10) / 13, 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    np.testing.assert_allclose(ref.yarn_inv_freq(cm).numpy(), want,
                               rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m - 1.26080) < 1e-5
    assert abs(ref.softmax_scale(cm) - 192 ** -0.5 * m * m) < 1e-12
    assert abs(ref.softmax_scale(cm) - 0.114721) < 1e-6
    cos, sin = ref.rope_cos_sin(cm, torch.arange(5))
    ang = np.arange(5)[:, None] * want[None, :]
    np.testing.assert_allclose(cos.numpy(), np.cos(ang), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.sin(ang), atol=1e-6)


def test_config_builds_by_arch_and_keeps_jax_fields():
    """ModelConfig(arch=...) builds the architecture's config; a config
    without it has the JAX package's fields only."""
    assert type(PUBLISHED).__name__ == "DeepSeekV2Config"
    assert PUBLISHED.head_dim == 192 and PUBLISHED.latent_dim == 576
    assert type(ModelConfig(**vars(PUBLISHED) | {})) is type(PUBLISHED)
    assert not ModelConfig().is_mla
    assert "arch" not in ModelConfig.__dataclass_fields__
    with pytest.raises(ValueError, match="unknown model arch"):
        ModelConfig(arch="nope")
    with pytest.raises(AssertionError, match="latent"):
        EngineConfig(kv_dtype="int8", decode_ring=False).validate(TINY)
    with pytest.raises(AssertionError, match="ring"):
        EngineConfig(kv_dtype="float32").validate(TINY)


def test_published_parameter_count():
    """15,706,357,760 weights in the matrices at DeepSeek-V2-Lite's widths
    (31.41 GB in bfloat16); the norm gains are 126,464 more."""
    n = sum(math.prod(s) for _, _, s in ds.shapes(PUBLISHED))
    assert n == 15_706_357_760
    tiny = ds.init_params(TINY, 0, "cpu")
    gains = sum(w.numel() for layer in tiny["layers"]
                for name, w in layer.items() if name.endswith("_g"))
    assert gains == TINY.n_layers * (2 * 64 + 32)


# ------------------------------------------------------------- the pieces

def test_absorbed_decode_matches_non_absorbed(params):
    """The absorbed latent attention of the last position (q_nope through
    W_UK against c_kv, q_pe against k_pe, o_lat through W_UV) equals the
    reference's per-head attention over full keys and values."""
    cm = cfg_map(TINY)
    pp = ds.prepare_params(params, TINY)
    T_ = 21
    x = torch.randn(T_, TINY.emb_dim,
                    generator=torch.Generator().manual_seed(1))
    layer = pp["layers"][1]
    cos, sin = ref.rope_cos_sin(cm, torch.arange(T_))
    want = ref.mla(cm, x, ref.layer_f32(params["layers"][1]), cos, sin)[-1]
    rows = ds.latent_row(layer, TINY, x, pp["rope_cos"][:T_],
                         pp["rope_sin"][:T_])                   # [T, Dl]
    q = ds.queries(layer, TINY, x[-1:], pp["rope_cos"][T_ - 1:T_],
                   pp["rope_sin"][T_ - 1:T_])                   # [1, H, dk]
    dn = TINY.qk_nope_head_dim
    q_lat = torch.bmm(q[..., :dn].transpose(0, 1), layer["w_uk_t"])
    qa = torch.cat([q_lat.transpose(0, 1), q[..., dn:]], dim=-1)
    pool = torch.zeros(4, 8, TINY.latent_dim)
    pool.view(-1, TINY.latent_dim)[:T_] = rows
    o_lat = mla_decode.mla_decode_attention(
        qa, pool, torch.tensor([T_], dtype=torch.int32),
        torch.arange(4, dtype=torch.int32)[None], pp["mla_scale"],
        TINY.kv_lora_rank)
    o = torch.bmm(o_lat.transpose(0, 1), layer["w_uv"]).transpose(0, 1)
    got = o.reshape(1, -1) @ layer["wo"]
    torch.testing.assert_close(got[0], want, atol=1e-5, rtol=1e-5)


def test_plain_mla_decode_dead_and_ragged():
    """The plain decode attention: dead slots read zeros, a slot reads
    only its own positions below its length."""
    g = torch.Generator().manual_seed(2)
    pool = torch.randn(12, 4, 10, generator=g)
    q = torch.randn(3, 2, 10, generator=g)
    table = torch.tensor([[0, 1, 2], [5, 6, 7], [9, 10, 11]],
                         dtype=torch.int32)
    lens = torch.tensor([9, 0, 3], dtype=torch.int32)
    out = mla_decode.plain_mla_decode(q, pool, lens, table, 0.5, 6)
    assert torch.equal(out[1], torch.zeros(2, 6))
    rows = pool[9][:3]
    p = torch.softmax(0.5 * q[2] @ rows.t(), dim=-1)
    torch.testing.assert_close(out[2], p @ rows[:, :6])


def per_token_experts(x, w, idx, w_gate_up, w_down):
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            y = ds.swiglu(x[t:t + 1], w_gate_up[e], w_down[e])[0]
            out[t] += w[t, j] * y
    return out


def test_expert_layer_matches_a_per_token_loop():
    """The dispatch (sort by expert, offsets), the grouped SwiGLU and the
    float32 combine against a loop over each token's experts; experts 2
    and 5 tie in the gate (equal router columns and equal weights), so
    whichever the top-k takes gives the same rows; the counters add the
    call's rows and its busiest expert's."""
    g = torch.Generator().manual_seed(3)
    T_, D, E, Fm, k = 37, 16, 8, 12, 3
    x = torch.randn(T_, D, generator=g)
    w_router = torch.randn(D, E, generator=g)
    w_router[:, 5] = w_router[:, 2]
    w_gate_up = torch.randn(E, D, 2 * Fm, generator=g) * 0.3
    w_down = torch.randn(E, Fm, D, generator=g) * 0.3
    w_gate_up[5], w_down[5] = w_gate_up[2], w_down[2]
    counts = torch.zeros(2, dtype=torch.int64)
    got = moe.routed_experts(x, w_router, w_gate_up, w_down, k,
                             counts=counts)
    w, idx = moe.route(x, w_router, k)
    assert ((idx == 2).any(-1) & (idx == 5).any(-1)).any(), "no tie taken"
    want = per_token_experts(x, w, idx, w_gate_up, w_down)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert counts[0] == T_ * k
    assert counts[1] == torch.bincount(idx.reshape(-1), minlength=E).max()
    scores = torch.softmax(x @ w_router, dim=-1)
    torch.testing.assert_close(w.sum(-1), scores.topk(k).values.sum(-1))


def test_prefill_kernel_widths_and_predicate():
    """The prefill kernel takes (d, d) for d = 16..128 and (192, 128),
    on CUDA bfloat16 only; the plain attention at 192 / 128 masks by
    length and causality."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert pa.kernel_takes(cuda, torch.bfloat16, 192, 128)
    assert pa.kernel_takes(cuda, torch.bfloat16, 64)
    assert not pa.kernel_takes(cuda, torch.bfloat16, 192)
    assert not pa.kernel_takes(cuda, torch.bfloat16, 128, 192)
    assert not pa.kernel_takes(cpu, torch.bfloat16, 192, 128)
    g = torch.Generator().manual_seed(4)
    q, k = torch.randn(2, 6, 2 * 12, generator=g), torch.randn(2, 6, 24,
                                                               generator=g)
    v = torch.randn(2, 6, 2 * 8, generator=g)
    lens = torch.tensor([6, 3], dtype=torch.int32)
    out = ds.causal_attention(q, k, v, lens, 2, 0.3)
    i = 4
    s = 0.3 * q[0, i, 12:] @ k[0, :i + 1, 12:].t()
    torch.testing.assert_close(out[0, i, 8:],
                               torch.softmax(s, -1) @ v[0, :i + 1, 8:])
    s = 0.3 * q[1, 5, :12] @ k[1, :3, :12].t()
    torch.testing.assert_close(out[1, 5, :8],
                               torch.softmax(s, -1) @ v[1, :3, :8])


# ------------------------------------------------ the paged path, engines

def test_prefill_then_decode_matches_the_reference_logits(params):
    """A prompt block prefilled into the latent pool, then decode rounds
    through it: every round's float32 logits equal the reference's full
    forward pass at that position (LOGIT_ATOL: summation order only)."""
    pp = ds.prepare_params(params, TINY)
    P, NP, W = 8, 24, 6
    state = init_paged_state(TINY, ENGINE, "cpu")
    pools = list(state.kv_pages)
    prompts = prompts_for(5, 3, 5, 17)
    S = 16
    block = torch.zeros(3, S, dtype=torch.int32)
    for i, p in enumerate(prompts):
        block[i, :len(p)] = torch.tensor(p)
    plens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    table = torch.arange(3 * W, dtype=torch.int32).view(3, W)
    write, _ = make_latent_prefill_writer(state, table, plens, S, P, NP)
    ds.prefill_write_kv(pp, TINY, block, plens, write)
    lengths = plens.clone()
    last = torch.tensor([p[-1] for p in prompts], dtype=torch.int32)
    seqs = [list(p) for p in prompts]
    for _ in range(6):
        write_kv, attend = make_latent_round_callbacks(
            table, pools, lengths, P, NP, pp["mla_scale"], TINY.kv_lora_rank)
        got = {}

        def keep(logits, lens):
            got["logits"] = logits
            return greedy_next_token(
                logits, lens, TINY.n_seq, TINY.eof_token_id)

        tok, lengths = ds.decode_round_tokens(pp, TINY, lengths, last,
                                              write_kv, attend,
                                              next_token_fn=keep)
        for i, s in enumerate(seqs):
            want = ref.forward(cfg_map(TINY), params, torch.tensor(s),
                               first=len(s) - 1)[0]
            torch.testing.assert_close(got["logits"][i], want,
                                       atol=LOGIT_ATOL, rtol=0)
            s.append(int(tok[i]))
        last = tok


def run_engine(params, prompts, **kw):
    eng = T.AutonomousEngine(params, TINY, ENGINE, device="cpu",
                             max_new_per_burst=4, **kw)
    st = T.ItemStorage()
    for i, p in enumerate(prompts):
        st.add_new_item(T.Request(i, list(p)))
    eng.run(st)
    return eng, [st.finished[i].tokens[len(p):] for i, p in
                 enumerate(prompts)]


def check_served(params, prompts, served):
    """Each served token is the reference's argmax, or within 1e-4
    standard deviations of it (a near-tie, which float32 summation order
    may flip); lengths follow the cap and the EOF rule."""
    for p, s in zip(prompts, served):
        assert len(s) > 0
        assert len(p) + len(s) == TINY.n_seq or s[-1] == TINY.eof_token_id
        assert float(gaps(params, p, s).max()) <= 1e-4


def test_engine_serves_the_reference_argmax(params):
    """AutonomousEngine.run on 7 requests over 4 slots (slots turn over,
    the drain downshift runs): served tokens are the reference's argmax;
    the expert counters hold every routed row of prefill and decode."""
    prompts = prompts_for(0, 7)
    eng, served = run_engine(params, prompts, min_drain_slots=2)
    check_served(params, prompts, served)
    st = eng.stats
    k = TINY.num_experts_per_tok
    n_moe = TINY.n_layers - TINY.first_k_dense_replace
    s_pre = prompt_bucket(
        [T.Request(0, p) for p in prompts], TINY.n_seq)
    # decode: every slot-round through every expert layer; prefill: every
    # row of each 4-row block through the expert layers but the last
    # layer's
    assert st.expert_rows == (st.slot_rounds * n_moe * k
                              + st.prefills * 4 * s_pre * (n_moe - 1) * k)
    assert 0 < st.expert_rows_max < st.expert_rows


def test_streaming_session_serves_the_reference_argmax(params):
    """StreamingSession on the same burst: submit in two waves, step,
    poll and close; the tokens are the reference's argmax."""
    prompts = prompts_for(1, 6)
    eng = T.AutonomousEngine(params, TINY, ENGINE, device="cpu",
                             max_new_per_burst=4, bursts_per_chunk=2)
    sess = T.StreamingSession(eng, capacity=8, max_prompt_len=20)
    reqs = [T.Request(i, list(p)) for i, p in enumerate(prompts)]
    sess.submit(reqs[:3])
    sess.step()
    sess.submit(reqs[3:])
    done = {}
    for _ in range(200):
        sess.step()
        for r in sess.poll():
            done[r.id] = r.tokens
        if len(done) == len(prompts):
            break
    for r in sess.close():
        done[r.id] = r.tokens
    served = [done[i][len(p):] for i, p in enumerate(prompts)]
    check_served(params, prompts, served)
    _, one_shot = run_engine(params, prompts)
    assert served == one_shot


def test_sampled_decoding_runs_on_the_latent_path(params):
    """temperature > 0 draws through the same round (two equal seeds, equal
    tokens)."""
    prompts = prompts_for(2, 4)
    runs = [run_engine(params, prompts, temperature=1.5, top_k=8,
                       sample_seed=7)[1] for _ in range(2)]
    assert runs[0] == runs[1]


def test_attention_impl_must_match_the_model(params):
    """The model's ``is_mla`` chooses the latent path; an attention_impl
    of the K/V pools other than the default is refused for it."""
    with pytest.raises(ValueError, match="latent-attention model"):
        T.AutonomousEngine(params, TINY, ENGINE, attention_impl="torch",
                           device="cpu")


@pytest.mark.parametrize("engine", ["PagedEngine", "NativePagedEngine",
                                    "DenseEngine", "ShardedPagedEngine",
                                    "ShardedNativePagedEngine",
                                    "ShardedAutonomousEngine"])
def test_engines_without_latent_attention_refuse_it(params, engine):
    """The host engines and the dp x tp mesh engines raise a clear error
    for a latent-attention model instead of serving it wrong."""
    cls = getattr(T, engine)
    kw = {} if engine.startswith("Sharded") else {"device": "cpu"}
    with pytest.raises(ValueError, match="runs on AutonomousEngine"):
        cls(params, TINY, ENGINE, **kw)


def test_reference_imports_torch_and_math_only():
    """The plain reference stands alone: no kernel of the port, nothing of
    ops/ or csrc/, no JAX."""
    tree = ast.parse(inspect.getsource(ref))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import"
            names.add(node.module)
    assert names <= {"__future__", "math", "torch"}, names


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_err(got, want):
    """Largest error over each row's largest magnitude."""
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float(((got.float() - want.float()).abs() / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,dead", [(256, 128, 32), (5, 7, 2), (1, 1, 0)])
def test_mla_kernel_matches_plain(cuda, B, W, dead):
    """The absorbed decode kernel at 16 x 576 on a random bf16 pool: live
    slots with ragged lengths (1 .. W P, across split and page edges) and
    dead slots whose table rows are stale copies of live ones: within
    2^-7 of each row's largest value (bf16 output, one rounding), dead
    rows exactly zero."""
    P = 32
    g = torch.Generator(device=cuda).manual_seed(B)
    NP = B * W + 3
    pool = torch.randn(NP, P, 576, generator=g, device=cuda).to(torch.bfloat16)
    q = (torch.randn(B, 16, 576, generator=g, device=cuda) * 0.3).to(
        torch.bfloat16)
    rng = np.random.default_rng(B)
    perm = rng.permutation(NP - 3)[:B * W].reshape(B, W)
    table = torch.from_numpy(perm.astype(np.int32)).to(cuda)
    lens = rng.integers(1, W * P + 1, B)
    lens[:min(B, 3)] = [W * P, 1, 33][:min(B, 3)]
    lens[B - dead:] = 0 if dead else lens[B - dead:]
    for d in range(B - dead, B):
        table[d] = table[0]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    before = mla_decode.mla_decode_attention.launches
    got = mla_decode.mla_decode_attention(q, pool, lengths, table, 0.114721)
    torch.cuda.synchronize()
    assert mla_decode.mla_decode_attention.launches == before + 1
    want = mla_decode.plain_mla_decode(q, pool, lengths, table, 0.114721,
                                       512).float()
    live = lengths > 0
    assert rel_err(got[live], want[live]) <= 2 ** -7
    assert torch.all(got[~live] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,S,lens", [(2, 4096, (4096, 3600)),
                                      (3, 200, (200, 77, 0))])
def test_prefill_kernel_at_192_128_matches_plain(cuda, M, S, lens):
    """The causal prefill kernel at latent attention's widths (q . k 192,
    v 128, 16 heads, v a column slice of a wider projection): float32
    output within F32_RTOL of each row's scale of the plain float32
    attention over the same bf16 inputs, bf16 output within 2^-7; rows
    past a length zero. F32_RTOL is the 64/64 tests' 2e-5 up to 1024 keys,
    and 5e-5 over 4096 (float32 sums of four times the terms, in another
    order than the plain version's: 2.47e-5 on the card)."""
    f32_rtol = 2e-5 if S <= 1024 else 5e-5
    g = torch.Generator(device=cuda).manual_seed(S)
    H = 16
    q = torch.randn(M, S, H * 192, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(M, S, H * 192, generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn(M, S, H * 256, generator=g, device=cuda).to(
        torch.bfloat16)
    v = kv[..., H * 128:]
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    want = ds.causal_attention(q.float(), k.float(), v.float(), lengths, H,
                               0.114721)
    out32 = torch.empty(M, S, H * 128, device=cuda)
    pa.prefill_causal_attention(q, k, v, lengths, H, out=out32,
                                scale=0.114721)
    out16 = pa.prefill_causal_attention(q, k, v, lengths, H, scale=0.114721)
    torch.cuda.synchronize()
    for m, n in enumerate(lens):
        if n:
            w = want[m, :n].unflatten(-1, (H, 128))
            assert rel_err(out32[m, :n].unflatten(-1, (H, 128)), w) <= f32_rtol
            assert rel_err(out16[m, :n].unflatten(-1, (H, 128)), w) <= 2 ** -7
        assert torch.all(out32[m, n:] == 0)


@pytest.mark.cuda
def test_grouped_swiglu_matches_a_loop_over_experts(cuda):
    """The grouped SwiGLU (two grouped products) at DeepSeek-V2-Lite's
    expert widths on a decode round's 256 x 6 rows, some experts empty,
    against a loop of per-expert products: within 2^-6 of each row's
    scale (bf16 products, another summation order and rounding point)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    E, D, Fm, N = 64, 2048, 1408, 256 * 6
    w_gate_up = (torch.randn(E, D, 2 * Fm, generator=g, device=cuda)
                 * 0.02).to(torch.bfloat16)
    w_down = (torch.randn(E, Fm, D, generator=g, device=cuda) * 0.02).to(
        torch.bfloat16)
    xs = torch.randn(N, D, generator=g, device=cuda).to(torch.bfloat16)
    rng = np.random.default_rng(9)
    experts = np.sort(rng.choice(np.arange(E)[::2], N))   # odd ones empty
    ends = torch.from_numpy(np.searchsorted(experts, np.arange(1, E + 1))
                            .astype(np.int32)).to(cuda)
    got = moe.grouped_swiglu(xs, ends, w_gate_up, w_down)
    want = torch.empty_like(got)
    start = 0
    for e, end in enumerate(ends.tolist()):
        want[start:end] = ds.swiglu(xs[start:end], w_gate_up[e], w_down[e])
        start = end
    torch.cuda.synchronize()
    assert rel_err(got, want) <= 2 ** -6


@pytest.mark.cuda
def test_published_widths_burst_is_captured_and_serves_the_reference(cuda):
    """Two layers of DeepSeek-V2-Lite at its published widths (the dense
    layer and one expert layer, vocab 102400) through AutonomousEngine on
    the card: the burst is captured into a graph (no host sync inside it),
    the graph serves the eager path's tokens, and each served token lies
    within 0.1 standard deviations of the bf16-rounding reference's best
    (random weights, 96 new tokens)."""
    cfg = ModelConfig(**(cfg_map(PUBLISHED) | dict(n_layers=2, n_seq=256)))
    params = ds.init_params(cfg, 3, cuda)
    ecfg = EngineConfig(n_slots=16, n_forward_rounds=8, page_size=32,
                        n_pages=16 * 8, kv_dtype="bfloat16",
                        decode_ring=False)
    prompts = [np.random.default_rng(i).integers(0, 100000, n).tolist()
               for i, n in enumerate([160, 33, 1, 150, 100, 64])]
    out = {}
    for capture in (True, False):
        eng = T.AutonomousEngine(params, cfg, ecfg, device=cuda,
                                 max_new_per_burst=4, _capture=capture)
        st = T.ItemStorage()
        for i, p in enumerate(prompts):
            st.add_new_item(T.Request(i, list(p)))
        eng.run(st)
        out[capture] = [st.finished[i].tokens for i in range(len(prompts))]
        assert eng.stats.captures == (1 if capture else 0)
    assert out[True] == out[False]
    rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    cm = cfg_map(cfg)
    for p, toks in zip(prompts, out[True]):
        lg = ref.forward(cm, params, torch.tensor(toks[:-1], device=cuda),
                         rnd=rnd, first=len(p) - 1)
        got = torch.tensor(toks[len(p):], device=cuda)
        gap = (lg.max(-1).values - lg.gather(1, got[:, None])[:, 0]) \
            / lg.std(-1)
        assert float(gap.max()) <= 0.1
