"""The port's quality evidence (min_llm_inference_tpu_torch.tools.
quality_evidence) against the JAX tool (tools/quality_evidence.py) on the
CPU at a tiny size: the Markov corpus and Zipf draws equal for a seed,
the teacher-forced forward within 1e-5 x max(1, |x|), the loss within
rtol 1e-6 and every gradient within rtol 1e-4 (atol 1e-7) of
``jax.value_and_grad``, AdamW and its schedule against
``optax.adamw(warmup_cosine_decay_schedule(...))`` within 1e-6 (update 0
at lr 0 changes no bit), a short training run's losses within rtol 1e-4
of the same loop written with JAX and optax, the GPT-2 layout against
HuggingFace's GPT2LMHeadModel and the JAX import, and the artifact's keys
against the JAX tool's last artifact (QUALITY_r04.json)."""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from min_llm_inference_tpu import ModelConfig as JModelConfig
from min_llm_inference_tpu import init_params as jinit
from min_llm_inference_tpu.utils.checkpoint import (
    import_gpt2_state_dict as jimport_gpt2,
)
import min_llm_inference_tpu_torch as T
from min_llm_inference_tpu_torch.models.params import params_from_numpy
from min_llm_inference_tpu_torch.tools import quality_evidence as qe
from min_llm_inference_tpu_torch.utils.checkpoint import (
    import_gpt2_state_dict,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_quality_evidence", os.path.join(ROOT, "tools", "quality_evidence.py"))
jq = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jq)

TCFG = T.ModelConfig(n_vocab=64, emb_dim=32, n_seq=16, n_layers=2,
                     n_heads=2, ffn_dim=64, use_output_proj=True,
                     use_layernorm=True, eof_token_id=63, dtype="float32")
JCFG = JModelConfig(**dataclasses.asdict(TCFG))
BATCH = 4
N_EVAL = 8
TINY_GPT2 = dict(V=256, S=64, D=32, L=2, H=2)


def jax_params(scale=0.02):
    return jinit(jax.random.PRNGKey(0), JCFG, scale=scale)


def to_port(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             TCFG, device="cpu")


def leaves(jtree, ttree):
    """(name, JAX leaf, port leaf) of two trees of the params layout."""
    for k in ("wte", "wpe"):
        yield k, jtree[k], ttree[k]
    for i, (jl, tl) in enumerate(zip(jtree["layers"], ttree["layers"],
                                     strict=True)):
        assert sorted(jl) == sorted(tl)
        for k in sorted(jl):
            yield f"layers.{i}.{k}", jl[k], tl[k]


def jax_loss(params, tokens):
    """The JAX tool's loss_fn (tools/quality_evidence.py:161-167)."""
    logits = jq.dense_causal_logits(params, JCFG, tokens[:, :-1])
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, tokens[:, 1:][..., None], axis=-1)
    return nll[..., 0].mean()


def markov_batch(seed, n):
    rng = np.random.default_rng(seed)
    succ, probs = qe.markov_corpus(rng, TCFG.n_vocab)
    return qe.sample_sequences(rng, succ, probs, n, TCFG.n_seq)


# ---------------------------------------------------------------- (a) data


@pytest.mark.parametrize("seed", [0, 11])
def test_data_matches_jax_tool(seed):
    got, want = np.random.default_rng(seed), np.random.default_rng(seed)
    succ, probs = qe.markov_corpus(got, 2048)
    j_succ, j_probs = jq.markov_corpus(want, 2048)
    np.testing.assert_array_equal(succ, j_succ)
    np.testing.assert_array_equal(probs, j_probs)
    assert qe.corpus_entropy_floor(probs) == jq.corpus_entropy_floor(j_probs)
    for n, length in ((64, 128), (5, 16)):
        seqs = qe.sample_sequences(got, succ, probs, n, length)
        j_seqs = jq.sample_sequences(want, j_succ, j_probs, n, length)
        assert seqs.dtype == np.int32
        np.testing.assert_array_equal(seqs, j_seqs)
    z = qe.zipf_sequences(got, 4096, 8, 256)
    np.testing.assert_array_equal(z, jq.zipf_sequences(want, 4096, 8, 256))
    assert got.random() == want.random()       # the same draws consumed


# ---------------------------------------------------------------- (b), (c)


@pytest.mark.parametrize("scale", [0.02, 0.5])
def test_dense_causal_logits_matches_jax(scale):
    jp = jax_params(scale)
    tokens = markov_batch(1, BATCH)
    want = np.asarray(jq.dense_causal_logits(jp, JCFG, jnp.asarray(tokens)))
    got = qe.dense_causal_logits(to_port(jp), TCFG, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * max(1.0, np.abs(want).max()), err
    model = qe.CausalLM(to_port(jp), TCFG)
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(tokens)), got)


@pytest.mark.parametrize("batch_seed", [2, 3])
def test_loss_and_gradients_match_jax(batch_seed):
    """At the trainer's init (scale 0.02), on two batches."""
    jp = jax_params()
    tokens = markov_batch(batch_seed, BATCH)
    j_loss, j_grads = jax.value_and_grad(jax_loss)(jp, jnp.asarray(tokens))
    model = qe.CausalLM(to_port(jp), TCFG)
    loss = qe.next_token_loss(model.tree(), TCFG, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    n = 0
    for name, jg, p in leaves(j_grads, model.tree()):
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
        n += 1
    assert n == 2 + TCFG.n_layers * 8 == len(list(model.parameters()))


# ---------------------------------------------------------------- (d)


@pytest.mark.parametrize("steps", [6, 30, 1500])
def test_lr_schedule_matches_optax(steps):
    optax = pytest.importorskip("optax")
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 6e-4, min(100, steps // 10), steps, 6e-5)
    for count in range(steps + 3):
        np.testing.assert_allclose(qe.lr_at(count, steps),
                                   float(sched(count)), rtol=1e-6,
                                   atol=1e-9, err_msg=str(count))
    if steps == 1500:
        for count, want in ((0, 0.0), (1, 6.0e-6), (100, 6.0e-4),
                            (800, 3.3e-4), (1500, 6.0e-5)):
            assert qe.lr_at(count, steps) == pytest.approx(want, rel=1e-9)


def test_adamw_and_schedule_match_optax():
    """Five updates from the same gradient trees: the warmup's update 0 at
    lr 0 (parameters bit-identical), two warmup updates, two on the
    cosine."""
    optax = pytest.importorskip("optax")
    steps = 30                                 # warmup 3
    jp = jax_params()
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32),
        jp) for _ in range(5)]
    opt_j = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, 6e-4, min(100, steps // 10), steps, 6e-5), weight_decay=0.01)
    state = opt_j.init(jp)
    model = qe.CausalLM(to_port(jp), TCFG)
    first = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt, sched = qe.make_optimizer(model.parameters(), steps)
    for i, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            qe.lr_at(i, steps), rel=1e-12, abs=0.0)
        for _, jg, p in leaves(g, model.tree()):
            p.grad = torch.from_numpy(np.array(jg))
        opt.step()
        sched.step()
        updates, state = opt_j.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, jleaf, p in leaves(jp, model.tree()):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jleaf),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"update {i}: {name}")
        if i == 0:
            for k, v in model.named_parameters():
                assert torch.equal(v.detach(), first[k]), k
    moved = max((v.detach() - first[k]).abs().max().item()
                for k, v in model.named_parameters())
    assert moved > 1e-4


# ---------------------------------------------------------------- (e)


def jax_trajectory(steps):
    """The JAX tool's train_model loop at TCFG: its rng order, loss,
    optimizer and schedule; every step's loss and the eval tokens."""
    optax = pytest.importorskip("optax")
    rng = np.random.default_rng(0)
    succ, probs = jq.markov_corpus(rng, JCFG.n_vocab)
    params = jax_params()
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, 6e-4, min(100, steps // 10), steps, 6e-5), weight_decay=0.01)
    state = opt.init(params)

    @jax.jit
    def step(params, state, tokens):
        loss, grads = jax.value_and_grad(jax_loss)(params, tokens)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for _ in range(steps):
        tokens = jnp.asarray(jq.sample_sequences(rng, succ, probs, BATCH,
                                                 JCFG.n_seq))
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    eval_tokens = jq.sample_sequences(rng, succ, probs, N_EVAL, JCFG.n_seq)
    return losses, eval_tokens


@pytest.mark.parametrize("steps", [6, 12])
def test_train_model_matches_jax_loop(steps):
    """6 steps: no warmup (update 0 on the cosine at the peak); 12 steps:
    a warmup of one update, at lr 0."""
    want, want_eval = jax_trajectory(steps)
    losses = []
    cfg, params, eval_tokens, stats = qe.train_model(
        0, steps, BATCH, "cpu", TCFG, n_eval=N_EVAL, step_losses=losses)
    assert cfg == TCFG and len(losses) == steps
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    np.testing.assert_array_equal(eval_tokens, want_eval)
    assert stats["loss_first"] == losses[0]
    assert stats["loss_last"] == losses[-1]
    assert stats["train_tokens"] == steps * BATCH * TCFG.n_seq
    assert stats["train_device"] == "cpu"
    assert "tf32 off" in stats["train_precision"]
    assert not any(t.requires_grad for t in
                   (params["wte"], *params["layers"][0].values()))


# ---------------------------------------------------------------- (f)


# GPT2LMHeadModel's state-dict keys and shapes, printed as one JSON line
# by a process of its own: importing transformers loads scikit-learn's
# OpenMP runtime beside torch's, which a test worker should not share
HF_SHAPES = """
import json, sys
from transformers import GPT2Config, GPT2LMHeadModel
V, S, D, L, H = map(int, sys.argv[1:])
hf = GPT2LMHeadModel(GPT2Config(vocab_size=V, n_positions=S, n_embd=D,
                                n_layer=L, n_head=H))
print(json.dumps({k.removeprefix("transformer."): list(v.shape)
                  for k, v in hf.state_dict().items()}))
"""


def test_gpt2_layout_matches_hf_and_the_jax_import():
    if importlib.util.find_spec("transformers") is None:
        pytest.skip("transformers is not installed")
    g = TINY_GPT2
    out = subprocess.run(
        [sys.executable, "-c", HF_SHAPES,
         *map(str, (g["V"], g["S"], g["D"], g["L"], g["H"]))],
        env={**os.environ, "USE_TF": "0"}, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = {k: tuple(v) for k, v in
            json.loads(out.stdout.strip().splitlines()[-1]).items()}
    state = qe.gpt2_layout_state_dict(0, g["V"], g["S"], g["D"], g["L"])
    assert {k: v.shape for k, v in state.items()} == want
    assert all(v.dtype == np.float32 for v in state.values())
    proj = 0.02 / math.sqrt(2 * g["L"])
    for key, v in state.items():
        if key.endswith(".bias"):
            assert not v.any(), key
        elif ".ln_" in key or key.startswith("ln_f"):
            assert (v == 1).all(), key
        else:
            std = proj if key.endswith("c_proj.weight") else 0.02
            assert abs(v.std() / std - 1) < 0.1, (key, v.std())
            assert abs(v.mean()) < 0.1 * std, key
    assert state["lm_head.weight"] is state["wte.weight"]

    cfg = T.ModelConfig(n_vocab=g["V"], emb_dim=g["D"], n_seq=g["S"],
                        n_layers=g["L"], n_heads=g["H"], ffn_dim=4 * g["D"],
                        use_output_proj=True, use_layernorm=True,
                        eof_token_id=g["V"] - 1, dtype="float32")
    got = import_gpt2_state_dict(state, cfg, device="cpu")
    jtree = jimport_gpt2(state, JModelConfig(**dataclasses.asdict(cfg)))
    n = 0
    for name, jl, tl in leaves(jtree, got):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl),
                                      err_msg=name)
        n += 1
    assert n == 2 + 8 * g["L"]


# ---------------------------------------------------------------- (g)


def test_run_writes_the_jax_artifacts_keys(tmp_path, capsys):
    """run() on the CPU at TCFG: the JAX artifact's keys (QUALITY_r04.json)
    plus ``device`` and the timing and precision keys, ``round`` "port",
    the pass rule and its exit code; on the CPU 1500 steps are cut to
    300."""
    out = tmp_path / "sub" / "quality.json"
    rc = qe.run(str(out), 1500, "cpu", cfg=TCFG, batch=BATCH,
                n_eval=N_EVAL, gpt2=TINY_GPT2, gpt2_seqs=2)
    assert "cutting steps 1500 -> 300" in capsys.readouterr().out
    res = json.loads(out.read_text())
    with open(os.path.join(ROOT, "QUALITY_r04.json")) as f:
        jax_res = json.load(f)
    assert set(res) == set(jax_res) | {"device"}
    tr, jtr = res["trained_8l512d"], jax_res["trained_8l512d"]
    assert set(tr) == set(jtr) | {"eval_seconds", "train_precision"}
    for k in ("int8_kv", "int4_kv", "int8_weights_plus_int8_kv"):
        assert set(tr[k]) == set(jtr[k])
    assert set(res["gpt2_import_smoke"]) == (
        set(jax_res["gpt2_import_smoke"]) | {"seconds"})
    assert res["round"] == "port" and res["device"] == "cpu"
    assert tr["train_steps"] == 300 and tr["train_device"] == "cpu"
    assert tr["eval_predicted_tokens"] == N_EVAL * (TCFG.n_seq - 1)
    assert tr["loss_last"] < tr["loss_first"]
    assert res["gpt2_import_smoke"]["finite"]
    rule = (tr["ppl_ref"] < 15 and abs(tr["int8_kv"]["delta_ppl"]) <= 0.1
            and np.isfinite(res["gpt2_import_smoke"]["ppl_q"]))
    assert res["pass"] == rule
    assert rc == (0 if rule else 1)
    for k in ("int8_kv", "int4_kv", "int8_weights_plus_int8_kv"):
        assert tr[k]["delta_ppl"] == pytest.approx(
            tr[k]["ppl"] - tr["ppl_ref"], rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("ppl_ref, delta, gpt2_ppl, want", [
    (14.9, 0.1, 4000.0, True), (14.9, -0.1, 4000.0, True),
    (15.0, 0.0, 4000.0, False), (9.3, 0.1001, 4000.0, False),
    (9.3, 0.0, float("nan"), False), (9.3, 0.0, float("inf"), False),
])
def test_pass_rule(ppl_ref, delta, gpt2_ppl, want):
    res = {"trained_8l512d": {"ppl_ref": ppl_ref,
                              "int8_kv": {"delta_ppl": delta}},
           "gpt2_import_smoke": {"ppl_q": gpt2_ppl}}
    assert qe.passes(res) is want


def test_cli_default_device_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    out = tmp_path / "q.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        qe.main(["--out", str(out), "--steps", "2"])
    assert not out.exists()
    args = qe.parser().parse_args([])
    assert (args.device, args.steps) == ("cuda", 1500)
    assert not os.path.isabs(args.out) and args.out.startswith("chiprun_out/")
