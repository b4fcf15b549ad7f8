"""Rank bodies of the mesh runs: what each rank of parallel/launch.run_ranks
executes for the dryrun, the tests and ``chip_smoke.py``.

Every function here is called on every rank with the same arguments, which
are plain data (config field dicts, numpy arrays, prompt lists, a params
recipe), and returns plain data. ``run_cases`` runs several such calls in
one mesh, so that a caller pays for one set of processes.

A params recipe: ``("numpy", tree)``, a numpy parameter tree (e.g. the JAX
package's, converted leaf by leaf), or ``("init", seed, eof_bias)``, the
port's ``init_params`` (JAX's weights bit for bit) made on the rank.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import EngineConfig, ModelConfig
from ..models.model import DEFAULT_CTX
from ..models.params import fuse_qkv_params, init_params, params_from_numpy
from ..ops import _build
from ..ops.quant import update_page_scales
from ..ops.reference import token_pos_embed
from ..runtime.item_storage import ItemStorage, Request
from .autonomous import ShardedAutonomousEngine, ShardedStreamingSession
from .engine import ShardedNativePagedEngine, ShardedPagedEngine
from .sharded import (
    TpShardCtx,
    init_sharded_state,
    make_mesh,
    make_sharded_fns,
    shard_params,
)

ENGINES = {"paged": ShardedPagedEngine, "native": ShardedNativePagedEngine,
           "auto": ShardedAutonomousEngine}


def make_params(recipe, model_cfg: ModelConfig, device):
    """Full (unsharded) params on ``device`` from a recipe."""
    if recipe[0] == "numpy":
        return params_from_numpy(recipe[1], model_cfg, device=device)
    _, seed, eof_bias = recipe
    return init_params(seed, model_cfg, eof_bias=eof_bias, device=device)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_fns(model: dict, engine: dict, attention: str, tp: int, recipe,
             prompts, lengths, last, local_table, pools: bool = False):
    """make_sharded_fns on one set of global inputs: prefill every slot of
    the rank's dp group (``local_table``: [B, W] page rows in group-local
    ids), then one decode_rounds call. Returns the rank's group rows of
    (tokens, lengths, last tokens) and, with ``pools``, its pool shards as
    prefill left them."""
    mcfg, ecfg = ModelConfig(**model), EngineConfig(**engine)
    mesh = make_mesh(None, tp)
    params = fuse_qkv_params(
        shard_params(make_params(recipe, mcfg, mesh.device), mesh))
    prefill, decode = make_sharded_fns(mcfg, ecfg, mesh, attention)
    state = init_sharded_state(mcfg, ecfg, mesh)
    B_loc = ecfg.n_slots // mesh.dp
    rows = slice(mesh.group * B_loc, (mesh.group + 1) * B_loc)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows])).to(
            mesh.device)

    table = put(local_table)
    state = prefill(params, state, put(prompts), put(lengths), table)
    prefilled = [np.array(p.float().cpu()) for p in state.kv_pages]
    packed = torch.full((B_loc, 2 + table.shape[1]), -1, dtype=torch.int32,
                        device=mesh.device)
    packed[:, 2:] = table
    state, lens, lst, toks = decode(params, state, packed, put(lengths),
                                    put(last))
    out = dict(group=mesh.group, tp_rank=mesh.tp_rank,
               tokens=toks.cpu().numpy(), lengths=lens.cpu().numpy(),
               last=lst.cpu().numpy())
    if pools:
        out["pools"] = prefilled
    return out


def seams(tp: int, seed: int = 0):
    """TpShardCtx's four seams at world size tp against the one-device
    functions on the same full inputs (made from ``seed`` on every rank):
    returns each seam's max abs difference, and the pmax'd page scales
    against the unsharded ones."""
    mesh = make_mesh(None, tp)
    ctx = TpShardCtx(mesh)
    g = torch.Generator().manual_seed(seed)
    V, D, S, B = 64, 32, 16, 6

    def rand(*shape):
        return torch.rand(shape, generator=g) * 2 - 1

    wte, wpe, h = rand(V, D), rand(S, D), rand(B, D)
    w_row = rand(D, D)
    tokens = torch.randint(0, V, (B,), generator=g, dtype=torch.int32)
    pos = torch.randint(0, S, (B,), generator=g, dtype=torch.int32)
    d_loc = D // tp
    f = slice(mesh.tp_rank * d_loc, (mesh.tp_rank + 1) * d_loc)
    local = {"wte": wte[:, f].contiguous(), "wpe": wpe[:, f].contiguous()}
    diffs = {}
    want = token_pos_embed(tokens, pos, wte, wpe)
    diffs["embed"] = (ctx.embed(local, tokens, pos) - want).abs().max().item()
    want = DEFAULT_CTX.logits(h, wte)
    diffs["logits"] = (ctx.logits(h, local["wte"]) - want).abs().max().item()
    want = h @ w_row
    got = ctx.psum(h[:, f] @ w_row[f, :])
    diffs["psum"] = (got - want).abs().max().item()
    scales_full = torch.zeros(8)
    scales_tp = torch.zeros(8)
    pid = torch.tensor([1, 3, 8, 5, 0, 8], dtype=torch.int32)
    update_page_scales(scales_full, h, pid, 127.0)
    update_page_scales(scales_tp, h[:, f].contiguous(), pid, 127.0,
                       absmax_reduce=ctx.pmax)
    diffs["pmax_scales"] = (scales_tp - scales_full).abs().max().item()
    return diffs


def _launch_counts() -> dict:
    return {w.__name__: w.launches for w in _build.COUNTED}


def _time_collectives(ctx: TpShardCtx) -> dict:
    """Wrap the tp all-reduce of ``ctx`` to time each call on the host
    clock in two parts: the wait for this rank's queued device work (a
    synchronize; a gloo reduce of a CUDA tensor waits for it too) and the
    reduce itself (gloo's staging copies, the collective, the wait for the
    peers to enter it). Returns the record it fills: {(op, shape): [calls, wait s,
    reduce s, fastest reduce s]}."""
    rec = collections.defaultdict(lambda: [0, 0.0, 0.0, float("inf")])
    inner = ctx._all_reduce

    def timed(x, op):
        t0 = time.perf_counter()
        _sync(x.device)
        t1 = time.perf_counter()
        out = inner(x, op)
        _sync(x.device)
        t2 = time.perf_counter()
        r = rec[(str(op).rsplit(".", 1)[-1], tuple(x.shape))]
        r[0] += 1
        r[1] += t1 - t0
        r[2] += t2 - t1
        r[3] = min(r[3], t2 - t1)
        return out

    ctx._all_reduce = timed
    return rec


def engine_run(kind: str, model: dict, engine: dict, recipe, prompts,
               tp: int = 1, attention: str = "torch", runs: int = 1,
               engine_kw: dict | None = None):
    """Build a mesh engine (``kind``: paged, native, auto) and serve the
    prompts ``runs`` times (the same queue each time). Returns the last
    run's tokens by request id (every rank's view: each has every
    request), each run's wall seconds, this rank's stats and the kernel
    launches of the last run, and whether the burst ran as a graph; for
    an autonomous engine at tp > 1, also the last run's tp all-reduces,
    timed by _time_collectives, as [(op, shape, calls, wait s, reduce s,
    fastest reduce s)]."""
    mcfg, ecfg = ModelConfig(**model), EngineConfig(**engine)
    mesh = make_mesh(None, tp)
    params = make_params(recipe, mcfg, mesh.device)
    eng = ENGINES[kind](params, mcfg, ecfg, tp=tp, attention_impl=attention,
                        **(engine_kw or {}))
    del params
    ctx = getattr(eng, "ctx", None)
    coll = _time_collectives(ctx) if isinstance(ctx, TpShardCtx) else None
    walls = []
    for _ in range(runs):
        if coll is not None:
            coll.clear()
        store = ItemStorage()
        for i, p in enumerate(prompts):
            store.add_new_item(Request(i, list(p)))
        for w in _build.COUNTED:
            w.launches = 0
        stats_before = dict(vars(eng.stats))
        dist.barrier(group=mesh.host_group)
        _sync(mesh.device)
        t0 = time.perf_counter()
        eng.run(store)
        _sync(mesh.device)
        walls.append(time.perf_counter() - t0)
    stats = {k: v - stats_before.get(k, 0) for k, v in vars(eng.stats).items()}
    return dict(rank=mesh.rank, group=mesh.group, tp_rank=mesh.tp_rank,
                tokens={i: r.tokens for i, r in store.finished.items()},
                walls=walls, stats=stats, launches=_launch_counts(),
                graphed=getattr(eng, "graphed", False),
                collectives=coll and [(*k, *v) for k, v in coll.items()])


def stream_run(model: dict, engine: dict, recipe, prompts, tp: int,
               capacity: int, max_prompt_len: int, pipelined: bool,
               engine_kw: dict | None = None, wave: int = 4,
               max_steps: int = 600):
    """Serve the prompts through a ShardedStreamingSession: waves of up to
    ``wave`` submissions within free_capacity, then dispatch/observe
    (``pipelined``) or step(observe=True), polling each snapshot, and
    close. Returns the tokens by request id."""
    mcfg, ecfg = ModelConfig(**model), EngineConfig(**engine)
    mesh = make_mesh(None, tp)
    eng = ShardedAutonomousEngine(make_params(recipe, mcfg, mesh.device),
                                  mcfg, ecfg, tp=tp,
                                  **(engine_kw or {}))
    sess = ShardedStreamingSession(eng, capacity=capacity,
                                   max_prompt_len=max_prompt_len)
    n = len(prompts)
    finished, submitted = {}, 0
    for _ in range(max_steps):
        take = min(wave, n - submitted, sess.free_capacity)
        if take:
            sess.submit([Request(i, list(prompts[i]))
                         for i in range(submitted, submitted + take)])
            submitted += take
        if pipelined:
            sess.dispatch()
            s = sess.observe()
        else:
            s = sess.step(observe=True)
        if s is not None and s["finished_total"]:
            for r in sess.poll(s["fin_lens"], s["n_submitted_at"]):
                finished[r.id] = r.tokens
        if submitted == n and len(finished) == n:
            break
    for r in sess.close():
        finished[r.id] = r.tokens
    return dict(rank=mesh.rank, tokens=finished, submitted=submitted)


def run_cases(cases):
    """Run [(function name, kwargs), ...] of this module in order; returns
    their results in order."""
    return [globals()[name](**kw) for name, kw in cases]
