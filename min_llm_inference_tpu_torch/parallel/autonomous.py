"""The device-resident scheduler (AutonomousEngine) over a dp x tp mesh.

Counterpart of min_llm_inference_tpu/parallel/autonomous.py. Each rank runs
the single-chip burst (runtime/autonomous._autonomous_burst, through an
AutonomousEngine at its dp group's config with its local params and the
mesh's parallel context) over its group's slots, page pool, request queue
and output buffers:

  * dp shards everything the burst touches per slot; a burst makes no
    collective across dp groups. Once per chunk of bursts every rank reads
    its group's 5-int status and all ranks all-gather them, so that every
    rank takes the same done and stall decisions and runs the same number
    of bursts (JAX: the host reads the [dp, 5] status);
  * tp shards heads and features through parallel/sharded.TpShardCtx (the
    embedding sum, the wo/FFN/logits sums, the page-scale max);
  * requests are dealt round-robin (request i to group i % dp); greedy
    tokens do not depend on where a request runs, so the outputs equal the
    single-chip engine's. Greedy only: per-group random streams would make
    sampled outputs depend on the partition, as in the JAX package.

On CUDA a rank's burst is one CUDA graph (runtime/graph.py, the gate and
the prefill bucket as conditional nodes) whenever its collectives can be
captured: under NCCL at any tp, and under any backend at tp = 1, whose
burst has no collective. Under gloo with tp > 1 (ranks that share one card)
the burst runs eagerly, by choice of backend: gloo's collectives run on
the host and cannot be captured. ``graphed`` says which.
"""

from __future__ import annotations

import collections
import functools
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..config import EngineConfig, ModelConfig, refuse_latent
from ..metrics import get_global_throughput_counter
from ..models.model import DEFAULT_CTX
from ..runtime.autonomous import (
    AutonomousEngine,
    AutoState,
    StreamingSession,
    _fold_counts,
    check_prompts,
    init_auto_state,
    prompt_bucket,
)
from ..runtime.item_storage import ItemStorage, Request
from ..utils.profiling import phase
from .engine import deal
from .sharded import (
    Mesh,
    TpShardCtx,
    check_mesh_shapes,
    local_engine_cfg,
    resolve_mesh,
    shard_params,
)


def init_sharded_auto_state(model_cfg: ModelConfig, local_cfg: EngineConfig,
                            mesh: Mesh, r_cap_loc: int) -> AutoState:
    """This rank's fresh AutoState: its group's slots and page pool
    (``local_cfg``), its D/tp features of every pool, and ``r_cap_loc``
    request rows (the group's queue)."""
    return init_auto_state(model_cfg, local_cfg, r_cap_loc, mesh.device,
                           tp=mesh.tp)


def gather_rows(mesh: Mesh, t: torch.Tensor) -> list:
    """A host tensor of equal shape on every rank, all-gathered over the
    mesh's host group; returns one numpy array per dp group (from the
    group's first rank)."""
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.host_group)
    return [parts[g * mesh.tp].numpy() for g in range(mesh.dp)]


def _drain_dtype(model_cfg: ModelConfig):
    # tokens and lengths fit int16 for the common vocabularies: half the
    # bytes of the final pull and gather
    if model_cfg.n_vocab <= 32768 and model_cfg.n_seq < 32767:
        return torch.int16
    return torch.int32


class ShardedAutonomousEngine:
    """AutonomousEngine over a dp x tp mesh (same ``run`` API), one rank
    per device: each rank constructs the engine with the same full params
    and calls ``run`` with the same queue; every rank's ItemStorage gets
    every finished request.

    Requires n_slots % dp == 0, n_pages % dp == 0, a group pool of at
    least one full-grant page group, and for tp > 1 n_heads % tp == 0 with
    use_output_proj (ValueError otherwise, before any collective). No
    drain downshift (as the JAX mesh engine). ``stats``: this rank's
    BurstStats; its ``host_syncs`` count the status all-gather of each
    chunk."""

    def __init__(
        self,
        params,
        model_cfg: ModelConfig,
        engine_cfg: EngineConfig,
        n_devices: int | None = None,
        tp: int = 1,
        attention_impl: str = "grouped",
        max_new_per_burst: int = 128,
        bursts_per_chunk: int = 4,
        request_capacity: int | None = None,
    ):
        refuse_latent(model_cfg, type(self).__name__)
        model_cfg.validate()
        engine_cfg.validate(model_cfg)
        mesh = resolve_mesh(n_devices, tp, functools.partial(
            self._check, model_cfg, engine_cfg))
        self.mesh = mesh
        self.dp, self.tp = mesh.dp, mesh.tp
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.local_cfg = local_engine_cfg(engine_cfg, mesh.dp)
        self.params = shard_params(params, mesh)
        self.ctx = TpShardCtx(mesh) if mesh.tp > 1 else DEFAULT_CTX
        # gloo's collectives run on the host: a tp > 1 burst under gloo
        # cannot be captured and runs eagerly
        self.graphed = (mesh.device.type == "cuda"
                        and (mesh.tp == 1 or mesh.backend == "nccl"))
        self.chunk = bursts_per_chunk
        # per-group request capacity (prompt buffer rows per group)
        self.request_capacity_loc = (
            None if request_capacity is None
            else -(-request_capacity // mesh.dp))
        self.engine = AutonomousEngine(
            self.params, model_cfg, self.local_cfg, attention_impl,
            max_new_per_burst=max_new_per_burst,
            bursts_per_chunk=bursts_per_chunk, device=mesh.device,
            ctx=self.ctx, _capture=self.graphed)
        self.max_new = self.engine.max_new

    @staticmethod
    def _check(model_cfg, engine_cfg, dp: int, tp: int) -> None:
        check_mesh_shapes(model_cfg, engine_cfg, dp, tp)
        W = engine_cfg.pages_per_slot(model_cfg.n_seq)
        if engine_cfg.n_pages // dp < W:
            raise ValueError(f"a group pool of {engine_cfg.n_pages // dp} "
                             f"pages is smaller than one full-grant page "
                             f"group ({W})")

    @property
    def stats(self):
        return self.engine.stats

    @property
    def graph_info(self):
        return self.engine.graph_info

    def run(self, item_storage: ItemStorage) -> None:
        counter = get_global_throughput_counter()
        mesh, dp, eng = self.mesh, self.dp, self.engine
        S = self.model_cfg.n_seq
        requests: List[Request] = item_storage.pop_new_items(1 << 30)
        n = len(requests)
        if n == 0:
            return
        # every rank refuses a bad queue alike, before any collective
        check_prompts(requests, S)
        mine = deal(requests, mesh)
        n_loc = [_share(n, dp, g) for g in range(dp)]
        cap_loc = max(self.request_capacity_loc or 0, max(n_loc))
        with phase("queue"):
            # one prompt bucket for every group: the same shapes on every
            # rank
            s_pre = prompt_bucket(requests, S)
            queue = eng._queue(mine, cap_loc, s_pre)
        with phase("upload"):
            prog = eng._load(*queue, len(mine))

        counter.start_record()
        done = False
        prev_status = None
        admitted = [0] * dp
        while not done:
            with phase("burst_dispatch"):
                for _ in range(self.chunk):
                    eng.stats.host_syncs += prog.burst(eng.engine_cfg.n_slots)
            eng.stats.bursts += self.chunk
            with phase("status_fetch"):
                stat = np.stack(gather_rows(mesh, prog.status.cpu()))
                eng.stats.host_syncs += 1
            live_total = int(stat[:, 0].sum())
            heads, frees, retries = (tuple(int(x) for x in stat[:, c])
                                     for c in (1, 2, 3))
            # a group's admitted requests have their first token on the
            # device (its request j is request g + j * dp)
            for g in range(dp):
                for j in range(admitted[g], heads[g]):
                    counter.note_first_token(requests[g + j * dp].id)
                admitted[g] = heads[g]
            queued = any(heads[g] < n_loc[g] or retries[g] > 0
                         for g in range(dp))
            done = live_total == 0 and not queued
            # two consecutive no-progress chunks make a stall: pages are
            # freed at the start of the NEXT burst
            if live_total == 0 and queued:
                if (heads, frees, retries) == prev_status:
                    raise RuntimeError(
                        "sharded autonomous engine stalled: pool exhausted")
                prev_status = (heads, frees, retries)
            else:
                prev_status = None
        with phase("drain_fetch"):
            out_tokens, final_lens = self._drain(prog, cap_loc)
            eng.stats.host_syncs += prog.fold_phases()
        total = 0
        with phase("collect"):
            for g in range(dp):
                for j, i in enumerate(range(g, n, dp)):
                    req = requests[i]
                    fl = int(final_lens[g][j])
                    if fl <= 0:
                        raise RuntimeError(
                            f"request {i} (group {g}) unfinished")
                    gen = out_tokens[g][j, len(req.tokens): fl].tolist()
                    req.tokens.extend(gen)
                    total += len(gen)
                    item_storage.add_finished(req)
        counter.add_record_if_recording(total)
        counter.stop_record()

    def _drain(self, prog, cap_loc: int):
        """One pull of this rank's outputs and device counters (int16 where
        tokens fit; the int64 counters in pieces of that width),
        all-gathered over the mesh as bytes. Folds this rank's counters
        into ``stats`` and returns each group's (out_tokens [cap_loc, S],
        final_lens [cap_loc]) as int32 numpy."""
        st = prog.st[self.local_cfg.n_slots]
        dt = _drain_dtype(self.model_cfg)
        rows = torch.cat([st.out_tokens, st.final_lens[:, None]], dim=1)
        blob = torch.cat([rows.to(dt).view(-1),
                          prog.count_vector().view(dt)]).cpu()
        self.engine.stats.host_syncs += 1
        n_rows = rows.numel()
        np_dt = np.int16 if dt == torch.int16 else np.int32
        _fold_counts(self.engine.stats,
                     blob.numpy()[n_rows:].copy().view(np.int64))
        parts = gather_rows(self.mesh, blob.view(torch.uint8))
        outs, lens = [], []
        for part in parts:
            r = part.view(np_dt)[:n_rows].reshape(cap_loc, -1).astype(
                np.int32)
            outs.append(r[:, :-1])
            lens.append(r[:, -1])
        return outs, lens


def _share(n: int, dp: int, g: int) -> int:
    """How many of the first n requests (round-robin) go to group g."""
    return len(range(g, n, dp))


class ShardedStreamingSession:
    """Online serving over the mesh: StreamingSession's contract (submit,
    step, dispatch, observe, poll, close; rows recycled; backpressure) on
    ShardedAutonomousEngine. Every rank makes the same calls with the same
    requests and gets the same results.

    Request i (by global submission order) goes to group i % dp, whose
    rank(s) keep it in their own StreamingSession, a ring of
    ``capacity // dp`` rows on the group's device. Backpressure is per
    group: ``free_capacity`` is the largest round-robin batch that every
    group it touches has rows for. Status snapshots (step, observe) and
    completions (poll) are all-gathered over the mesh, so every rank sees
    every group's; their ``fin_lens`` is the mesh-wide [dp * capacity/dp]
    final-length snapshot, group g's rows at g * capacity/dp."""

    def __init__(self, engine: ShardedAutonomousEngine, capacity: int,
                 max_prompt_len: int, observe_lag: int = 2):
        if capacity % engine.dp:
            raise ValueError(f"capacity {capacity} must divide over "
                             f"dp={engine.dp} groups")
        self.engine = engine
        self.mesh = engine.mesh
        self.dp = engine.dp
        self.capacity = capacity
        self.cap_loc = capacity // engine.dp
        self.local = StreamingSession(engine.engine, self.cap_loc,
                                      max_prompt_len, observe_lag)
        self.n_submitted = 0
        self._requests: List[Request] = []
        # global index of each of this group's requests, by object
        self._index = {}
        # every group's collected frontier (replicated on every rank)
        self._frontier_g = [0] * self.dp
        # n_submitted at each dispatch not yet observed
        self._dispatched = collections.deque()

    @property
    def stats(self):
        """This rank's BurstStats of the session."""
        return self.local.stats

    @property
    def free_capacity(self) -> int:
        """The largest round-robin batch submit() accepts now (limited by
        the fullest group's ring)."""
        free_g = [self.cap_loc - (_share(self.n_submitted, self.dp, g)
                                  - self._frontier_g[g])
                  for g in range(self.dp)]
        k = 0
        while k < self.capacity:
            g = (self.n_submitted + k) % self.dp
            if free_g[g] == 0:
                break
            free_g[g] -= 1
            k += 1
        return k

    def submit(self, requests: List[Request]) -> None:
        """Enqueue requests on every group they go to. Raises ValueError
        beyond free_capacity (backpressure) or for a prompt longer than
        max_prompt_len."""
        if not requests:
            return
        k = len(requests)
        if k > self.free_capacity:
            raise ValueError(
                f"backpressure: {k} submissions > free_capacity="
                f"{self.free_capacity}; poll() to collect completions or "
                "shed load upstream")
        for req in requests:  # every rank refuses alike
            if not 0 < len(req.tokens) <= self.local.max_prompt_len:
                raise ValueError(f"prompt length {len(req.tokens)} not in "
                                 f"[1, max_prompt_len="
                                 f"{self.local.max_prompt_len}]")
        first = (self.mesh.group - self.n_submitted) % self.dp
        for j in range(first, k, self.dp):
            self._index[id(requests[j])] = self.n_submitted + j
        self.local.submit(requests[first::self.dp])
        self._requests.extend(requests)
        self.n_submitted += k

    def _gather_status(self, snap: dict, n_submitted_at: int,
                       with_fin: bool) -> dict:
        """Every group's local status dict, all-gathered, as one mesh-wide
        dict (sums of live, queued, free units, finished)."""
        parts = [None] * self.mesh.world_size
        dist.all_gather_object(parts, snap, group=self.mesh.host_group)
        per_g = [parts[g * self.mesh.tp] for g in range(self.dp)]
        out = {k: sum(p[k] for p in per_g)
               for k in ("live", "queued", "free_groups", "finished_total")}
        if with_fin:
            out["fin_lens"] = np.concatenate(
                [p["fin_lens"][:self.cap_loc] for p in per_g])
            out["n_submitted_at"] = n_submitted_at
        return out

    def step(self, n_bursts: int | None = None,
             observe: bool = False) -> dict:
        """One chunk of bursts on every group, then the mesh-wide status
        (with ``observe``: and the final-length snapshot for poll(), read
        in the same pull)."""
        snap = self.local.step(n_bursts, observe=observe)
        return self._gather_status(snap, self.n_submitted, observe)

    def dispatch(self) -> None:
        """Pipelined serving: one burst on every group, its snapshot copied
        to the host without a wait (observe() reads it)."""
        self.local.dispatch()
        self._dispatched.append(self.n_submitted)

    def observe(self, block: bool = False) -> dict | None:
        """The oldest in-flight burst's mesh-wide status once it is at
        least observe_lag bursts old (or at once with ``block``), else
        None (the same answer on every rank)."""
        snap = self.local.observe(block)
        if snap is None:
            return None
        return self._gather_status(snap, self._dispatched.popleft(), True)

    def poll(self, fin_lens: np.ndarray | None = None,
             n_submitted_at: int | None = None) -> List[Request]:
        """Finished requests of every group (the submitted objects, tokens
        appended), each returned once, on every rank. ``fin_lens`` and
        ``n_submitted_at``: an observe() or step(observe=True) snapshot,
        else the latest final lengths are read."""
        g = self.mesh.group
        if fin_lens is None:
            mine = self.local.poll()
        else:
            hi = (self.n_submitted if n_submitted_at is None
                  else min(self.n_submitted, n_submitted_at))
            mine = self.local.poll(
                fin_lens[g * self.cap_loc:(g + 1) * self.cap_loc],
                _share(hi, self.dp, g))
        done = [(self._index.pop(id(r)), r.tokens) for r in mine]
        parts = [None] * self.mesh.world_size
        dist.all_gather_object(parts, (done, self.local._frontier),
                               group=self.mesh.host_group)
        out = []
        for gg in range(self.dp):
            finished, frontier = parts[gg * self.mesh.tp]
            self._frontier_g[gg] = frontier
            for i, tokens in finished:
                req = self._requests[i]
                if gg != g:
                    req.tokens.extend(tokens[len(req.tokens):])
                out.append(req)
        return out

    def close(self) -> List[Request]:
        """Run until every submitted request finishes; returns the
        remaining completions (as poll). Raises on a stall (two chunks in a
        row without progress while requests wait), on every rank."""
        out = []
        while self._dispatched:
            s = self.observe(block=True)
            out.extend(self.poll(s["fin_lens"], s["n_submitted_at"]))
        prev = None
        while True:
            s = self.step()
            out.extend(self.poll())
            if s["live"] == 0 and s["queued"] == 0:
                break
            if s["live"] == 0 and s["queued"] > 0:
                key = (s["queued"], s["free_groups"])
                if key == prev:
                    raise RuntimeError(
                        "sharded streaming session stalled: pool exhausted")
                prev = key
            else:
                prev = None
        out.extend(self.poll())
        self.local._fold_device_counts()
        return out
