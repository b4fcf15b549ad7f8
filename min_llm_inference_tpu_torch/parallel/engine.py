"""Host-scheduled continuous batching over a dp x tp mesh.

Counterpart of min_llm_inference_tpu/parallel/engine.py. Every rank runs
the single-chip two-deep pipelined loop (runtime/engine.py: one packed
[B/dp, 2+W] scheduler upload and one results pull per iteration) as the
host scheduler of its own dp group, over the group's local slots and page
ids, with its local params and the mesh's TpShardCtx. The tp ranks of a
group get the same results and take the same decisions; dp groups do not
talk to each other until the end, when every rank's ItemStorage receives
every finished request through one gather.

Requests are dealt round-robin: request i (in queue order) goes to group
i % dp. Greedy tokens do not depend on where a request runs, so the
outputs equal the single-chip engines' request for request.
"""

from __future__ import annotations

import functools

import torch.distributed as dist

from ..config import EngineConfig, ModelConfig, refuse_latent
from ..runtime.engine import NativePagedEngine, PagedEngine
from ..runtime.item_storage import ItemStorage
from .sharded import (
    TpShardCtx,
    check_mesh_shapes,
    local_engine_cfg,
    resolve_mesh,
    shard_params,
)


def deal(requests: list, mesh) -> list:
    """This rank's share of a request queue: request i goes to dp group
    i % dp."""
    return requests[mesh.group::mesh.dp]


def gather_finished(mesh, local: ItemStorage, item_storage: ItemStorage
                    ) -> None:
    """Every dp group's finished requests into ``item_storage``, on every
    rank, through one gather (a group's tp ranks hold the same requests;
    its first rank sends them)."""
    mine = list(local.finished.values()) if mesh.tp_rank == 0 else []
    parts = [None] * mesh.world_size
    dist.all_gather_object(parts, mine, group=mesh.host_group)
    for part in parts:
        for req in part:
            item_storage.add_finished(req)


class ShardedPagedEngine:
    """Continuous batching over a dp x tp mesh, one rank per device: each
    rank constructs the engine with the same full params (tensors on any
    device) and calls ``run`` with the same queue.

    Requires n_slots % dp == 0 and n_pages % dp == 0, and for tp > 1
    n_heads % tp == 0 with use_output_proj (ValueError otherwise, before
    any collective). Weights are sharded on entry (the local engine fuses
    the rank's own wq|wk|wv). ``attention_impl`` as PagedEngine's:
    ``paged`` (the one-slot kernel), ``grouped`` or ``torch``. The mesh is
    ``make_mesh(n_devices, tp)`` of the default process group.
    """

    _local_engine = PagedEngine

    def __init__(self, params, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, n_devices: int | None = None,
                 tp: int = 1, attention_impl: str = "torch"):
        refuse_latent(model_cfg, type(self).__name__)
        model_cfg.validate()
        engine_cfg.validate(model_cfg)
        mesh = resolve_mesh(n_devices, tp, functools.partial(
            check_mesh_shapes, model_cfg, engine_cfg))
        self.mesh = mesh
        self.dp, self.tp = mesh.dp, mesh.tp
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.local_cfg = local_engine_cfg(engine_cfg, mesh.dp)
        self.params = shard_params(params, mesh)
        self.engine = self._local_engine(
            self.params, model_cfg, self.local_cfg, attention_impl,
            device=mesh.device, ctx=TpShardCtx(mesh))

    @property
    def stats(self):
        """This rank's EngineStats (its group's bursts, syncs, ...)."""
        return self.engine.stats

    def run(self, item_storage: ItemStorage) -> None:
        local = ItemStorage()
        for req in deal(item_storage.pop_new_items(1 << 30), self.mesh):
            local.add_new_item(req)
        self.engine.run(local)
        gather_finished(self.mesh, local, item_storage)


class ShardedNativePagedEngine(ShardedPagedEngine):
    """ShardedPagedEngine with each group's host scheduling done by the
    native C++ scheduler (runtime/native.py over csrc/scheduler.cpp), one
    instance per rank over its group's local slot and page space."""

    _local_engine = NativePagedEngine
