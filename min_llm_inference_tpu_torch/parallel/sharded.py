"""dp x tp sharding over ``torch.distributed``: one process per rank (SPMD).

Counterpart of min_llm_inference_tpu/parallel/sharded.py, where one
``shard_map`` over a ``Mesh`` runs the single-chip functions at local
shapes. Here every rank runs them itself, at its local shapes, with a
TpShardCtx at the four tensor-parallel seams:

  * mesh: rank = group * tp + tp_rank; dp groups are independent
    continuous-batching domains (their own slots, page pool with local
    page ids, requests), with no communication between them until the
    outputs are gathered;
  * tp shards attention heads Megatron-style: wq/wk/wv (fused per rank
    afterwards into the rank's [q_l|k_l|v_l], the column slice of JAX's
    per-rank interleaved wqkv) and w_up by columns, wo and w_down by rows
    (their partial products summed over tp), the embeddings and the tied
    LM head by features (embedding gathered over tp, logits summed);
  * KV pools are [n_pages/dp, 2, page_size, D/tp] per rank (D/2/tp packed
    int4); int8/int4 page scales are the FULL row's absmax, a max over tp
    at write time (ops/quant.update_page_scales), so quantized tokens equal
    one device's;
  * every tp rank of a group holds the same scheduler state and gets the
    same (all-reduced) logits, so it takes the same greedy decisions and
    enters the same collectives in the same order.

Requires n_heads % tp == 0 and, for tp > 1, use_output_proj (the output
projection maps the local heads back to the full residual stream).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import EngineConfig, ModelConfig
from ..models.model import SingleChipCtx
from ..models.paged import PagedKVState, init_paged_state, make_paged_fns
from ..ops.quant import is_quantized_leaf
from . import launch

# the dimension of each leaf that tp splits (None: replicated), by name
PARAM_SPLIT = {
    "wte": 1, "wpe": 1,
    "wq": 1, "wk": 1, "wv": 1,
    "wo": 0,
    "w_up": 1, "w_down": 0,
    "ln1_g": None, "ln2_g": None,
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a dp x tp mesh: ``group`` (its dp group) and
    ``tp_rank`` (its shard of heads and features), its device, the process
    group of its tp ranks (None at tp = 1) and ``host_group``, a gloo group
    of every rank for host-side exchange (statuses, outputs)."""

    world_size: int
    dp: int
    tp: int
    rank: int
    group: int
    tp_rank: int
    device: torch.device
    backend: str
    tp_group: object
    host_group: object


_MESHES = {}


def make_mesh(n_devices: int | None = None, tp: int = 1) -> Mesh:
    """The mesh of the initialized default process group, one rank per
    device (the one run_ranks placed the rank on): dp = n_devices / tp.
    Every rank must call it, with the same arguments in the same order
    (each creates every tp group, its own and the others')."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/launch.run_ranks starts one)")
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{world} ranks (one rank per device)")
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} must divide the world size {world}")
    dev = launch.rank_device()
    key = (world, tp, str(dev), id(dist.group.WORLD))
    if key in _MESHES:
        return _MESHES[key]
    rank = dist.get_rank()
    backend = dist.get_backend()
    host_group = (dist.group.WORLD if backend == "gloo"
                  else dist.new_group(list(range(world)), backend="gloo"))
    tp_group = None
    for g in range(world // tp):
        ranks = list(range(g * tp, (g + 1) * tp))
        pg = dist.new_group(ranks) if tp > 1 else None
        if rank in ranks:
            tp_group = pg
    mesh = Mesh(world, world // tp, tp, rank, rank // tp, rank % tp, dev,
                backend, tp_group, host_group)
    _MESHES[key] = mesh
    return mesh


class TpShardCtx(SingleChipCtx):
    """models/model.py::SingleChipCtx overridden at the four tp seams, over
    the mesh's tp process group. Each reduction consumes its argument (a
    fresh product). Under gloo a CUDA tensor goes to gloo's own CUDA
    all-reduce, which stages it through pinned host memory."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.tp = mesh.tp

    def _all_reduce(self, x, op):
        if self.tp == 1:
            return x
        dist.all_reduce(x, op=op, group=self.mesh.tp_group)
        return x

    def psum(self, x):
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def _feature_slice(self, d_local: int) -> slice:
        r = self.mesh.tp_rank
        return slice(r * d_local, (r + 1) * d_local)

    def embed(self, params, tokens, positions):
        if self.tp == 1:
            return super().embed(params, tokens, positions)
        # feature-sharded tables: the local gather, placed in a zero row of
        # full width and summed over tp (exact: every other rank adds 0)
        emb_l = super().embed(params, tokens, positions)
        d_local = emb_l.shape[-1]
        full = emb_l.new_zeros(*emb_l.shape[:-1], d_local * self.tp)
        full[..., self._feature_slice(d_local)] = emb_l
        return self.psum(full)

    def logits(self, h, wte_l):
        if self.tp == 1:
            return super().logits(h, wte_l)
        # row-parallel tied LM head: this rank's features of h against its
        # wte columns, in float32, summed over tp
        h_l = h[..., self._feature_slice(wte_l.shape[1])]
        partial = torch.matmul(h_l.float(), wte_l.float().t())
        return self.psum(partial)

    def local_heads(self, cfg: ModelConfig) -> int:
        if cfg.n_heads % self.tp:
            raise ValueError(f"n_heads={cfg.n_heads} must divide by "
                             f"tp={self.tp}")
        return cfg.n_heads // self.tp


def check_mesh_shapes(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                      dp: int, tp: int) -> None:
    """Raise ValueError unless the configs shard over dp x tp."""
    if engine_cfg.n_slots % dp or engine_cfg.n_pages % dp:
        raise ValueError(f"n_slots={engine_cfg.n_slots} and n_pages="
                         f"{engine_cfg.n_pages} must divide by dp={dp}")
    if tp > 1:
        if not model_cfg.use_output_proj:
            raise ValueError("tp > 1 needs use_output_proj (wo is "
                             "row-parallel)")
        if model_cfg.n_heads % tp or (model_cfg.ffn_dim % tp):
            raise ValueError(f"n_heads={model_cfg.n_heads} and ffn_dim="
                             f"{model_cfg.ffn_dim} must divide by tp={tp}")


def resolve_mesh(n_devices: int | None, tp: int, check) -> Mesh:
    """An engine's mesh, make_mesh(n_devices, tp) of the default process
    group, after ``check(dp, tp)`` has raised for shapes that do not shard
    (before any collective, so every rank refuses alike)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} must divide n_devices={n}")
    check(n // tp, tp)
    return make_mesh(n_devices, tp)


def local_engine_cfg(engine_cfg: EngineConfig, dp: int) -> EngineConfig:
    """One dp group's config: n_slots/dp slots over n_pages/dp pages."""
    return dataclasses.replace(engine_cfg, n_slots=engine_cfg.n_slots // dp,
                               n_pages=engine_cfg.n_pages // dp)


def _shard_leaf(name: str, x, mesh: Mesh):
    dim = PARAM_SPLIT[name]
    if dim is not None and mesh.tp > 1:
        d = x.shape[dim] // mesh.tp
        x = x.narrow(dim, mesh.tp_rank * d, d)
    return x.to(mesh.device).contiguous().clone()


def shard_params(params, mesh: Mesh):
    """This rank's slice of every leaf (columns or rows by PARAM_SPLIT,
    replicated gains), on the rank's device. Weight-quantized leaves are
    refused: they are a single-device feature, as in the JAX package."""
    leaves = [params["wte"], params["wpe"]] + [
        w for layer in params["layers"] for w in layer.values()]
    if any(is_quantized_leaf(w) for w in leaves):
        raise ValueError("weight-quantized params are a single-device "
                         "feature: shard the dense tree")
    return {
        "wte": _shard_leaf("wte", params["wte"], mesh),
        "wpe": _shard_leaf("wpe", params["wpe"], mesh),
        # fused leaves are left out: each rank's engine fuses its own
        "layers": [{k: _shard_leaf(k, v, mesh) for k, v in layer.items()
                    if k not in ("wqkv", "wkv")}
                   for layer in params["layers"]],
    }


def init_sharded_state(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                       mesh: Mesh) -> PagedKVState:
    """This rank's zeroed pools: [n_pages/dp, 2, page_size, D/tp] (D/2/tp
    packed), with [n_pages/dp] scales for int8/int4."""
    return init_paged_state(model_cfg, local_engine_cfg(engine_cfg, mesh.dp),
                            mesh.device, tp=mesh.tp)


def make_sharded_fns(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                     mesh: Mesh, attention_impl: str = "torch"):
    """This rank's (prefill, decode_rounds): the single-chip functions of
    models/paged.py at the local config, with the mesh's TpShardCtx. Their
    inputs are the rank's group rows (prompts [M_loc, S], page rows and the
    packed operand in local page ids) and its local params and state."""
    check_mesh_shapes(model_cfg, engine_cfg, mesh.dp, mesh.tp)
    return make_paged_fns(model_cfg, local_engine_cfg(engine_cfg, mesh.dp),
                          attention_impl, ctx=TpShardCtx(mesh))
