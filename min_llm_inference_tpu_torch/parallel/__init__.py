"""dp x tp mesh engines over ``torch.distributed`` (counterpart of
min_llm_inference_tpu/parallel/): one process per rank, each running the
single-chip functions at its local shapes (sharded.py), the host-scheduled
engines (engine.py), the device-resident scheduler and its streaming
session (autonomous.py), and the launcher that starts the ranks
(launch.py)."""

from .autonomous import ShardedAutonomousEngine, ShardedStreamingSession
from .engine import ShardedNativePagedEngine, ShardedPagedEngine
from .launch import run_ranks
from .sharded import TpShardCtx, make_mesh, shard_params

__all__ = [
    "ShardedAutonomousEngine",
    "ShardedStreamingSession",
    "ShardedNativePagedEngine",
    "ShardedPagedEngine",
    "TpShardCtx",
    "make_mesh",
    "run_ranks",
    "shard_params",
]
