"""min_llm_inference_tpu_torch: the PyTorch/CUDA port of
min_llm_inference_tpu, for NVIDIA Hopper (H100).

It keeps the JAX package's layout, names and contracts (paged pool
``[NP, 2, P, D]``, ``lengths == 0`` as the liveness flag, arithmetic int4
packing, per-page scales set at row 0) and imports nothing of it, nor JAX.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than run on the CPU.

Ported so far: AutonomousEngine (full grant and overcommit, with and
without ring decode: the reference model of ``bench.py``, its 12-layer
gpt2s path, the flat and overcommit paths; greedy or sampled, with JAX's
own threefry bits, ops/random), whose burst runs on the card as one CUDA
graph with the liveness gate and the prefill bucket as conditional nodes
(runtime/graph.py, csrc/graph_cond.cu), and StreamingSession on it;
``init_params`` (JAX's weights bit for bit), weight-only int8/fp8
(ops/quant), checkpoints and the ΔPPL harness (utils/); the
host-scheduled engines (PagedEngine with the Python page scheduler,
NativePagedEngine with the C++ one built from csrc/scheduler.cpp at first
use, DenseEngine); every Pallas kernel of the
JAX package as a hand-written CUDA kernel under csrc/ (paged attention
with the fused write and the ring partial, one-slot paged attention, the
group-view and flat ring partials, the ring flush, the int8 prefill
quantize + scatter, the int4 probe; the attention kernels take float32,
bfloat16, int8 and packed int4 pools), and the sampling kernel
(csrc/sample_next_token.cu); the flagship decode step of the JAX
package's ``entry()`` (entry.py); the dp x tp mesh engines (parallel/:
ShardedPagedEngine, ShardedNativePagedEngine, ShardedAutonomousEngine,
ShardedStreamingSession over torch.distributed, one process per rank,
started by parallel.launch.run_ranks) and their dryrun
(``python -m min_llm_inference_tpu_torch.dryrun N``); and the entry points
of the JAX package's scripts, with their command lines: the headline
bench (``python -m min_llm_inference_tpu_torch.bench``), the serving
bench (tools/serving_bench.py), the demo and the scaling harness
(examples/).
"""

from .config import EngineConfig, ModelConfig, resolve_device
from .constants import (
    DEFAULT_INIT_NUM_BLOCKS,
    DEFAULT_PAGE_SIZE,
    EMPTY_ROW_TOKEN_ID,
    EOF_TOKEN_ID,
)
from .metrics import ThroughputCounter, get_global_throughput_counter
from .models.paged import PagedKVState, init_paged_state
from .models.params import fuse_qkv_params, init_params, params_from_numpy
from .ops.quant import quantize_params
from .parallel import (
    ShardedAutonomousEngine,
    ShardedNativePagedEngine,
    ShardedPagedEngine,
    ShardedStreamingSession,
    TpShardCtx,
    make_mesh,
    run_ranks,
)
from .runtime.autonomous import (
    AutonomousEngine,
    BurstStats,
    StreamingSession,
    init_auto_state,
)
from .runtime.engine import (
    DenseEngine,
    EngineStats,
    NativePagedEngine,
    PagedEngine,
)
from .runtime.item_storage import ItemStorage, Request

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "ModelConfig",
    "resolve_device",
    "EMPTY_ROW_TOKEN_ID",
    "EOF_TOKEN_ID",
    "DEFAULT_PAGE_SIZE",
    "DEFAULT_INIT_NUM_BLOCKS",
    "ThroughputCounter",
    "get_global_throughput_counter",
    "PagedKVState",
    "init_paged_state",
    "fuse_qkv_params",
    "init_params",
    "params_from_numpy",
    "quantize_params",
    "AutonomousEngine",
    "BurstStats",
    "StreamingSession",
    "init_auto_state",
    "DenseEngine",
    "EngineStats",
    "NativePagedEngine",
    "PagedEngine",
    "ItemStorage",
    "Request",
    "ShardedAutonomousEngine",
    "ShardedNativePagedEngine",
    "ShardedPagedEngine",
    "ShardedStreamingSession",
    "TpShardCtx",
    "make_mesh",
    "run_ranks",
]
