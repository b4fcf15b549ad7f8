"""Engine and model configuration, and the device rule of the entry points.

Same fields, defaults and ``validate()`` as min_llm_inference_tpu/config.py,
so a JAX config converts field for field (``EngineConfig(**asdict(cfg))``).
``ModelConfig(arch="deepseek_v2", ...)`` builds a ``DeepSeekV2Config``, the
port's one architecture the JAX package lacks (latent attention and routed
experts); a config without ``arch`` is the JAX package's model, field for
field.
The port's engines run every option. ``pages_per_dma``,
``attn_group_size`` and ``dgrid_block`` chose the TPU kernels' DMA runs
and blocks: they are accepted and validated, and nothing here reads them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .constants import DEFAULT_INIT_NUM_BLOCKS, DEFAULT_PAGE_SIZE, EOF_TOKEN_ID


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent, so
    nothing runs on the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Shape of the model. With ``n_layers=1, n_heads=1, ffn_dim=0,
    use_output_proj=False`` this is the reference's single attention block
    (include/inference_model.h:8-74)."""

    def __new__(cls, *args, **kwargs):
        # ModelConfig(**fields) of another architecture builds that
        # architecture's config (the benchmark's configuration files name
        # it in their ``model`` group)
        arch = kwargs.get("arch", "gpt2")
        if cls is ModelConfig and arch != "gpt2":
            if arch != "deepseek_v2":
                raise ValueError(f"unknown model arch {arch!r}")
            cls = DeepSeekV2Config
        return super().__new__(cls)

    n_vocab: int = 1024
    emb_dim: int = 64
    n_seq: int = 64  # max sequence length (prompt + generated), incl. cap
    n_layers: int = 1
    n_heads: int = 1
    ffn_dim: int = 0  # 0 = no FFN block (reference parity mode)
    use_output_proj: bool = False  # attention output projection Wo
    use_layernorm: bool = False  # pre-LN around attention/FFN
    dtype: str = "float32"  # compute/weight dtype: float32 | bfloat16
    eof_token_id: int = EOF_TOKEN_ID

    @property
    def head_dim(self) -> int:
        assert self.emb_dim % self.n_heads == 0
        return self.emb_dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_mla(self) -> bool:
        """Latent attention over a latent pool (DeepSeekV2Config)."""
        return False

    def validate(self) -> None:
        assert self.n_vocab > 0 and self.emb_dim > 0 and self.n_seq > 0
        assert self.emb_dim % self.n_heads == 0
        assert 0 <= self.eof_token_id < self.n_vocab


def _yarn_default() -> dict:
    return {"type": "yarn", "factor": 40, "original_max_position_embeddings":
            4096, "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
            "mscale_all_dim": 0.707}


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config(ModelConfig):
    """DeepSeek-V2's decoder (models/deepseek_v2.py): RMSNorm, multi-head
    latent attention with YaRN RoPE, a dense SwiGLU MLP in the first
    ``first_k_dense_replace`` layers (``ffn_dim`` wide) and routed plus
    shared SwiGLU experts in the rest, an untied head. The keys after
    ``arch`` are the published config's (huggingface.co/deepseek-ai/
    DeepSeek-V2-Lite config.json); the defaults are DeepSeek-V2-Lite's.
    ``use_output_proj`` and ``use_layernorm`` are the JAX model's and are
    not read."""

    arch: str = "deepseek_v2"
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rope_scaling: dict = dataclasses.field(default_factory=_yarn_default,
                                           hash=False)
    rms_norm_eps: float = 1e-6
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0

    @property
    def is_mla(self) -> bool:
        return True

    @property
    def head_dim(self) -> int:
        """The q . k width of a head (nope + rope)."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """A latent pool row: c_kv, then the roped k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def validate(self) -> None:
        assert self.n_vocab > 0 and self.emb_dim > 0 and self.n_seq > 0
        assert 0 <= self.eof_token_id < self.n_vocab
        assert self.qk_rope_head_dim % 2 == 0
        assert 0 < self.num_experts_per_tok <= self.n_routed_experts
        assert 0 <= self.first_k_dense_replace <= self.n_layers
        assert self.ffn_dim > 0 or self.first_k_dense_replace == 0
        assert self.rope_scaling.get("type", "yarn") == "yarn", (
            "only YaRN rope scaling is implemented")



def refuse_latent(model_cfg: ModelConfig, engine: str) -> None:
    """Raise for a latent-attention model (DeepSeekV2Config) on an engine
    that serves multi-head attention over K/V pools only: the host engines
    and the dp x tp mesh engines."""
    if model_cfg.is_mla:
        raise ValueError(
            f"{engine} serves multi-head attention over K/V pools; "
            f"{type(model_cfg).__name__} (latent attention, routed experts) "
            "runs on AutonomousEngine")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Shape of the continuous-batching engine; the field meanings are
    documented on min_llm_inference_tpu.config.EngineConfig."""

    n_slots: int = 32
    n_forward_rounds: int = 1
    page_size: int = DEFAULT_PAGE_SIZE
    n_pages: int = 256
    init_num_pages: int = DEFAULT_INIT_NUM_BLOCKS
    # float32 | bfloat16 | int8 (per-page scales) | int4 (per-page scales,
    # two values packed per int8 byte: the pool's feature width is emb/2)
    kv_dtype: str = "float32"
    max_prefill_batch: int = 32
    pages_per_dma: int | None = None
    attn_group_size: int | None = None
    decode_ring: bool = True
    attn_flat: bool = False
    attn_dense: bool = False
    attn_dgrid: bool = False
    dgrid_block: int | None = None
    subbursts: int = 1
    burst_flush: bool = True
    sort_admits: bool = False
    overcommit: bool = False

    @property
    def kv_torch_dtype(self) -> torch.dtype:
        # int4 KV is stored packed two-per-byte in an int8 pool
        if self.kv_dtype == "int4":
            return torch.int8
        return getattr(torch, self.kv_dtype)

    @property
    def kv_packed(self) -> bool:
        return self.kv_dtype == "int4"

    @property
    def kv_quantized(self) -> bool:
        return self.kv_dtype in ("int8", "int4")

    def pages_per_slot(self, n_seq: int) -> int:
        """Width of a page-table row (reference: n_sequence/PAGE_BLOCK_SIZE,
        paged_item_storage.cpp:158-162)."""
        return math.ceil(n_seq / self.page_size)

    def validate(self, model: ModelConfig) -> None:
        assert self.n_slots > 0 and self.n_pages > 0
        if model.is_mla:
            # one latent row a token, shared by the heads: no K/V planes,
            # scales, packing or ring, and full grants only
            assert self.kv_dtype in ("float32", "bfloat16"), (
                "a latent pool is float32 or bfloat16")
            assert not (self.decode_ring or self.overcommit or self.attn_flat
                        or self.attn_dense or self.attn_dgrid), (
                "latent attention runs without the decode ring, overcommit "
                "and the ring formulations")
        assert self.kv_dtype in ("float32", "bfloat16", "int8", "int4"), (
            f"unsupported kv_dtype {self.kv_dtype!r}"
        )
        assert not (self.kv_packed and model.head_dim % 2), (
            "int4 KV needs an even head_dim (two features pack per byte)"
        )
        # at most one page per slot grows per host round
        # (paged_item_storage.cpp:21)
        assert 0 < self.n_forward_rounds <= self.page_size
        assert self.init_num_pages > 0
        assert self.max_prefill_batch > 0
        assert self.n_pages >= self.init_num_pages, (
            f"n_pages={self.n_pages} < init_num_pages={self.init_num_pages}: "
            "pool can never admit a request"
        )
        assert self.n_pages >= self.pages_per_slot(model.n_seq), (
            f"n_pages={self.n_pages} cannot hold one full sequence "
            f"({self.pages_per_slot(model.n_seq)} pages)"
        )
        if self.overcommit:
            W = self.pages_per_slot(model.n_seq)
            assert W >= 2, "overcommit needs >= 2 pages per slot (half-grants)"
            half = W // 2
            assert (self.pages_per_dma or 1) <= half, (
                "pages_per_dma must fit a half-group under overcommit"
            )
            assert not (self.attn_dense or self.attn_dgrid), (
                "attn_dense/attn_dgrid need full-grant contiguous group "
                "rows; overcommit grants half-groups"
            )
        assert self.attn_dense + self.attn_flat + self.attn_dgrid <= 1, (
            "attn_dense, attn_flat and attn_dgrid are mutually exclusive "
            "ring formulations"
        )
        assert not (self.attn_dense or self.attn_dgrid) or self.decode_ring, (
            "attn_dense/attn_dgrid implement the ring partial contract only"
        )
        assert not (self.attn_dgrid and self.kv_packed), (
            "attn_dgrid does not support packed int4 KV"
        )
        assert self.subbursts >= 1 and (
            self.n_forward_rounds % self.subbursts == 0
        ), "subbursts must divide n_forward_rounds"
        if self.decode_ring and self.kv_quantized:
            # ring scale columns live in a [B, 128] buffer: the ring span
            # is capped at 64 rounds
            span = (self.n_forward_rounds
                    if (self.burst_flush and self.subbursts > 1)
                    else self.n_forward_rounds // self.subbursts)
            assert span <= 64, (
                f"ring span {span} rounds exceeds the 64-round scale-column "
                "buffer (split with subbursts or disable burst_flush)"
            )
