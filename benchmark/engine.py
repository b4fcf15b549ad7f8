"""The engine of a run, built from the configuration's ``model``,
``engine`` and ``runner`` groups and the mix's ``bursts_per_chunk``."""

from __future__ import annotations

from min_llm_inference_tpu_torch.config import EngineConfig, ModelConfig
from min_llm_inference_tpu_torch.runtime.autonomous import AutonomousEngine


def make_engine(h, capacity):
    """``AutonomousEngine`` over the run's weights; ``capacity``: the
    request queue's rows (None: the first queue's size)."""
    r = h.cfg["runner"]
    return AutonomousEngine(
        h.params, ModelConfig(**h.cfg["model"]),
        EngineConfig(**h.cfg["engine"]),
        attention_impl=r["attention_impl"],
        max_new_per_burst=r["max_new_per_burst"],
        bursts_per_chunk=h.traffic["bursts_per_chunk"],
        request_capacity=capacity,
        min_drain_slots=r.get("min_drain_slots"), device=h.device)
