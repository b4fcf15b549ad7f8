"""Dense-view ring partial of paged decode attention, in plain PyTorch.

Counterpart of min_llm_inference_tpu/ops/paged_attention_dense.py
(``dense_paged_partial``, an XLA formulation with no Pallas kernel, so
plain PyTorch on both devices). Under the engine's full-grant allocator a
live slot's page-table row is ``gid * W + arange(W)``, so the pool
``[NP, 2, P, Dk]`` is also the dense group view ``[NG, W, 2, P, Dk]``:
attention runs in group order as batched elementwise + reduce, with q moved
from slot to group order by a scatter and o, m, l back by a gather.

Contract (the ring partial's): the pool is read-only and holds positions <
ring_start; the call returns ``(o [B, D] normalized, m [B, H], l [B, H])``
in float32, rows without such a position (dead slots, ring_start == 0)
o = 0, m = -inf, l = 0. Full-grant rows only (EngineConfig rejects
``attn_dense`` under overcommit).
"""

from __future__ import annotations

import torch

from .indexing import index_set_drop_
from .quant import unpack_int4
from .reference import inv_sqrt

_TINY = torch.finfo(torch.float32).tiny


def _to_groups(x, grp, live, ng):
    """Scatter [B, ...] slot-order rows into [NG, ...] group order (zeros
    elsewhere); dead slots are dropped, since their stale group ids may
    alias a live slot's."""
    out = torch.zeros((ng,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return index_set_drop_(out, torch.where(live, grp, ng), x)


def dense_paged_partial(
    q,            # [B, D]
    kv_pages,     # [NP, 2, P, Dk] pool (float / int8 / packed int4)
    k_scales,     # [NP] f32 or None
    v_scales,
    ring_start,   # [B] i32, pages hold positions < ring_start
    lengths,      # [B] i32 (liveness: 0 = dead)
    page_table,   # [B, W] i32, full-grant group rows
    *,
    n_heads: int,
    page_size: int,
    packed_int4: bool = False,
):
    """The dense partial over all W pages of every group.

    The JAX engine's ``dense_paged_partial_bucketed`` reads only the first
    Wb pages of each group, Wb the smallest power of two that covers the
    largest live ring_start, picked on the device by ``lax.switch``. In
    eager PyTorch that choice would read the maximum to the host, a sync
    in every layer of every round; this runs at the full W instead. The
    positions past ring_start are masked either way, so the outputs are
    the same."""
    B, D = q.shape
    NP, _, P, Dk = kv_pages.shape
    W = page_table.shape[1]
    NG = NP // W
    H = n_heads
    dh = D // H
    T = W * P

    live = lengths > 0
    grp = torch.div(page_table[:, 0], W, rounding_mode="floor")
    qg = _to_groups(q.float(), grp, live, NG)
    rsg = _to_groups(torch.where(live, ring_start, 0), grp, live, NG)

    view = kv_pages[:NG * W].reshape(NG, W, 2, P, Dk)
    kd = view[:, :, 0].reshape(NG, T, Dk)
    vd = view[:, :, 1].reshape(NG, T, Dk)
    if packed_int4:
        kd, vd = unpack_int4(kd, H), unpack_int4(vd, H)
    Kh = kd.float().reshape(NG, T, H, dh)
    Vh = vd.float().reshape(NG, T, H, dh)

    s = torch.einsum("gthd,ghd->gth", Kh, qg.reshape(NG, H, dh)) * inv_sqrt(dh)
    if k_scales is not None:
        pid = (torch.arange(NG, device=q.device)[:, None] * W
               + torch.arange(W, device=q.device)[None, :])
        kst = k_scales[pid].repeat_interleave(P, dim=1)          # [NG, T]
        vst = v_scales[pid].repeat_interleave(P, dim=1)
        s = s * kst[:, :, None]
    pos = torch.arange(T, dtype=torch.int32, device=q.device)
    maskd = pos[None, :, None] < rsg[:, None, None]              # [NG, T, 1]
    s = torch.where(maskd, s, float("-inf"))
    m = s.amax(dim=1)                                            # [NG, H]
    w = torch.where(maskd, torch.exp(s - m[:, None, :]), 0.0)
    l = w.sum(dim=1)
    if k_scales is not None:
        w = w * vst[:, :, None]
    o = torch.einsum("gth,gthd->ghd", w, Vh)
    o = o / l.clamp_min(_TINY)[..., None]

    # back to slot order; dead slots get the empty partial
    gi = grp.clamp(0, NG - 1).long()
    o, m, l = o[gi].reshape(B, D), m[gi], l[gi]
    dead = ~live
    return (torch.where(dead[:, None], 0.0, o),
            torch.where(dead[:, None], float("-inf"), m),
            torch.where(dead[:, None], 0.0, l))
