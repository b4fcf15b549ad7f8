"""Scatter with JAX's ``mode="drop"`` semantics, without a host sync.

JAX drops every out-of-range index of ``x.at[idx].set(v, mode="drop")``;
the engine relies on that to make dead-slot and padding writes vanish
(a dead slot's stale page ids may belong to a live slot). ``index_put_``
raises on such an index on the CPU and faults on CUDA, clamping makes the
dropped writes collide with real ones, and filtering by a boolean mask
syncs with the host. Here a dropped entry is instead rewritten as a copy of
the first kept entry (same index, same value), so duplicate indices only
ever write identical bytes and the result is deterministic.
"""

from __future__ import annotations

import torch


def index_set_drop_(dst: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """In place ``dst[idx[i]] = vals[i]`` along dim 0 for every idx in
    ``[0, len(dst))``; other entries write nothing. Kept indices must be
    unique (the same contract as the JAX call sites). Returns ``dst``."""
    idx = idx.reshape(-1).long()
    if idx.numel() == 0:
        return dst
    n = dst.shape[0]
    vals = vals.reshape((idx.shape[0],) + tuple(dst.shape[1:])).to(dst.dtype)
    keep = (idx >= 0) & (idx < n)
    any_keep = keep.any()
    # [1], 0 when nothing is kept. Indexing with a 0-dim tensor would read
    # it to the host; index_select keeps it on the device.
    first = torch.argmax(keep.to(torch.int32)).view(1)
    # nothing kept: every entry rewrites dst[0] with its own value
    fill_idx = torch.where(any_keep, idx.index_select(0, first), 0)
    fill_val = torch.where(any_keep, vals.index_select(0, first), dst[:1])
    bshape = (-1,) + (1,) * (vals.dim() - 1)
    dst.index_put_(
        (torch.where(keep, idx, fill_idx),),
        torch.where(keep.view(bshape), vals, fill_val),
    )
    return dst
