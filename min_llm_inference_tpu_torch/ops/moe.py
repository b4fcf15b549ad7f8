"""Routed experts with static shapes, for a CUDA graph: the router, the
dispatch (a device-side sort of the token-expert pairs by expert, with the
experts' row offsets), the grouped SwiGLU over the sorted rows, and the
weighted combine.

Every call routes T tokens to k experts each and computes exactly T x k
rows, whatever the routing: no shape depends on the data and nothing is
read to the host. The grouped product (``grouped_swiglu``) goes to
``torch._grouped_mm`` for CUDA tensors (bfloat16, one CUTLASS grouped GEMM
a projection, offsets read on the device) and to a loop over the experts
for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def route(x, w_router, top_k: int, norm_topk_prob: bool = False,
          scaling: float = 1.0):
    """DeepSeek-V2's gate: float32 logits x W_router, softmax over the
    experts, the ``top_k`` largest weights (greedy), renormalised only
    with ``norm_topk_prob``, times ``scaling``. Returns (weights [T, k]
    float32, expert ids [T, k] int64)."""
    scores = torch.softmax(torch.matmul(x.float(), w_router.float()), dim=-1)
    w, idx = torch.topk(scores, top_k, dim=-1)
    if norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * scaling, idx


def dispatch(idx, n_experts: int):
    """The token-expert pairs ``idx`` [T, k] sorted by expert (stable):
    (order [T k]: each sorted row's flat pair index t k + j, ends [E]
    int32: the cumulative row count of experts 0 .. e)."""
    flat = idx.reshape(-1)
    sorted_e, order = torch.sort(flat, stable=True)
    bounds = torch.arange(1, n_experts + 1, device=idx.device,
                          dtype=sorted_e.dtype)
    ends = torch.searchsorted(sorted_e, bounds).to(torch.int32)
    return order, ends


def grouped_swiglu(xs, ends, w_gate_up, w_down):
    """Rows xs [N, D] sorted by expert, expert e owning rows ends[e-1] ..
    ends[e] - 1: each row's expert's W_down (silu(x W_gate) * (x W_up)),
    w_gate_up [E, D, 2F] (gate first), w_down [E, F, D]. Returns [N, D] in
    xs's dtype (float32 accumulation inside each product)."""
    Fh = w_down.shape[1]
    if xs.device.type == "cpu":
        out = torch.empty((xs.shape[0], w_down.shape[2]), dtype=xs.dtype)
        start = 0
        for e, end in enumerate(ends.tolist()):
            x = xs[start:end]
            gu = torch.matmul(x, w_gate_up[e])
            out[start:end] = torch.matmul(
                F.silu(gu[:, :Fh]) * gu[:, Fh:], w_down[e])
            start = end
        return out
    gu = torch._grouped_mm(xs, w_gate_up, offs=ends)
    act = F.silu(gu[:, :Fh]) * gu[:, Fh:]
    out = torch._grouped_mm(act, w_down, offs=ends)
    _build.count_launch(grouped_swiglu)
    return out


# CUDA calls since the last reset (two grouped products a call)
_build.counted(grouped_swiglu)


def swiglu(x, w_gate_up, w_down):
    """A dense SwiGLU: W_down (silu(x W_gate) * (x W_up)), w_gate_up
    [D, 2F] gate first."""
    gu = torch.matmul(x, w_gate_up)
    f = gu.shape[-1] // 2
    return torch.matmul(F.silu(gu[..., :f]) * gu[..., f:], w_down)


def routed_experts(x, w_router, w_gate_up, w_down, top_k: int,
                   norm_topk_prob: bool = False, scaling: float = 1.0,
                   counts=None):
    """The routed experts of x [T, D]: each token's weighted sum of its
    top-k experts' SwiGLU outputs (each output in x's dtype, the sum in
    float32, as the published combine), returned in x's dtype.
    ``counts`` (int64 [2] on x's device, or None): adds the call's rows
    (T k) and its largest expert's rows."""
    T, D = x.shape
    E = w_router.shape[1]
    w, idx = route(x, w_router, top_k, norm_topk_prob, scaling)
    order, ends = dispatch(idx, E)
    ys = grouped_swiglu(x[torch.div(order, top_k, rounding_mode="floor")],
                        ends, w_gate_up, w_down)
    y = torch.empty_like(ys).index_copy_(0, order, ys).view(T, top_k, D)
    acc = y[:, 0].float() * w[:, :1]
    for j in range(1, top_k):
        acc += y[:, j].float() * w[:, j:j + 1]
    if counts is not None:
        counts[:1].add_(T * top_k)
        rows = torch.diff(ends, prepend=ends.new_zeros(1))
        counts[1:].add_(rows.max().to(torch.int64))
    return acc.to(x.dtype)
