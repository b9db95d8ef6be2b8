"""Stable ascending top-k (counterpart of ``dial_rag_tpu/ops/stable_topk.py``).

The reference ranks with a *stable* sort: among equal scores the earlier
row wins, and the retrieval goldens depend on it. ``torch.topk`` gives no
such order, so two exact forms are used instead:

- ``stable_topk_argmin``: k sweeps that each take the first index of the
  minimum of an order-preserving int32 key (NaN -> +inf first). A taken
  entry gets a key above that of +inf, so real +inf distances still rank;
- ``stable_topk_sort``: ``torch.sort(stable=True)``, for k above
  ``ARGMIN_MAX_K``.

Both work on the last axis of a [..., N] tensor and return
``(values, indices)`` with NaN reported as +inf.
"""

import torch

# Above this k the full sort beats k argmin sweeps.
ARGMIN_MAX_K = 32

_TAKEN = torch.iinfo(torch.int32).max  # above the key of +inf (0x7F800000)


def _sanitize(values: torch.Tensor) -> torch.Tensor:
    values = values.float()
    return torch.where(torch.isnan(values), torch.inf, values)


def _sortable_key(values: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> int32 map: ascending key order == ascending float
    (negative floats have their 31 low bits flipped), as the reference's
    uint32 key orders them."""
    bits = values.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def stable_topk_argmin(values: torch.Tensor, k: int):
    vals = _sanitize(values)
    n = vals.shape[-1]
    k = min(k, n)
    keys = _sortable_key(vals).clone()
    iota = torch.arange(n, device=vals.device).expand_as(keys)
    picks = []
    for _ in range(k):
        low = keys.amin(dim=-1, keepdim=True)
        # first occurrence of the minimum, written out rather than trusting
        # a backend's argmin tie order
        first = torch.where(keys == low, iota, n).amin(dim=-1, keepdim=True)
        keys.scatter_(-1, first, _TAKEN)
        picks.append(first)
    idx = torch.cat(picks, dim=-1) if picks else iota[..., :0]
    return torch.gather(vals, -1, idx), idx


def stable_topk_sort(values: torch.Tensor, k: int):
    vals = _sanitize(values)
    k = min(k, vals.shape[-1])
    sorted_vals, sorted_idx = torch.sort(vals, dim=-1, stable=True)
    return sorted_vals[..., :k], sorted_idx[..., :k]


def stable_topk(values: torch.Tensor, k: int):
    """The k smallest along the last axis, earliest index first on ties."""
    if k <= ARGMIN_MAX_K:
        return stable_topk_argmin(values, k)
    return stable_topk_sort(values, k)
