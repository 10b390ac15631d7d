"""Ulysses-style sequence parallelism: all-to-all seq↔head re-sharding.

The counterpart of ``routest_tpu/parallel/ulysses.py``. Instead of
rotating K/V blocks, one :func:`~routest_tpu_torch.core.smap.all_to_all`
turns the sequence sharding into a head sharding — every shard then
attends over the whole sequence for its slice of heads (streamed
blockwise, :func:`~routest_tpu_torch.parallel.ring.blockwise_attention`)
— and a second all-to-all restores the sequence sharding. Four
all-to-alls (q, k, v, out) plus an all-gather of the key mask when one
is given, whatever the mesh size; the trade is ``n_heads % axis_size
== 0`` and full-sequence K/V per shard.
"""

from __future__ import annotations

from typing import Optional

import torch

from routest_tpu_torch.core import smap
from routest_tpu_torch.parallel.ring import (blockwise_attention,
                                             full_attention,
                                             sharded_attention)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, axis_name: str, axis_size: int,
                      key_mask: Optional[torch.Tensor] = None,
                      causal: bool = False) -> torch.Tensor:
    """Per-shard program: (B, S_local, H, D) in, the same shape out. Call
    inside ``shard_map`` with the sequence axis sharded over
    ``axis_name``. Needs H % axis_size == 0."""
    if axis_size == 1:
        return full_attention(q, k, v, key_mask, causal)
    if q.shape[2] % axis_size:
        raise ValueError(
            f"n_heads={q.shape[2]} not divisible by axis_size={axis_size}")

    def seq_to_heads(x):  # (B, S/n, H, D) → (B, S, H/n, D)
        return smap.all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    def heads_to_seq(x):  # (B, S, H/n, D) → (B, S/n, H, D)
        return smap.all_to_all(x, axis_name, split_axis=1, concat_axis=2)

    q_h, k_h, v_h = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    full_mask = None
    if key_mask is not None:
        full_mask = smap.all_gather(key_mask, axis_name, axis=1, tiled=True)
    out = blockwise_attention(q_h, k_h, v_h, full_mask, causal)
    return heads_to_seq(out)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mesh, seq_axis: str = "seq",
                              data_axis: Optional[str] = None,
                              key_mask: Optional[torch.Tensor] = None,
                              causal: bool = False) -> torch.Tensor:
    """Convenience wrapper over whole (B, S, H, D) tensors (cf. ring)."""
    return sharded_attention(ulysses_attention, q, k, v, mesh, seq_axis,
                             data_axis, key_mask, causal)
