"""Ring attention: exact attention over a mesh-sharded sequence axis.

The counterpart of ``routest_tpu/parallel/ring.py``. Each shard holds
one block of the sequence. K/V blocks travel around the ring
(:func:`~routest_tpu_torch.core.smap.ppermute`) while every shard
accumulates attention for its resident queries with an online softmax —
the running max/denominator rescaling that makes blockwise attention
exact. After ``axis_size`` hops every query has seen every key, and no
shard ever materialized more than a (local_q × local_k) score tile.

The tile update is the JAX one op for op: scores in float32, masked
entries filled with the finite ``_NEG = -1e30`` (an all-masked tile
stays NaN-free), the probabilities re-masked by multiplication (on an
all-masked tile ``exp(NEG - NEG) = 1`` would otherwise add phantom
mass), the running max, denominator and accumulator in float32, the
resident block first and then ``axis_size - 1`` hops. A fully masked
query row comes out 0. ``scaled_dot_product_attention`` differs from
:func:`full_attention` on such rows, so neither uses it.

Layouts: q/k/v are (B, S, H, D); masks are (B, S) with 1.0 = a real
token. :func:`ring_attention` is the per-shard program (call it inside
``shard_map`` with the sequence axis sharded);
:func:`ring_attention_sharded` wraps it for callers holding whole
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from routest_tpu_torch.core import smap
from routest_tpu_torch.core.smap import P, shard_map

_NEG = -1e30  # finite "minus infinity": exp() stays NaN-free on masked tiles
DEFAULT_CHUNK = 1024  # blockwise K/V streaming granularity


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Single-device reference: (B, S, H, D) → (B, S, H, D). The oracle
    the ring and Ulysses must match up to summation order; also the
    program when the axis has one shard."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(s.shape[-1], dtype=torch.bool,
                      device=s.device)[None, None, None, :]
    if key_mask is not None:
        mask = mask & (key_mask[:, None, None, :] > 0)
    if causal:
        q_pos = torch.arange(q.shape[1], device=s.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=s.device)[None, :]
        mask = mask & (q_pos >= k_pos)[None, None]
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1) * mask
    denom = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    p = p / denom * torch.clamp(mask.sum(-1, keepdim=True), 0, 1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _tile_update(q, k_blk, v_blk, km, acc, m, denom, scale, causal,
                 q_pos, k_pos):
    """One K/V tile into the online softmax (f32 state)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    tile_mask = None if km is None else km[:, None, None, :] > 0
    if causal:
        cmask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        tile_mask = cmask if tile_mask is None else tile_mask & cmask
    if tile_mask is not None:
        s = torch.where(tile_mask, s, torch.full_like(s, _NEG))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    if tile_mask is not None:
        p = p * tile_mask
    correction = torch.exp(m - m_new)
    denom = denom * correction + p.sum(-1)
    acc = acc * correction[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk.float())
    return acc, m_new, denom


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        scale: Optional[float] = None,
                        chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Exact attention that never materializes the (S, S) scores: K/V
    stream through in ``chunk``-sized blocks under the ring's online
    softmax. Each block is checkpointed when gradients are on (the JAX
    scan body is ``jax.checkpoint``-ed), so training stays at
    O(S·chunk) score memory. Same layouts and semantics as
    :func:`full_attention`; ``S <= chunk`` takes it directly."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if s_k <= chunk:
        return full_attention(q, k, v, key_mask, causal, scale)
    scale = scale if scale is not None else d ** -0.5
    n_chunks = (s_k + chunk - 1) // chunk
    pad = n_chunks * chunk - s_k
    km = (torch.ones((b, s_k), dtype=q.dtype, device=q.device)
          if key_mask is None else key_mask.to(q.dtype))
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        km = torch.nn.functional.pad(km, (0, pad))
    q_pos = torch.arange(s_q, device=q.device)
    acc = torch.zeros((b, h, s_q, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_q), _NEG, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, s_q), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_pos = torch.arange(i * chunk, (i + 1) * chunk, device=q.device)
        args = (q, k[:, sl], v[:, sl], km[:, sl], acc, m, denom)

        def body(q, kb, vb, kmb, acc, m, denom, _k_pos=k_pos):
            return _tile_update(q, kb, vb, kmb, acc, m, denom, scale,
                                causal, q_pos, _k_pos)

        if torch.is_grad_enabled():
            acc, m, denom = torch.utils.checkpoint.checkpoint(
                body, *args, use_reentrant=False)
        else:
            acc, m, denom = body(*args)
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   *, axis_name: str, axis_size: int,
                   key_mask: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Per-shard ring attention; call inside ``shard_map``.

    q/k/v: (B, S_local, H, D) — this shard's sequence block. key_mask:
    (B, S_local) for the local key block (it rotates with K/V). Returns
    (B, S_local, H, D) for the resident queries."""
    if axis_size == 1:
        return full_attention(q, k, v, key_mask, causal, scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    my = smap.axis_index(axis_name)
    perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    km = None if key_mask is None else key_mask.to(q.dtype)
    q_pos = my * s_q + torch.arange(s_q, device=q.device)
    acc = torch.zeros((b, h, s_q, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_q), _NEG, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, s_q), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    # resident block first, then axis_size - 1 rotate+compute hops (no
    # final dead rotation); the mask travels only when there is one
    for step in range(axis_size):
        if step:
            k_blk = smap.ppermute(k_blk, axis_name, perm)
            v_blk = smap.ppermute(v_blk, axis_name, perm)
            if km is not None:
                km = smap.ppermute(km, axis_name, perm)
        # after `step` hops this shard holds the block born on my - step
        src = (my - step) % axis_size
        k_pos = src * s_k + torch.arange(s_k, device=q.device)
        acc, m, denom = _tile_update(q, k_blk, v_blk, km, acc, m, denom,
                                     scale, causal, q_pos, k_pos)
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def sharded_attention(attn_fn, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, mesh, seq_axis: str,
                      data_axis: Optional[str],
                      key_mask: Optional[torch.Tensor],
                      causal: bool) -> torch.Tensor:
    """The shared ``shard_map`` wrapper of the per-shard attention
    programs: a masked call adds the mask input, an unmasked one omits
    it, so the program skips its mask collectives."""
    axis_size = mesh.shape[seq_axis]
    qkv_spec = P(data_axis, seq_axis, None, None)
    specs = (qkv_spec, qkv_spec, qkv_spec)
    args = (q, k, v)
    if key_mask is not None:
        specs += (P(data_axis, seq_axis),)
        args += (key_mask,)

    def run(q, k, v, *maybe_mask):
        return attn_fn(q, k, v, axis_name=seq_axis, axis_size=axis_size,
                       key_mask=maybe_mask[0] if maybe_mask else None,
                       causal=causal)

    return shard_map(run, mesh, specs, qkv_spec)(*args)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, seq_axis: str = "seq",
                           data_axis: Optional[str] = None,
                           key_mask: Optional[torch.Tensor] = None,
                           causal: bool = False) -> torch.Tensor:
    """Shard the sequence axis of whole (B, S, H, D) tensors and run the
    ring. The mesh's ``seq_axis`` size must divide S; the batch
    optionally shards over ``data_axis``."""
    return sharded_attention(ring_attention, q, k, v, mesh, seq_axis,
                             data_axis, key_mask, causal)
