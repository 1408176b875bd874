"""Rotary position embeddings (RoPE), fp32 rotation of the two halves of the
head dim (not interleaved); counterpart of ``repro/nn/rope.py``."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, *, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                      # (head_dim // 2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` (..., seq, heads, head_dim) by ``positions`` (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta=theta, device=x.device)
    angles = positions[..., :, None].float() * freqs     # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]             # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
