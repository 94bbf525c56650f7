"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE.

M-RoPE splits the rotation frequencies into (temporal, height, width)
sections, each rotated by its own position stream. For text the three
streams are equal, which is RoPE exactly; real (t, h, w) ids plug in."""
from __future__ import annotations

import torch

__all__ = ["rope_frequencies", "apply_rope", "apply_mrope"]


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int. Rotates pairs split at
    dh/2 (HF convention)."""
    dh = x.shape[-1]
    inv = rope_frequencies(dh, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv      # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, *,
                sections: tuple, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, 3, S) for the (t, h, w) streams;
    sections: frequency counts per stream, summing to dh/2."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim/2 = {dh // 2}")
    inv = rope_frequencies(dh, theta, device=x.device)     # (dh/2,)
    # the position stream of each frequency: (B, dh/2, S)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device), output_size=dh // 2)
    pos = positions.to(torch.float32)[:, sec_id, :]
    ang = pos.transpose(1, 2) * inv[None, None, :]          # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)
