"""The reference's tap gather: plain advanced indexing (autograd gives its
transpose), and the row map of a one-device frame."""

from __future__ import annotations

import torch

PAD = 8   # the window bound the program's gather keeps; unused here


def local_row(gy, ext_row0: int, ext_h: int):
    """Clamped rows -> rows of a buffer that starts at row ext_row0."""
    return torch.clamp(gy - ext_row0, 0, ext_h - 1)


def gather_local(payload, tys, txs, *_args, **_kwargs):
    """payload[tys, txs, :] -> (K, H, W, C)."""
    return payload[tys.long(), txs.long()]
