"""Positional encodings and pos-embedding interpolation
(``multihmr_tpu/ops/posenc.py``).

A copy of the JAX package's numpy module, held equal to it by
``tests/test_torch_checkpoint.py``. Two pieces:

* ``get_2d_sincos_pos_embed`` — the MAE/CroCo-style 2D sincos embedding used
  by the Anny-variant decoder (reference multi_hmr_anny/pos_embed.py:12-61).
* ``bicubic_resize_2d`` — exact reimplementation of PyTorch's
  ``F.interpolate(mode='bicubic', align_corners=False)`` (cubic kernel
  a=-0.75, half-pixel mapping, border clamping) needed to interpolate the
  DINOv2 pretraining pos-embedding grid (37x37 for 518/14) to arbitrary patch
  grids, including DINOv2's ``interpolate_offset=0.1`` scale-factor kludge.
  Both are numpy (host-side, run once when a checkpoint is converted); the
  result is stored in the state dict, so nothing here runs in the model.
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """Reference multi_hmr_anny/pos_embed.py:44-61."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=float)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, n_cls_token: int = 0) -> np.ndarray:
    """Reference multi_hmr_anny/pos_embed.py:12-41 (h-emb first, w-emb second)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w goes first
    grid = grid.reshape([2, 1, grid_size, grid_size])
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if n_cls_token > 0:
        pos_embed = np.concatenate(
            [np.zeros([n_cls_token, embed_dim]), pos_embed], axis=0
        )
    return pos_embed


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with PyTorch's a=-0.75."""
    at = np.abs(t)
    at2, at3 = at * at, at * at * at
    w = np.where(
        at <= 1.0,
        (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0,
        np.where(at < 2.0, a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a, 0.0),
    )
    return w


def _bicubic_weights(in_size: int, out_size: int, scale: float | None) -> np.ndarray:
    """Dense 1D interpolation matrix [out_size, in_size].

    Uses half-pixel source mapping ``src = (dst + 0.5) / scale - 0.5`` with
    the *given* scale factor when provided (this is how PyTorch treats an
    explicit ``scale_factor`` with ``recompute_scale_factor=False``, which is
    what DINOv2's interpolate_pos_encoding relies on), falling back to
    out/in. The 4 cubic taps are clamped to the valid range (border
    replication), matching upsample_bicubic2d.
    """
    if scale is None:
        scale = out_size / in_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) / scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for k in range(-1, 3):
        idx = np.clip(i0 + k, 0, in_size - 1)
        w = _cubic_kernel(frac - k)
        np.add.at(W, (dst.astype(np.int64), idx), w)
    return W


def bicubic_resize_2d(
    x: np.ndarray,
    out_h: int,
    out_w: int,
    scale_h: float | None = None,
    scale_w: float | None = None,
) -> np.ndarray:
    """Bicubic resize of ``(..., H, W)`` arrays, bit-matching torch bicubic
    (align_corners=False, no antialias) — the mode DINOv2 uses for its
    pos-embedding interpolation."""
    H, W = x.shape[-2], x.shape[-1]
    Wh = _bicubic_weights(H, out_h, scale_h)
    Ww = _bicubic_weights(W, out_w, scale_w)
    y = np.einsum("oh,...hw->...ow", Wh, x.astype(np.float64))
    y = np.einsum("ow,...hw->...ho", Ww, y)  # (..., out_h, out_w)
    return y


def interpolate_dinov2_pos_embed(
    pos_embed: np.ndarray, grid_size: int, interpolate_offset: float = 0.1
) -> np.ndarray:
    """Resample DINOv2's pretraining pos-embedding to a ``grid_size`` patch grid.

    ``pos_embed`` is ``[1, 1 + N0, D]`` (cls first). Reproduces DINOv2's
    interpolate_pos_encoding: identity when the grid already matches,
    otherwise bicubic with ``scale = (grid_size + offset) / sqrt(N0)``.
    Returns ``[1, 1 + grid_size**2, D]``.
    """
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    n0 = patch_pe.shape[1]
    s0 = int(round(n0**0.5))
    assert s0 * s0 == n0
    if s0 == grid_size:
        return pos_embed
    dim = patch_pe.shape[-1]
    grid = patch_pe.reshape(1, s0, s0, dim).transpose(0, 3, 1, 2)  # [1,D,h,w]
    scale = float(grid_size + interpolate_offset) / s0
    out = bicubic_resize_2d(grid, grid_size, grid_size, scale, scale)
    out = out.transpose(0, 2, 3, 1).reshape(1, grid_size * grid_size, dim)
    return np.concatenate([cls_pe, out.astype(pos_embed.dtype)], axis=1)
