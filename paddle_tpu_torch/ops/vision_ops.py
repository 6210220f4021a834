"""The vision functionals of paddle_tpu/ops/vision_ops.py that
nn.functional exports (:133-200, :540-608): grid_sample, affine_grid,
temporal_shift, pixel_unshuffle and fold. The detection ops of that
file (roi_align, prior_box, the NMS family, ...) wait for the detection
slice (ROADMAP Queue 1 item 10).

grid_sample and affine_grid are torch's, whose formulas are the JAX
package's: the grid unnormalised to ((g + 1) * size - 1) / 2, or (g +
1) * (size - 1) / 2 with align_corners; bilinear with zero-weighted
corners outside for "zeros" and edge clamping for "border"; nearest
rounding half to even. padding_mode "reflection" reflects, as Paddle
does; the JAX package clamps it like "border". fold is torch's col2im
with the JAX package's reading of `paddings` (the first two entries).
temporal_shift shifts the first shift_ratio of the channels one
segment back in time, the next shift_ratio one forward, zero-filled.
pixel_unshuffle applies data_format ("NHWC" through a permuted view),
which the JAX package drops."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ..core.dispatch import op

__all__ = ["grid_sample", "affine_grid", "temporal_shift",
           "pixel_unshuffle", "fold"]


@op("grid_sampler")
def _grid_sample(x, grid, mode, padding_mode, align_corners):
    return F.grid_sample(x, grid.to(x.dtype), mode, padding_mode,
                         align_corners)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample NCHW x at grid [N, H', W', 2] (x, y in [-1, 1])."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"mode {mode!r}: expected 'bilinear' or 'nearest'")
    return _grid_sample(x, grid, mode, padding_mode, bool(align_corners))


@op("affine_grid")
def _affine_grid(theta, shape, align_corners):
    return F.affine_grid(theta, list(shape), align_corners)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The [N, H, W, 2] sampling grid of the 2 x 3 affine maps theta."""
    if torch.is_tensor(out_shape):
        out_shape = out_shape.tolist()
    return _affine_grid(theta, tuple(int(s) for s in out_shape),
                        bool(align_corners))


@op("temporal_shift")
def _temporal_shift(x, seg_num, shift_ratio):
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    fwd = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    bwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]], 1)
    return torch.cat([fwd, bwd, v[:, :, c2:]], 2).reshape(nt, c, h, w)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    if data_format == "NHWC":
        out = _temporal_shift(x.permute(0, 3, 1, 2), int(seg_num),
                              float(shift_ratio))
        return out.permute(0, 2, 3, 1)
    return _temporal_shift(x, int(seg_num), float(shift_ratio))


@op("pixel_unshuffle")
def _pixel_unshuffle(x, factor, data_format):
    if data_format == "NHWC":
        return F.pixel_unshuffle(x.permute(0, 3, 1, 2), factor).permute(
            0, 2, 3, 1)
    return F.pixel_unshuffle(x, factor)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _pixel_unshuffle(x, int(downscale_factor), data_format)


@op("fold")
def _fold(x, output_size, kernel, strides, paddings, dilations):
    return F.fold(x, output_size, kernel, dilations, paddings, strides)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """The inverse of unfold: patches [N, C * kh * kw, L] summed back
    into [N, C, H, W]."""
    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)
    pads = (paddings[0], paddings[1]) if isinstance(
        paddings, (list, tuple)) and len(paddings) == 4 else pair(paddings)
    return _fold(x, pair(output_sizes), pair(kernel_sizes), pair(strides),
                 pads, pair(dilations))
