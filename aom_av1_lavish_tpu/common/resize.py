"""Superres / resize: the normative horizontal upscaler.

Reference behavior: av1/common/resize.c av1_upscale_normative_rows
(resize.c:1290), av1/common/convolve.c av1_convolve_horiz_rs_c, with the
q14 step/offset derivation of av1_get_upscale_convolve_step
(resize.c:422) and get_upscale_convolve_x0 (resize.c:426).  The 64-phase
8-tap filter table is extracted from the reference build into
data/av1_tables.npz ("resize_filter_normative").

The kernel is a pure gather + 8-tap dot product per output column —
vectorized over all rows at once (the device analog is one (rows, out_w, 8)
gather feeding a tensordot).
"""

from __future__ import annotations

import numpy as np

from ..bitstream import tables

RS_SUBPEL_BITS = 6
RS_SCALE_SUBPEL_BITS = 14
RS_SCALE_SUBPEL_MASK = (1 << RS_SCALE_SUBPEL_BITS) - 1
RS_SCALE_EXTRA_BITS = RS_SCALE_SUBPEL_BITS - RS_SUBPEL_BITS
RS_SCALE_EXTRA_OFF = 1 << (RS_SCALE_EXTRA_BITS - 1)
UPSCALE_NORMATIVE_TAPS = 8
FILTER_BITS = 7
SCALE_NUMERATOR = 8

SUPERRES_DENOM_MIN = 9
SUPERRES_NUM = 8


def upscale_convolve_step(in_length: int, out_length: int) -> int:
    """av1_get_upscale_convolve_step (q14)."""
    return ((in_length << RS_SCALE_SUBPEL_BITS) + out_length // 2) \
        // out_length


def upscale_convolve_x0(in_length: int, out_length: int,
                        x_step_qn: int) -> int:
    """get_upscale_convolve_x0 (resize.c:426); returns masked q14."""
    err = out_length * x_step_qn - (in_length << RS_SCALE_SUBPEL_BITS)
    # C integer division truncates toward zero
    num = (-((out_length - in_length) << (RS_SCALE_SUBPEL_BITS - 1))
           + out_length // 2)
    x0 = int(num / out_length) + RS_SCALE_EXTRA_OFF - err // 2
    return x0 & RS_SCALE_SUBPEL_MASK


def downscaled_size(upscaled: int, denom: int) -> int:
    """spec 5.9.8: FrameWidth from UpscaledWidth and the superres denom."""
    return (upscaled * SCALE_NUMERATOR + denom // 2) // denom


def upscale_normative_rows(rows: np.ndarray, out_w: int,
                           bd: int = 8, in_w: int | None = None) -> np.ndarray:
    """Upscale (h, src_w) pixel rows to (h, out_w).

    Single-tile form of av1_upscale_normative_rows (pad_left =
    pad_right = 1).  in_w is the logical downscaled plane width that
    the q14 step/offset derive from; when the source carries extra
    valid columns past it (libaom's last tile column ends at the
    mi-aligned width, resize.c:1307 downscaled_x1), those are real
    samples and replication starts after them.
    """
    h, src_w = rows.shape
    if in_w is None:
        in_w = src_w
    filt = tables.get("resize_filter_normative").astype(np.int32)
    x_step_qn = upscale_convolve_step(in_w, out_w)
    x0_qn = upscale_convolve_x0(in_w, out_w, x_step_qn)

    border = UPSCALE_NORMATIVE_TAPS // 2 + 1
    src = np.empty((h, src_w + 2 * border), np.int32)
    src[:, border:border + src_w] = rows
    src[:, :border] = rows[:, :1]
    src[:, border + src_w:] = rows[:, src_w - 1:]

    x_qn = x0_qn + x_step_qn * np.arange(out_w, dtype=np.int64)
    # av1_convolve_horiz_rs_c starts reads at src - taps/2 + 1 - 1
    base = (x_qn >> RS_SCALE_SUBPEL_BITS).astype(np.int64) \
        + border - (UPSCALE_NORMATIVE_TAPS // 2 - 1) - 1
    phase = ((x_qn & RS_SCALE_SUBPEL_MASK) >> RS_SCALE_EXTRA_BITS) \
        .astype(np.int64)
    idx = base[:, None] + np.arange(UPSCALE_NORMATIVE_TAPS)[None, :]
    gathered = src[:, idx]                          # (h, out_w, 8)
    coeffs = filt[phase]                            # (out_w, 8)
    s = (gathered * coeffs[None]).sum(-1)
    out = (s + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return np.clip(out, 0, (1 << bd) - 1).astype(rows.dtype)


def superres_upscale_plane(plane: np.ndarray, out_w: int,
                           bd: int = 8) -> np.ndarray:
    """Upscale a whole plane horizontally (superres_post_decode analog)."""
    return upscale_normative_rows(plane, out_w, bd)


def downscale_plane_horz(plane: np.ndarray, out_w: int) -> np.ndarray:
    """Encoder-side horizontal downscale to the superres coded width.

    Non-normative (reference analog: av1_resize_plane's interpolating
    filters in superres_scale.c av1_superres_post_encode's inverse
    direction); any decent lowpass works for conformance since only the
    coded samples ship.  Bilinear in q14."""
    h, in_w = plane.shape
    if out_w == in_w:
        return plane.copy()
    step = (in_w << 14) // out_w
    x = (np.arange(out_w, dtype=np.int64) * step + step // 2 - (1 << 13))
    x = np.clip(x, 0, (in_w - 1) << 14)
    xi = x >> 14
    frac = x & ((1 << 14) - 1)
    xi1 = np.minimum(xi + 1, in_w - 1)
    p = plane.astype(np.int64)
    out = (p[:, xi] * ((1 << 14) - frac) + p[:, xi1] * frac
           + (1 << 13)) >> 14
    return out.astype(plane.dtype)
