"""Device kernels of the inter path: motion-search cost volumes and the
motion-compensation reads.

  * ssd_surface    — exhaustive full-pel SSD cost volume (aom_dsp/sad.c /
                     variance.c families; the hot loop of
                     av1_full_pixel_search, av1/encoder/mcomp.c:1755)
  * gather_windows — per-block window reads of every motion-compensation
                     site
  * convolve_8tap  — batched subpel motion compensation
                     (av1/common/convolve.c:133 av1_convolve_2d_sr_c)

Each is a plain jnp/lax body that XLA compiles on every platform.  A
hand-written Pallas kernel belongs here only once it beats that body end
to end on the GPU; PERF.md keeps the timings of the ones tried.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: float32 represents every integer below this exactly
_F32_EXACT = 1 << 24


# ---------------------------------------------------------------------------
# 1. SSD cost surface (motion search)


def _corr(src, win, bsz: int, peak: int):
    """Exact per-block cross-correlation (B, S, S) int32 as a grouped
    float32 convolution.  A sum of bsz*bsz products of values <= peak is
    exact in float32 while it stays below 2**24; above that (the
    half-resolution pass: 64 * 1020**2) the window splits into its high
    and low 5 bits, and each half's sums stay exact."""
    B = src.shape[0]
    srcf = src.astype(jnp.float32)[:, None]

    def conv(w):
        return jax.lax.conv_general_dilated(
            w.astype(jnp.float32)[None], srcf, window_strides=(1, 1),
            padding="VALID", feature_group_count=B,
            precision=jax.lax.Precision.HIGHEST)[0].astype(jnp.int32)

    if bsz * bsz * peak * peak < _F32_EXACT:
        return conv(win)
    assert peak < 1024 and bsz * bsz * peak * 31 < _F32_EXACT
    return (conv(win >> 5) << 5) + conv(win & 31)


def ssd_surface(src_blk, win, bsz: int, radius: int, peak: int = 255):
    """(B,bsz,bsz) source blocks x (B,W,W) search windows ->
    (B, 2r+1, 2r+1) float32 SSD surface, W = 2r + bsz, every pixel in
    [0, peak].  The surface is computed exactly in int32 through
    ssd = sum(src^2) + sum(win^2)[dy,dx] - 2*corr[dy,dx]; the float32
    result is exact below 2**24 and rounded to nearest above."""
    src = src_blk.astype(jnp.int32)
    w = win.astype(jnp.int32)
    corr = _corr(src, w, bsz, peak)
    e_ref = jax.lax.reduce_window(w * w, 0, jax.lax.add, (1, bsz, bsz),
                                  (1, 1, 1), "VALID")
    e_src = (src * src).sum((1, 2))
    return (e_src[:, None, None] + e_ref - 2 * corr).astype(jnp.float32)


# ---------------------------------------------------------------------------
# 2. Window gather (the read side of every motion-compensation site)


def gather_windows(plane, base_r, base_c, wr: int, wc: int):
    """plane (H', W'); base_r/base_c (B,) int32 -> (B, wr, wc) windows
    at dynamic per-block origins (in-bounds guaranteed by callers)."""
    rr = base_r[:, None, None] + jnp.arange(wr)[None, :, None]
    cc = base_c[:, None, None] + jnp.arange(wc)[None, None, :]
    return plane[rr, cc]


# ---------------------------------------------------------------------------
# 3. 8-tap separable subpel convolve (motion compensation)


def convolve_8tap(region, kx, ky, bh: int, bw: int):
    """Batched 8-bit av1_convolve_2d_sr: region (B, bh+7, bw+7) int32,
    per-block taps kx/ky (B, 8) -> (B, bh, bw) uint8."""
    acc = jnp.zeros(region.shape[:1] + (bh + 7, bw), jnp.int32)
    for k in range(8):
        acc = acc + kx[:, k, None, None] * region[:, :, k:k + bw]
    im = (acc + (1 << 14) + (1 << 2)) >> 3
    acc2 = jnp.zeros(region.shape[:1] + (bh, bw), jnp.int32)
    for k in range(8):
        acc2 = acc2 + ky[:, k, None, None] * im[:, k:k + bh, :]
    sum_ = acc2 + (1 << 19) + (1 << 10)
    res = (sum_ >> 11) - ((1 << 8) + (1 << 7))
    return jnp.clip(res, 0, 255).astype(jnp.uint8)
