"""Device (JAX/XLA) batched analyze path for the lossless all-intra encoder.

Design note (batched, not a port): in lossless coding recon == source for
every coded block, so the per-4x4 DC prediction, residual, Walsh-Hadamard
transform and quantization have NO sequential dependency — the whole frame
is one batched integer tensor program (vector-friendly int32 ops, static
shapes).  Only per-tile entropy coding remains sequential and runs on host
(native C fast path planned).  The reference computes all of this scalar,
block-by-block inside the RDO loop (av1/encoder/encodeframe.c).

Bit-exactness: cross-checked against common/txfm.py + common/intra.py in
tests/test_ops_lossless.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _wht_fwd_stage(a1, b1, c1, d1):
    a1 = a1 + b1
    d1 = d1 - c1
    e1 = (a1 - d1) >> 1
    b1 = e1 - b1
    c1 = e1 - c1
    a1 = a1 - c1
    d1 = d1 + b1
    return a1, b1, c1, d1


def fwht4x4_batched(resid):
    """Forward WHT over (..., 4, 4) int32 residuals; returns flat-layout
    coefficients (..., 4, 4) where out[..., k, i] matches the reference's
    output[4k + i] (see common/txfm.py for the layout contract)."""
    x = resid.astype(jnp.int32)
    # pass 1: butterfly down each input column i; interm[i, j] holds the
    # j-th of (a, c, d, b) for column i
    a1, b1, c1, d1 = _wht_fwd_stage(x[..., 0, :], x[..., 1, :],
                                    x[..., 2, :], x[..., 3, :])
    t = jnp.stack([a1, c1, d1, b1], axis=-1)  # (..., i, j)
    # pass 2: per i, stage inputs (a,b,c,d) = interm[0..3, i] = t[..,k,i];
    # flat output[4k + i] = k-th of (a, c, d, b) for that i
    a1, b1, c1, d1 = _wht_fwd_stage(t[..., 0, :], t[..., 1, :],
                                    t[..., 2, :], t[..., 3, :])
    out = jnp.stack([a1, c1, d1, b1], axis=-2)  # out[..., k, i]
    return out << 2


@partial(jax.jit, static_argnames=())
def lossless_plane_analyze(src, tile_col_starts4=None):
    """Batched per-4x4 DC-predict + WHT + quantize for one plane.

    src: (H, W) uint8 (H, W multiples of 4).  Returns
    (qcoeff (H/4, W/4, 16) int32, zero (H/4, W/4) bool).

    Availability rule (lossless, single tile): have_top ⇔ py > 0,
    have_left ⇔ px > 0, since recon == source makes every previously-coded
    neighbor equal to the source.
    """
    H, W = src.shape
    h4, w4 = H // 4, W // 4
    s = src.astype(jnp.int32)
    blocks = s.reshape(h4, 4, w4, 4).transpose(0, 2, 1, 3)  # (h4, w4, 4, 4)

    # above row sums: sum of src[py-1, px:px+4] for each block
    above = jnp.pad(s, ((1, 0), (0, 0)))[:-1]  # row py-1 (row 0 -> garbage)
    above_rows = above.reshape(h4, 4, w4, 4)[:, 0]  # (h4, w4, 4)
    sum_above = above_rows.sum(-1)
    left = jnp.pad(s, ((0, 0), (1, 0)))[:, :-1]
    left_cols = left.reshape(h4, 4, w4, 4)[:, :, :, 0]  # (h4, 4col?, w4)
    sum_left = left_cols.sum(1)

    row_ids = jnp.arange(h4)[:, None]
    col_ids = jnp.arange(w4)[None, :]
    have_top = jnp.broadcast_to(row_ids > 0, (h4, w4))
    have_left = jnp.broadcast_to(col_ids > 0, (h4, w4))

    dc_both = (sum_above + sum_left + 4) >> 3
    dc_top = (sum_above + 2) >> 2
    dc_left = (sum_left + 2) >> 2
    dc = jnp.where(have_top & have_left, dc_both,
                   jnp.where(have_top, dc_top,
                             jnp.where(have_left, dc_left, 128)))

    resid = blocks - dc[..., None, None]
    coeff = fwht4x4_batched(resid)
    q = coeff >> 2  # lossless quantization: exact /4 (coeff is a multiple)
    qflat = q.reshape(h4, w4, 16)
    zero = jnp.all(qflat == 0, axis=-1)
    return qflat, zero


def lossless_frame_analyze(y, u, v):
    """Analyze all three planes; returns per-plane (qcoeff, zero)."""
    return (lossless_plane_analyze(y), lossless_plane_analyze(u),
            lossless_plane_analyze(v))


lossless_frame_analyze_jit = jax.jit(lossless_frame_analyze)


def analyze_for_encoder(planes):
    """Host-friendly wrapper: numpy in/out for the encoder integration."""
    rs = lossless_frame_analyze_jit(*[jnp.asarray(p) for p in planes])
    return [(np.asarray(q), np.asarray(z)) for (q, z) in rs]


@jax.jit
def _lossless_batch_analyze(ys, us, vs):
    """(N, H, W) stacked planes -> vmapped per-frame analyze.

    Coefficients are returned as int16 (lossless 4x4 WHT/4 of 8-bit
    residuals fits 13 bits) to halve the device->host transfer."""
    qy, _ = jax.vmap(lossless_plane_analyze)(ys)
    qu, _ = jax.vmap(lossless_plane_analyze)(us)
    qv, _ = jax.vmap(lossless_plane_analyze)(vs)
    return (qy.astype(jnp.int16), qu.astype(jnp.int16),
            qv.astype(jnp.int16))


def analyze_frames_for_encoder(frame_planes):
    """Batched multi-frame analyze: one jit call + one transfer for a
    whole sequence (amortizes device dispatch latency).

    frame_planes: list of (y, u, v) same-shape numpy planes (mi-aligned).
    Returns a list (per frame) of per-plane (qcoeff, zero) entries; zero
    flags are not materialized (the tile walkers test qcoeff directly).
    """
    ys = jnp.asarray(np.stack([f[0] for f in frame_planes]))
    us = jnp.asarray(np.stack([f[1] for f in frame_planes]))
    vs = jnp.asarray(np.stack([f[2] for f in frame_planes]))
    from ..utils.xfer import fetch
    qy, qu, qv = fetch(*_lossless_batch_analyze(ys, us, vs))
    return [[(qy[i], None), (qu[i], None), (qv[i], None)]
            for i in range(len(frame_planes))]


def analyze_tiled_for_encoder(planes, row_ranges, col_ranges):
    """Per-tile analyze: DC prediction availability resets at tile edges
    (AV1 tiles are fully independent).  Each tile slice goes through the
    SAME per-plane analyze — a tile's local (0, 0) origin gives exactly
    the in-tile availability rule.

    row_ranges/col_ranges: luma pixel [start, end) per tile row/col.
    Returns per-plane (qcoeff (h4, w4, 16) int32, None) for the whole
    frame, assembled from the per-tile results.
    """
    out = []
    for pi, p in enumerate(planes[:3]):
        ss = 1 if pi else 0
        h4, w4 = p.shape[0] // 4, p.shape[1] // 4
        q = np.zeros((h4, w4, 16), np.int32)
        for (r0, r1) in row_ranges:
            for (c0, c1) in col_ranges:
                pr0, pr1 = r0 >> ss, r1 >> ss
                pc0, pc1 = c0 >> ss, c1 >> ss
                qt, _ = lossless_plane_analyze(p[pr0:pr1, pc0:pc1])
                q[pr0 >> 2:pr1 >> 2, pc0 >> 2:pc1 >> 2] = np.asarray(qt)
        out.append((q, None))
    return out
