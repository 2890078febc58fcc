"""ALTREF temporal filtering — MC-weighted multi-frame denoise.

Batched re-design of av1_temporal_filter
(/root/reference/av1/encoder/temporal_filter.c:1284): before coding an
ARF (or key frame), replace its source with a motion-compensated
weighted average over a window of neighbor frames, so the boosted-q
anchor spends its bits on signal instead of noise.

Design inversion vs the reference: libaom walks 32x32 blocks serially
(mb loop, tf_do_filtering_row) with per-block subpel search and a
scalar per-pixel weight loop; here every (neighbor, block) pair is
scored in one batched SSD cost volume (lax.scan over the offset grid),
and the per-pixel weights for all neighbors are one fused elementwise
expression over (n, H, W) arrays — accelerator-friendly, no Python in the
hot path.

Weight model (tf_compute_weight analog): w = exp(-D / (2 sigma_q^2))
where D is the 3x3-windowed mean squared alignment error and sigma_q
scales with the quantizer (noise at the target quality), matching the
reference's q-adaptive strength (temporal_filter.c:1040
tf_estimate_noise + adjust_filter_strength behavior).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

BLOCK = 16
RADIUS = 8          # full-pel search radius per neighbor


@lru_cache(maxsize=None)
def _tf_fn(key):
    import jax
    import jax.numpy as jnp

    H, W, n = key

    Hb, Wb = H // BLOCK, W // BLOCK

    def fn(center, neighbors):
        """center (H, W) f32; neighbors (n, H, W) f32.
        Returns (mvs (n, Hb, Wb, 2) int32, aligned (n, H, W) f32).
        The per-neighbor cost volume runs on the device
        (ops/inter_tpu.block_cost_volume) instead of a 289-offset
        shifted-plane scan."""
        from ..ops.inter_tpu import block_cost_volume

        side = 2 * RADIUS + 1

        def one_vol(nb):
            ssd = block_cost_volume(center, nb, BLOCK, RADIUS)
            idx = jnp.argmin(ssd.reshape(Hb * Wb, side * side), axis=1)
            return jnp.stack([idx // side - RADIUS, idx % side - RADIUS],
                             axis=-1).reshape(Hb, Wb, 2)

        mvs = jax.vmap(one_vol)(neighbors)    # (n, Hb, Wb, 2)
        aligned = _align(jnp, jax, neighbors, mvs, BLOCK)
        return mvs, aligned

    return jax.jit(fn)


def _align(jnp, jax, planes, mvs, blk):
    """Gather per-block motion-aligned pixels: planes (n, H, W), mvs
    (n, Hb, Wb, 2) in plane-pel units -> (n, H, W)."""
    n, H, W = planes.shape
    pad = jnp.pad(planes, ((0, 0), (RADIUS, RADIUS), (RADIUS, RADIUS)),
                  mode="edge")
    mv_field = jnp.repeat(jnp.repeat(mvs, blk, axis=1), blk, axis=2)
    mv_field = mv_field[:, :H, :W]
    yy, xx = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
    ny = jnp.clip(yy[None] + mv_field[..., 0] + RADIUS, 0,
                  H + 2 * RADIUS - 1)
    nx = jnp.clip(xx[None] + mv_field[..., 1] + RADIUS, 0,
                  W + 2 * RADIUS - 1)
    return jax.vmap(lambda p, iy, ix: p[iy, ix])(pad, ny, nx)


def _blend(jnp, jax, center, aligned, sigma2):
    d2 = (aligned - center[None]) ** 2
    # 3x3 windowed mean of the alignment error (tf per-pixel window)
    k = jnp.ones((3, 3), jnp.float32) / 9.0
    win = jax.vmap(lambda img: jax.scipy.signal.convolve2d(
        img, k, mode="same"))(d2)
    w = jnp.exp(-win / (2.0 * sigma2))
    num = center + (w * aligned).sum(axis=0)
    den = 1.0 + w.sum(axis=0)
    return num / den


@lru_cache(maxsize=None)
def _blend_fn(key):
    import jax
    import jax.numpy as jnp

    def fn(center, aligned, sigma2):
        return _blend(jnp, jax, center, aligned, sigma2)

    return jax.jit(fn)


@lru_cache(maxsize=None)
def _tf_full_fn(key):
    """One jitted program for the whole 4:2:0 temporal filter: luma
    device cost volumes, chroma reusing the halved luma MVs — the
    reference's per-plane MV sharing (temporal_filter.c
    tf_build_predictor applies the block MV to all planes)."""
    import jax
    import jax.numpy as jnp

    H, W, n = key
    Hb, Wb = H // BLOCK, W // BLOCK

    def fn(cy, cu, cv, ny_, nu, nv, sigma2):
        from ..ops.inter_tpu import block_cost_volume

        side = 2 * RADIUS + 1

        def one_vol(nb):
            ssd = block_cost_volume(cy, nb, BLOCK, RADIUS)
            idx = jnp.argmin(ssd.reshape(Hb * Wb, side * side), axis=1)
            return jnp.stack([idx // side - RADIUS, idx % side - RADIUS],
                             axis=-1).reshape(Hb, Wb, 2)

        mvs = jax.vmap(one_vol)(ny_)
        out_y = _blend(jnp, jax, cy, _align(jnp, jax, ny_, mvs, BLOCK),
                       sigma2)
        mv_c = jnp.sign(mvs) * (jnp.abs(mvs) // 2)
        out_u = _blend(jnp, jax, cu,
                       _align(jnp, jax, nu, mv_c, BLOCK // 2), sigma2)
        out_v = _blend(jnp, jax, cv,
                       _align(jnp, jax, nv, mv_c, BLOCK // 2), sigma2)
        return out_y, out_u, out_v

    return jax.jit(fn)


def _filter_plane(center, neighbors, sigma2):
    """center (H, W) uint8, neighbors list of (H, W) uint8."""
    n = len(neighbors)
    H, W = center.shape
    Hc, Wc = (H // BLOCK) * BLOCK, (W // BLOCK) * BLOCK
    c32 = center[:Hc, :Wc].astype(np.float32)
    nb = np.stack([x[:Hc, :Wc] for x in neighbors]).astype(np.float32)
    _, aligned = _tf_fn((Hc, Wc, n))(c32, nb)
    out = _blend_fn((Hc, Wc))(c32, np.asarray(aligned),
                              np.float32(sigma2))
    res = center.astype(np.float32).copy()
    res[:Hc, :Wc] = np.asarray(out)
    return np.clip(np.round(res), 0, 255).astype(np.uint8)


def tf_sigma2(qindex: int) -> float:
    """Filter strength from target quality (adjust_filter_strength
    analog): more aggressive at higher q where coding noise dominates."""
    from ..common.quant import ac_quant_qtx
    qstep = ac_quant_qtx(qindex, 0) / 8.0
    return max(1.0, 0.5 * qstep) ** 2


def temporal_filter(frames, center_idx: int, qindex: int,
                    window: int = 2):
    """Filter frames[center_idx] against +/-window neighbors.

    frames: list of (y, u, v) uint8 planes; returns a filtered
    (y, u, v).  av1_temporal_filter entry analog."""
    lo = max(0, center_idx - window)
    hi = min(len(frames), center_idx + window + 1)
    neigh = [i for i in range(lo, hi) if i != center_idx]
    if not neigh:
        return frames[center_idx]
    s2 = tf_sigma2(qindex)
    y, u, v = frames[center_idx]
    H, W = y.shape
    Hc, Wc = (H // BLOCK) * BLOCK, (W // BLOCK) * BLOCK
    is420 = (u.shape == ((H + 1) >> 1, (W + 1) >> 1)
             and v.shape == u.shape and Hc and Wc)
    if not is420:
        # generic per-plane path (non-420 subsampling)
        return tuple(_filter_plane(frames[center_idx][p],
                                   [frames[i][p] for i in neigh], s2)
                     for p in range(3))
    H2, W2 = Hc >> 1, Wc >> 1
    stk = (np.stack if isinstance(y, np.ndarray)
           else __import__("jax.numpy", fromlist=["stack"]).stack)
    fn = _tf_full_fn((Hc, Wc, len(neigh)))
    oy, ou, ov = fn(
        y[:Hc, :Wc].astype(np.float32),
        u[:H2, :W2].astype(np.float32),
        v[:H2, :W2].astype(np.float32),
        stk([frames[i][0][:Hc, :Wc] for i in neigh]).astype(np.float32),
        stk([frames[i][1][:H2, :W2] for i in neigh]).astype(np.float32),
        stk([frames[i][2][:H2, :W2] for i in neigh]).astype(np.float32),
        np.float32(s2))
    from ..utils.xfer import fetch
    oy, ou, ov = fetch(oy, ou, ov)
    peak = 255 if y.dtype == np.uint8 else 65535
    out = []
    for src, filt in ((y, oy), (u, ou), (v, ov)):
        if filt.shape == src.shape:
            res = filt
        else:
            res = np.asarray(src, np.float32).copy()
            res[:filt.shape[0], :filt.shape[1]] = filt
        out.append(np.clip(np.round(res), 0, peak).astype(src.dtype))
    return tuple(out)
