"""First pass: per-16x16 intra/inter error stats, batched on device.

Batched re-design of av1/encoder/firstpass.c (av1_first_pass :1248,
FIRSTPASS_STATS :43-174): the reference walks MBs serially doing DC-pred
intra error + a small MV search; here the whole frame's MB grid is one
jit call — DC intra error vectorized, inter error as the exhaustive
conv-SSD surface from ops/inter_tpu (+-16 full-pel vs the previous
frame).  Stats serialize through a flat float64 array per frame
(stats/aomstats.h:34 analog) via save_stats/load_stats.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.inter_tpu import PADR, _gather_blocks, _ssd_surface


@dataclass
class FirstPassStats:
    """Per-frame aggregate (FIRSTPASS_STATS analog, trimmed to the
    fields pass-2 consumes)."""
    frame: float = 0.0
    intra_error: float = 0.0      # sum DC-pred SSE over MBs
    coded_error: float = 0.0      # sum min(intra, inter) SSE
    pcnt_inter: float = 0.0       # fraction of MBs where inter wins
    pcnt_motion: float = 0.0      # fraction of inter MBs with nonzero MV
    mv_mag: float = 0.0           # mean |mv| of inter MBs (full-pel)
    count: float = 1.0

    def to_array(self) -> np.ndarray:
        return np.array([getattr(self, f.name) for f in fields(self)],
                        np.float64)

    @classmethod
    def from_array(cls, a) -> "FirstPassStats":
        return cls(**{f.name: float(v)
                      for f, v in zip(fields(cls), a)})


_FP_CACHE = {}


def _fp_fn(key):
    if key in _FP_CACHE:
        return _FP_CACHE[key]
    H, W = key
    nby, nbx = H // 16, W // 16
    B = nby * nbx
    by, bx = np.meshgrid(np.arange(nby), np.arange(nbx), indexing="ij")
    y0 = jnp.asarray((by.ravel() * 16).astype(np.int32))
    x0 = jnp.asarray((bx.ravel() * 16).astype(np.int32))

    def fn(src_y, prev_pad):
        blk = src_y.reshape(nby, 16, nbx, 16).transpose(0, 2, 1, 3) \
            .reshape(B, 16, 16).astype(jnp.int32)
        # DC-pred intra error (mean-removed energy, firstpass.c style)
        mean = (blk.sum((1, 2)) + 128) >> 8
        d = (blk - mean[:, None, None]).astype(jnp.float32)
        intra_err = (d * d).sum((1, 2))
        # inter: exhaustive +-16 SSD surface vs the previous frame
        ssd = _ssd_surface(blk, prev_pad, y0, x0, 16, 16)
        flat = ssd.reshape(B, -1)
        best = jnp.min(flat, axis=1)
        bidx = jnp.argmin(flat, axis=1)
        mv_y = bidx // 33 - 16
        mv_x = bidx % 33 - 16
        zero_ssd = ssd[:, 16, 16]
        moved = best + 256.0 < zero_ssd   # motion must beat zero-mv bias
        inter_err = jnp.where(moved, best, zero_ssd)
        is_inter = inter_err * 1.12 < intra_err   # firstpass gating flavor
        coded = jnp.where(is_inter, inter_err, intra_err)
        mv_mag = jnp.where(
            moved & is_inter,
            jnp.abs(mv_y).astype(jnp.float32)
            + jnp.abs(mv_x).astype(jnp.float32), 0.0)
        return (intra_err.sum(), coded.sum(),
                is_inter.mean(dtype=jnp.float32),
                (moved & is_inter).mean(dtype=jnp.float32),
                mv_mag.sum(), jnp.maximum(
                    (moved & is_inter).sum(dtype=jnp.float32), 1.0))

    fn = jax.jit(fn)
    _FP_CACHE[key] = fn
    return fn


def first_pass(frames) -> list:
    """Run the stats pass over (y, u, v) frames; returns
    [FirstPassStats] (one per frame; frame 0 is intra-only)."""
    stats = []
    prev = None
    for i, f in enumerate(frames):
        y = np.asarray(f[0])
        H = (y.shape[0] // 16) * 16
        W = (y.shape[1] // 16) * 16
        y = y[:H, :W]
        if prev is None:
            fn = _fp_fn((H, W))
            z = np.pad(y, PADR, mode="edge")
            ie, ce, pi, pm, mv, nmv = [float(np.asarray(v)) for v in
                                       fn(jnp.asarray(y), jnp.asarray(z))]
            stats.append(FirstPassStats(frame=i, intra_error=ie,
                                        coded_error=ie, pcnt_inter=0.0,
                                        pcnt_motion=0.0, mv_mag=0.0))
        else:
            fn = _fp_fn((H, W))
            prev_pad = np.pad(prev, PADR, mode="edge")
            ie, ce, pi, pm, mv, nmv = [float(np.asarray(v)) for v in
                                       fn(jnp.asarray(y),
                                          jnp.asarray(prev_pad))]
            stats.append(FirstPassStats(
                frame=i, intra_error=ie, coded_error=ce, pcnt_inter=pi,
                pcnt_motion=pm, mv_mag=mv / nmv))
        prev = y
    return stats


def save_stats(path: str, stats) -> None:
    """Serialize first-pass stats (stats_open_file/.fpf analog)."""
    np.save(path, np.stack([s.to_array() for s in stats]))


def load_stats(path: str) -> list:
    arr = np.load(path if path.endswith(".npy") else path + ".npy")
    return [FirstPassStats.from_array(r) for r in arr]
