"""Lightfield-style tile random access (large-scale-tile analog).

The reference's lightfield pipeline (examples/lightfield_encoder.c /
lightfield_decoder.c, large_scale_tile mode av1/common/enums.h:55)
codes a camera array as one massively-tiled frame and later decodes
single camera views in O(one tile).  This example does the batched
equivalent with this framework's independent-tile machinery:

  1. pack N camera views side by side and encode them as ONE lossless
     frame with N tile columns (each tile = one camera view, fully
     independent entropy state);
  2. random-access any single view with decode_single_tile — the other
     views' payloads are skipped by their size fields, never entropy
     decoded.

Run:  python examples/lightfield.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from aom_av1_lavish_tpu.bitstream import headers as H          # noqa: E402
from aom_av1_lavish_tpu.decoder.decoder import (                # noqa: E402
    decode_frame_obus, decode_single_tile)


def make_views(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    views = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (120 + 70 * np.sin((yy + 7 * i) / 11.0)
             * np.cos((xx - 5 * i) / 13.0)
             + rng.normal(0, 4, (h, w))).clip(0, 255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 110 + 8 * i, np.uint8)
        v = np.full((h // 2, w // 2), 140 - 6 * i, np.uint8)
        views.append((y, u, v))
    return views


def main():
    n_views, vw, vh = 4, 64, 64
    views = make_views(n_views, vw, vh)
    # pack views as tile columns of one frame
    frame = (np.concatenate([v[0] for v in views], axis=1),
             np.concatenate([v[1] for v in views], axis=1),
             np.concatenate([v[2] for v in views], axis=1))
    W, Hh = vw * n_views, vh
    from aom_av1_lavish_tpu.encoder.encoder import (
        LosslessEncoder, make_lossless_frame_header, make_sequence_header)
    sh = make_sequence_header(W, Hh)
    fh = make_lossless_frame_header(
        sh, tile_cols_log2=(n_views - 1).bit_length())
    le = LosslessEncoder(sh, fh)
    payload = le.encode_frame(frame)

    # full decode (all views)
    t0 = time.perf_counter()
    frames, _ = decode_frame_obus(payload, None, {"slots": [None] * 8})
    t_full = time.perf_counter() - t0

    # random access: decode only view 2
    t0 = time.perf_counter()
    (ty, tu, tv), (y0, x0), _ = decode_single_tile(payload, 2)
    t_one = time.perf_counter() - t0
    assert np.array_equal(ty, views[2][0])
    assert np.array_equal(frames[0][0][:, 2 * vw:3 * vw], views[2][0])
    print(f"{n_views} views packed into one {W}x{Hh} frame "
          f"({len(payload)} bytes)")
    print(f"full decode: {t_full * 1000:.1f} ms; "
          f"single-view random access: {t_one * 1000:.1f} ms")


if __name__ == "__main__":
    main()
