"""CDEF: unit bit-exactness vs the reference oracle + stream conformance."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

from aom_av1_lavish_tpu.common import cdef as CD
from aom_av1_lavish_tpu.decoder import decode_ivf
from aom_av1_lavish_tpu.utils.y4m import read_y4m, write_y4m

ROOT = os.path.join(os.path.dirname(__file__), "..")
ORACLE = os.path.join(ROOT, ".oracle", "libcdef_oracle.so")
AOMENC = os.path.join(ROOT, ".oracle", "build", "aomenc")
AOMDEC = os.path.join(ROOT, ".oracle", "build", "aomdec")

S = 144  # reference CDEF_BSTRIDE (128 superblock)


@pytest.mark.skipif(not os.path.exists(ORACLE), reason="oracle not built")
def test_cdef_find_dir_oracle():
    lib = ctypes.CDLL(ORACLE)
    rng = np.random.default_rng(0)
    for _ in range(100):
        blk = rng.integers(0, 256, (8, 8)).astype(np.uint16)
        var = ctypes.c_int32(0)
        d = lib.oracle_cdef_find_dir(
            blk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 8,
            ctypes.byref(var), 0)
        dirs, variances = CD.find_dir_blocks(blk[None].astype(np.int32))
        assert d == dirs[0] and var.value == variances[0]


@pytest.mark.skipif(not os.path.exists(ORACLE), reason="oracle not built")
def test_cdef_filter_oracle():
    lib = ctypes.CDLL(ORACLE)
    rng = np.random.default_rng(1)
    for t in range(200):
        bh, bw = (8, 8) if t % 3 else (4, 4)
        buf = rng.integers(0, 256, (bh + 4, S)).astype(np.uint16)
        if t % 3 == 0:
            buf[:, :2] = CD.CDEF_VERY_LARGE
        if t % 5 == 0:
            buf[:2, :] = CD.CDEF_VERY_LARGE
        pri = int(rng.integers(0, 16))
        sec = int(rng.integers(0, 4))
        sec += sec == 3
        d = int(rng.integers(0, 8))
        damp = int(rng.integers(3, 7))
        dst = np.zeros((bh, bw), np.uint8)
        lib.oracle_cdef_filter(
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bw,
            ctypes.c_void_p(buf.ctypes.data + 2 * (2 * S + 2)), pri, sec, d,
            damp, damp, bw, bh)
        ours = np.clip(CD.filter_block(buf[:bh + 4, :bw + 4].astype(np.int32),
                                       pri, sec, d, damp, damp, bw, bh),
                       0, 255).astype(np.uint8)
        np.testing.assert_array_equal(ours, dst)


@pytest.mark.skipif(not (os.path.exists(AOMENC) and os.path.exists(AOMDEC)),
                    reason="aom oracle not built")
def test_cdef_stream_conformance(tmp_path):
    rng = np.random.default_rng(5)
    w, h = 128, 96
    frames = []
    base = (np.kron(rng.integers(0, 256, (20, 24)), np.ones((10, 10)))
            + rng.integers(-15, 15, (200, 240))).clip(0, 255).astype(np.uint8)
    for i in range(5):
        y = base[5 + i:5 + i + h, 6 + 2 * i:6 + 2 * i + w].copy()
        u = (128 + 30 * np.sin((np.mgrid[0:h // 2, 0:w // 2][0] + 4 * i)
                               / 13)).astype(np.uint8)
        v = base[:h // 2, i:i + w // 2]
        frames.append((y, u, v))
    src = str(tmp_path / "s.y4m")
    ivf = str(tmp_path / "c.ivf")
    out = str(tmp_path / "d.y4m")
    write_y4m(src, frames, w, h)
    subprocess.run(
        [AOMENC, "--codec=av1", "-w", str(w), "-h", str(h), "--ivf", "-o",
         ivf, "--cpu-used=5", "--end-usage=q", "--cq-level=40", "--passes=1",
         "--lag-in-frames=0", "--kf-max-dist=9999",
         "--enable-chroma-deltaq=0", "--aq-mode=0", "--enable-restoration=0",
         "--enable-obmc=0", "--enable-warped-motion=0",
         "--enable-global-motion=0", "--enable-dual-filter=0",
         "--enable-interintra-comp=0", "--enable-masked-comp=0",
         "--enable-dist-wtd-comp=0", "--enable-ref-frame-mvs=0",
         "--max-reference-frames=3", "--enable-filter-intra=0",
         "--enable-intrabc=0", "--enable-palette=0", "--enable-cfl-intra=0",
         "--enable-smooth-interintra=0", "--error-resilient=1",
         "--tile-columns=0", "--tile-rows=0", "--threads=1", src],
        check=True, capture_output=True)
    subprocess.run([AOMDEC, "-o", out, ivf], check=True, capture_output=True)
    ours = decode_ivf(ivf)
    ref = read_y4m(out)[0]
    for i, (o, r) in enumerate(zip(ours, ref)):
        for pi, (a, b) in enumerate(zip(o, r)):
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"frame {i} plane {pi}")


def _cdef_frame_per_block(planes, mi_rows, mi_cols, ss_x, ss_y, num_planes,
                          skip_grid, strength_grid, fh, bd=8):
    """Per-8x8-block CDEF through filter_block: the reference that the
    batched cdef_frame must equal."""
    cs = bd - 8
    w, h = mi_cols * 4, mi_rows * 4
    prist = []
    for p in range(num_planes):
        sx, sy = (ss_x, ss_y) if p else (0, 0)
        buf = np.full(((h >> sy) + 8, (w >> sx) + 8), CD.CDEF_VERY_LARGE,
                      np.int32)
        buf[4:4 + (h >> sy), 4:4 + (w >> sx)] = planes[p][:h >> sy,
                                                          :w >> sx]
        prist.append(buf)
    for fbr in range((mi_rows + 15) // 16):
        for fbc in range((mi_cols + 15) // 16):
            si = strength_grid[fbr, fbc]
            if si < 0:
                continue
            lv = [fh.cdef_y_pri[si], fh.cdef_uv_pri[si]]
            sc = [fh.cdef_y_sec[si], fh.cdef_uv_sec[si]]
            sc = [v + (v == 3) for v in sc]
            if not any(lv + sc):
                continue
            blocks = [(r >> 1, c_ >> 1)
                      for r in range(0, min(16, mi_rows - fbr * 16), 2)
                      for c_ in range(0, min(16, mi_cols - fbc * 16), 2)
                      if not skip_grid[fbr * 16 + r:fbr * 16 + r + 2,
                                       fbc * 16 + c_:fbc * 16 + c_ + 2].all()]
            if not blocks:
                continue
            y8 = np.stack([prist[0][4 + fbr * 64 + 8 * by:
                                    4 + fbr * 64 + 8 * by + 8,
                                    4 + fbc * 64 + 8 * bx:
                                    4 + fbc * 64 + 8 * bx + 8]
                           for by, bx in blocks])
            dirs, var = CD.find_dir_blocks(y8, cs)
            for p in range(num_planes):
                sx, sy = (ss_x, ss_y) if p else (0, 0)
                pri, sec = lv[min(p, 1)] << cs, sc[min(p, 1)] << cs
                if p and not pri and not sec:
                    continue
                bw, bh = 8 >> sx, 8 >> sy
                for bi, (by, bx) in enumerate(blocks):
                    py = (fbr * 64 + 8 * by) >> sy
                    px = (fbc * 64 + 8 * bx) >> sx
                    t = CD.adjust_strength(pri, int(var[bi])) if p == 0 \
                        else pri
                    if t == 0 and sec == 0:
                        continue
                    d = int(dirs[bi]) if pri else 0
                    dmp = fh.cdef_damping + cs - (1 if p else 0)
                    out = CD.filter_block(
                        prist[p][4 + py - 2:4 + py + bh + 2,
                                 4 + px - 2:4 + px + bw + 2],
                        t, sec, d, dmp, dmp, bw, bh, cs)
                    planes[p][py:py + bh, px:px + bw] = np.clip(
                        out, 0, (1 << bd) - 1)


@pytest.mark.parametrize("mi_rows,mi_cols,bd", [(36, 44, 8), (18, 34, 8),
                                                (20, 24, 10)])
def test_cdef_frame_batched_matches_per_block(mi_rows, mi_cols, bd):
    """The batched frame filter equals filter_block applied block by
    block: random strengths per 64x64, skip map, partial 64x64 blocks at
    the frame edge (mi counts are even in AV1), 10-bit."""
    from types import SimpleNamespace
    rng = np.random.default_rng(mi_rows * 100 + mi_cols + bd)
    # planes cover whole 8x8 blocks, as the codec allocates them
    h, w = -(-mi_rows * 4 // 8) * 8, -(-mi_cols * 4 // 8) * 8
    dt = np.uint8 if bd == 8 else np.uint16
    smooth = rng.integers(0, 1 << bd, (h // 8 + 2, w // 8 + 2))
    base = np.kron(smooth, np.ones((8, 8)))[:h, :w]
    planes = [(base + rng.integers(-9, 10, (h, w)) * (1 << (bd - 8)))
              .clip(0, (1 << bd) - 1).astype(dt)]
    planes += [rng.integers(0, 1 << bd, (h // 2, w // 2)).astype(dt)
               for _ in range(2)]
    fh = SimpleNamespace(
        cdef_damping=int(rng.integers(3, 7)),
        cdef_y_pri=tuple(int(v) for v in rng.integers(0, 16, 8)),
        cdef_y_sec=tuple(int(v) for v in rng.integers(0, 4, 8)),
        cdef_uv_pri=tuple(int(v) for v in rng.integers(0, 16, 8)),
        cdef_uv_sec=tuple(int(v) for v in rng.integers(0, 4, 8)))
    fh.cdef_y_pri = (0,) + fh.cdef_y_pri[1:]
    fh.cdef_y_sec = (0,) + fh.cdef_y_sec[1:]
    skip = rng.random((mi_rows, mi_cols)) < 0.3
    grid = rng.integers(-1, 8, ((mi_rows + 15) // 16, (mi_cols + 15) // 16))
    want = [p.copy() for p in planes]
    _cdef_frame_per_block(want, mi_rows, mi_cols, 1, 1, 3, skip, grid, fh,
                          bd)
    got = [p.copy() for p in planes]
    CD.cdef_frame(got, mi_rows, mi_cols, 1, 1, 3, skip, grid, fh, bd)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)
    assert any(not np.array_equal(g, s) for g, s in zip(got, planes))


@pytest.mark.parametrize("bh,bw,bd", [(8, 8, 8), (4, 4, 8), (8, 8, 10)])
def test_filter_blocks_batched_matches_filter_block(bh, bw, bd):
    """Every branch of filter_block (primary only, secondary only, both
    with clipping, frame-border CDEF_VERY_LARGE taps) as a per-block mask
    of the batched filter."""
    rng = np.random.default_rng(bh * 10 + bd)
    N, cs = 64, bd - 8
    win = rng.integers(0, 1 << bd, (N, bh + 4, bw + 4)).astype(np.int32)
    win[::3, :, :2] = CD.CDEF_VERY_LARGE
    win[::5, :2, :] = CD.CDEF_VERY_LARGE
    pri = rng.integers(0, 16, N) << cs
    sec = rng.choice([0, 1, 2, 4], N) << cs
    pri[::4] = 0
    sec[1::4] = 0
    d = rng.integers(0, 8, N)
    dmp = 5 + cs
    got = CD._filter_blocks(win, pri, sec, d, dmp, bw, bh, cs)
    for n in range(N):
        want = CD.filter_block(win[n], int(pri[n]), int(sec[n]), int(d[n]),
                               dmp, dmp, bw, bh, cs)
        np.testing.assert_array_equal(got[n], want)
