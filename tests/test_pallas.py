"""Inter-path device kernels against plain oracles (the SIMD-vs-C pattern
of test/sad_test.cc / convolve_test.cc: same inputs, identical outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest

import aom_av1_lavish_tpu.ops.pallas_kernels as PK


def _ssd_oracle(src, win, bsz, radius):
    S = 2 * radius + 1
    want = np.empty((src.shape[0], S, S), np.int64)
    for dy in range(S):
        for dx in range(S):
            d = src.astype(np.int64) - win[:, dy:dy + bsz, dx:dx + bsz]
            want[:, dy, dx] = (d * d).sum((1, 2))
    return want


def _ssd_case(bsz, radius, peak, B, seed=7):
    rng = np.random.default_rng(seed)
    W = 2 * radius + bsz
    src = rng.integers(0, peak + 1, (B, bsz, bsz)).astype(np.int32)
    win = rng.integers(0, peak + 1, (B, W, W)).astype(np.int32)
    # saturated corners: the largest sums the surface can reach
    src[0] = peak
    win[0, :bsz, :bsz] = 0
    return src, win


def _check_ssd(bsz, radius, peak):
    src, win = _ssd_case(bsz, radius, peak, B=5)
    got = np.asarray(PK.ssd_surface(jnp.asarray(src), jnp.asarray(win),
                                    bsz, radius, peak=peak))
    want = _ssd_oracle(src, win, bsz, radius)
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("bsz,radius", [(16, 16), (16, 8), (8, 8)])
def test_ssd_surface_equivalence(bsz, radius):
    """The XLA body equals the numpy SSD exactly."""
    _check_ssd(bsz, radius, 255)


@pytest.mark.parametrize("bsz,radius", [(8, 16), (8, 8)])
def test_ssd_surface_half_res_exact(bsz, radius):
    """The half-resolution pass (2x2 sums, pixels up to 1020) passes
    2**24: exact in int32, rounded to nearest only by the float32 cast."""
    _check_ssd(bsz, radius, 4 * 255)


GATHER_CASES = [(23, 23, "uint8"), (39, 39, "uint8"), (25, 25, "int32"),
                (71, 71, "uint8")]


def _gather_case(wr, wc, dtype):
    rng = np.random.default_rng(3)
    H, W = 192, 256     # 71x71: the 64x64 merge level's 8-tap region
    plane = rng.integers(0, 255, (H, W)).astype(dtype)
    B = 37
    fr = rng.integers(0, H - wr - 1, B).astype(np.int32)
    fc = rng.integers(0, W - wc - 1, B).astype(np.int32)
    ref = plane[fr[:, None, None] + np.arange(wr)[None, :, None],
                fc[:, None, None] + np.arange(wc)[None, None, :]]
    return plane, fr, fc, ref


@pytest.mark.parametrize("wr,wc,dtype", GATHER_CASES)
def test_gather_windows_equivalence(wr, wc, dtype):
    plane, fr, fc, ref = _gather_case(wr, wc, dtype)
    out = PK.gather_windows(jnp.asarray(plane), jnp.asarray(fr),
                            jnp.asarray(fc), wr, wc)
    assert out.dtype == plane.dtype
    np.testing.assert_array_equal(np.asarray(out), ref)


@pytest.mark.parametrize("bh,bw", [(16, 16), (8, 16), (32, 32)])
def test_convolve_8tap_equivalence(bh, bw):
    """Batched device convolve == the normative host convolve_sr."""
    from aom_av1_lavish_tpu.common import interpred as IP
    rng = np.random.default_rng(11)
    B = 7
    region = rng.integers(0, 256, (B, bh + 7, bw + 7)).astype(np.int32)
    filt = np.asarray(IP.SUBPEL_FILTERS_8)
    sx = rng.integers(0, 16, B)
    sy = rng.integers(0, 16, B)
    sx[0] = sy[0] = 0
    got = np.asarray(PK.convolve_8tap(
        jnp.asarray(region), jnp.asarray(filt[sx].astype(np.int32)),
        jnp.asarray(filt[sy].astype(np.int32)), bh, bw))
    for b in range(B):
        want = IP.convolve_sr(region[b], int(sx[b]), int(sy[b]), filt, filt)
        np.testing.assert_array_equal(got[b], want)
