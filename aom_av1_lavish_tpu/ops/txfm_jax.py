"""Batched integer transforms on the device (JAX), bit-exact with the
host engine.

The stage tables from common/txfm1d.py compile into vectorized gather +
arithmetic ops: each stage is out[i] = f(in[src0[i]], in[src1[i]]) with
per-element weights, executed over an arbitrary batch.

All arithmetic is int32 (int64 is emulated on some accelerators).  The
only spots where the reference uses 64-bit — the butterfly product
accumulate (av1_txfm.h half_btf) and the sqrt2 rescales — are computed
exactly in int32 via a hi/lo split: with non-negative weights w < 2^15,
a*w0 + b*w1 + half = (a_hi*w0 + b_hi*w1)*2^16 + (a_lo*w0 + b_lo*w1 + half)
with the low part non-negative < 2^31, so the floor-shift distributes
exactly over the two parts.  Bit-exactness is verified in
tests/test_txfm_jax.py against the numpy engine.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..bitstream import constants as c
from ..common import txfm1d as T1
from ..common import txfm2d as T2

K_COPY, K_ADDSUB, K_BTF = T1.K_COPY, T1.K_ADDSUB, T1.K_BTF


def _mul2_shift(a, w0, b, w1, shift):
    """Exact floor((a*w0 + b*w1 + 2^(shift-1)) >> shift) in int32.

    Weights may be negative (sign is folded into the operand); |w| < 2^15,
    1 <= shift <= 16, and the true result must fit int32 (guaranteed by
    the AV1 stage-range discipline)."""
    a = jnp.where(w0 < 0, -a, a)
    b = jnp.where(w1 < 0, -b, b)
    w0a = jnp.abs(w0)
    w1a = jnp.abs(w1)
    a_lo = a & 0xFFFF
    a_hi = a >> 16
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    half = 1 << (shift - 1)
    lo = a_lo * w0a + b_lo * w1a + half
    hi = a_hi * w0a + b_hi * w1a
    return (hi << (16 - shift)) + (lo >> shift)


def _mul_shift(a, w, shift):
    """Exact floor((a*w + 2^(shift-1)) >> shift) in int32, w >= 0."""
    lo = (a & 0xFFFF) * w + (1 << (shift - 1))
    hi = (a >> 16) * w
    return (hi << (16 - shift)) + (lo >> shift)


@lru_cache(maxsize=None)
def _stage_arrays(stages_key, cos_bit):
    """Convert a stage-table tuple into numpy arrays per stage."""
    out = []
    for stage in stages_key:
        n = len(stage)
        kind = np.zeros(n, np.int32)
        s0 = np.zeros(n, np.int32)
        s1 = np.zeros(n, np.int32)
        w0 = np.zeros(n, np.int32)
        w1 = np.zeros(n, np.int32)
        for i, (k, i0, i1, a, b) in enumerate(stage):
            kind[i], s0[i], s1[i], w0[i], w1[i] = k, i0, i1, a, b
        out.append((kind, s0, s1, w0, w1))
    return out


def _run_stages_jnp(x, stages, cos_bit, clamp_bits):
    """x: (..., N) int; returns (..., N) int32."""
    buf = x.astype(jnp.int32)
    for (kind, s0, s1, w0, w1) in stages:
        a = buf[..., s0]
        b = buf[..., s1]
        btf = _mul2_shift(a, w0, b, w1, cos_bit)
        # addsub/copy weights are +-1: plain int32 (btf lanes may wrap
        # here; their values are discarded by the select below)
        lin = a * w0 + b * w1
        if clamp_bits < 32:
            lo = -(1 << (clamp_bits - 1))
            addsub = jnp.clip(lin, lo, -lo - 1)
        else:  # forward path: no stage clamping
            addsub = lin
        out = jnp.where(kind == K_BTF, btf,
                        jnp.where(kind == K_ADDSUB, addsub, a * w0))
        buf = out
    return buf


def _iadst4_jnp(x, cos_bit):
    # av1_iadst4_c computes these products in int32 itself
    sp = np.asarray(T1.sinpi_arr(cos_bit), np.int32)
    x = x.astype(jnp.int32)
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    s0 = sp[1] * x0
    s1 = sp[2] * x0
    s2 = sp[3] * x1
    s3 = sp[4] * x2
    s4 = sp[1] * x2
    s5 = sp[2] * x3
    s6 = sp[4] * x3
    s7 = (x0 - x2) + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sp[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6
    o0 = s0 + s3
    o1 = s1 + s3
    o2 = s2
    o3 = (s0 + s1) - s3
    half = 1 << (cos_bit - 1)
    return jnp.stack([(o0 + half) >> cos_bit, (o1 + half) >> cos_bit,
                      (o2 + half) >> cos_bit, (o3 + half) >> cos_bit],
                     axis=-1)


def _fadst4_jnp(x, cos_bit):
    # av1_fadst4_c computes these products in int32 itself
    sp = np.asarray(T1.sinpi_arr(cos_bit), np.int32)
    x = x.astype(jnp.int32)
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    s0 = sp[1] * x0
    s1 = sp[4] * x0
    s2 = sp[2] * x1
    s3 = sp[1] * x1
    s4 = sp[3] * x2
    s5 = sp[4] * x3
    s6 = sp[2] * x3
    s7 = (x0 + x1) - x3
    t0 = s0 + s2
    t1 = sp[3] * s7
    t2 = s1 - s3
    t3 = s4
    t0 = t0 + s5
    t2 = t2 + s6
    o0 = t0 + t3
    o1 = t1
    o2 = t2 - t3
    o3 = (t2 - t0) + t3
    half = 1 << (cos_bit - 1)
    return jnp.stack([(o0 + half) >> cos_bit, (o1 + half) >> cos_bit,
                      (o2 + half) >> cos_bit, (o3 + half) >> cos_bit],
                     axis=-1)


def _identity_jnp(x, n, cos_bit):
    x = x.astype(jnp.int32)
    if n == 4:
        return _mul_shift(x, T1.NEW_SQRT2, T1.NEW_SQRT2_BITS)
    if n == 8:
        return x * 2
    if n == 16:
        return _mul_shift(x, T1.NEW_SQRT2 * 2, T1.NEW_SQRT2_BITS)
    return x * 4


def _fwd1d(x, kind, n, cos_bit):
    if kind == "identity":
        return _identity_jnp(x, n, cos_bit)
    if kind == "adst":
        if n == 4:
            return _fadst4_jnp(x, cos_bit)
        stages = _stage_arrays(T1.fadst_stages(n, cos_bit), cos_bit)
    else:
        stages = _stage_arrays(T1.fdct_stages(n, cos_bit), cos_bit)
    return _run_stages_jnp(x, stages, cos_bit, 64)


def _inv1d(x, kind, n, cos_bit, clamp_bits):
    if kind == "identity":
        return _identity_jnp(x, n, cos_bit)
    if kind == "adst":
        if n == 4:
            return _iadst4_jnp(x, cos_bit)
        stages = _stage_arrays(T1.iadst_stages(n, cos_bit), cos_bit)
    else:
        stages = _stage_arrays(T1.idct_stages(n, cos_bit), cos_bit)
    return _run_stages_jnp(x, stages, cos_bit, clamp_bits)


def _round_shift(x, bit):
    if bit == 0:
        return x
    if bit > 0:
        return (x + (1 << (bit - 1))) >> bit
    return x << -bit


def fwd_txfm2d_batched(resid, tx_size: int, tx_type: int):
    """resid: (B, h, w) int32 -> (B, aw*ah) int32 flat coefficients,
    bit-exact with common/txfm2d.fwd_txfm2d."""
    h, w = c.TX_HEIGHT[tx_size], c.TX_WIDTH[tx_size]
    txw_idx = w.bit_length() - 3
    txh_idx = h.bit_length() - 3
    cb_col = T2._FWD_COS_BIT_COL[txw_idx][txh_idx]
    cb_row = T2._FWD_COS_BIT_ROW[txw_idx][txh_idx]
    s0, s1, s2 = T2.FWD_SHIFT[tx_size]
    vk, hk = T2.VTX[tx_type], T2.HTX[tx_type]
    x = resid.astype(jnp.int32)
    if T2._flip(vk):
        x = x[:, ::-1, :]
    colsin = _round_shift(jnp.swapaxes(x, -1, -2), -s0)     # (B, w, h)
    cols = _fwd1d(colsin, T2._kind(vk), h, cb_col)
    cols = _round_shift(cols, -s1)
    buf = jnp.swapaxes(cols, -1, -2)                        # (B, h, w)
    if T2._flip(hk):
        buf = buf[:, :, ::-1]
    rows = _fwd1d(buf, T2._kind(hk), w, cb_row)
    rows = _round_shift(rows, -s2)
    if abs(T2._rect_log_ratio(w, h)) == 1:
        rows = _mul_shift(rows, T1.NEW_SQRT2, T1.NEW_SQRT2_BITS)
    full = jnp.swapaxes(rows, -1, -2)                       # (B, w, h)
    aw, ah = min(w, 32), min(h, 32)
    return full[:, :aw, :ah].reshape(full.shape[0], aw * ah).astype(
        jnp.int32)


def inv_txfm2d_add_batched(coeff_flat, pred, tx_size: int, tx_type: int,
                           bd: int = 8):
    """coeff_flat: (B, aw*ah) dequantized; pred (B, h, w) uint8; returns
    recon (B, h, w) uint8, bit-exact with common/txfm2d.inv_txfm2d_add."""
    h, w = c.TX_HEIGHT[tx_size], c.TX_WIDTH[tx_size]
    s0, s1 = T2.INV_SHIFT[tx_size]
    vk, hk = T2.VTX[tx_type], T2.HTX[tx_type]
    opt_row = 16 if bd == 8 else (18 if bd == 10 else 20)
    opt_col = 16 if bd == 8 else (16 if bd == 10 else 18)
    aw, ah = min(w, 32), min(h, 32)
    B = coeff_flat.shape[0]
    adj = coeff_flat.astype(jnp.int32).reshape(B, aw, ah)
    if (aw, ah) != (w, h):
        full = jnp.zeros((B, w, h), dtype=jnp.int32)
        full = full.at[:, :aw, :ah].set(adj)
    else:
        full = adj
    x = jnp.swapaxes(full, -1, -2)  # (B, h, w)
    if abs(T2._rect_log_ratio(w, h)) == 1:
        x = _mul_shift(x, T1.NEW_INV_SQRT2, T1.NEW_SQRT2_BITS)
    lo = -(1 << (bd + 7))
    x = jnp.clip(x, lo, -lo - 1)
    rows = _inv1d(x, T2._kind(hk), w, T1.INV_COS_BIT, opt_row)
    rows = _round_shift(rows, -s0)
    if T2._flip(hk):
        rows = rows[:, :, ::-1]
    colsin = jnp.swapaxes(rows, -1, -2)
    lo2 = -(1 << (max(bd + 6, 16) - 1))
    colsin = jnp.clip(colsin, lo2, -lo2 - 1)
    cols = _inv1d(colsin, T2._kind(vk), h, T1.INV_COS_BIT, opt_col)
    cols = _round_shift(cols, -s1)
    res = jnp.swapaxes(cols, -1, -2)
    if T2._flip(vk):
        res = res[:, ::-1, :]
    out = pred.astype(jnp.int32) + res
    return jnp.clip(out, 0, (1 << bd) - 1).astype(jnp.uint8)
