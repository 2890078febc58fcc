"""Encoder-side loop restoration search.

Re-design of av1/encoder/pickrst.c
(av1_pick_filter_restoration :1779): per restoration unit, solve a
separable symmetric Wiener filter (alternating least squares on the
CDEF'd recon vs source) and self-guided projection params (closed-form
least squares per ep), then pick NONE/WIENER/SGRPROJ per unit by RD.
Candidate evaluation reuses the decoder's bit-exact _filter_unit so the
decision metric equals what the decoder will reconstruct.

Also provides the write-side subexp/quniform coders
(aom_write_primitive_refsubexpfin, bitstream.c analog) used when the
tile is re-emitted with LR unit symbols.
"""

from __future__ import annotations

import numpy as np

from ..common import restoration as LR


# ---------------------------------------------------------------------------
# Write-side binary codes (mirror decoder._rd_* readers)
# ---------------------------------------------------------------------------


def write_literal(sink, v: int, bits: int) -> None:
    for i in range(bits - 1, -1, -1):
        sink.bit((v >> i) & 1)


def write_quniform(sink, n: int, v: int) -> None:
    if n <= 1:
        return
    lb = n.bit_length()
    m = (1 << lb) - n
    if v < m:
        write_literal(sink, v, lb - 1)
    else:
        t = v + m
        write_literal(sink, t >> 1, lb - 1)
        sink.bit(t & 1)


def write_subexpfin(sink, n: int, k: int, v: int) -> None:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            write_quniform(sink, n - mk, v - mk)
            return
        if v < mk + a:
            sink.bit(0)
            write_literal(sink, v - mk, b)
            return
        sink.bit(1)
        i += 1
        mk += a


def _recenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if v >= r:
        return (v - r) << 1
    return ((r - v) << 1) - 1


def write_refsubexpfin(sink, n: int, k: int, ref: int, v: int) -> None:
    if 2 * ref <= n:
        write_subexpfin(sink, n, k, _recenter_nonneg(ref, v))
    else:
        write_subexpfin(sink, n, k, _recenter_nonneg(n - 1 - ref,
                                                     n - 1 - v))


def _subexpfin_bits(n: int, k: int, v: int) -> int:
    """Exact coded length of write_subexpfin(v)."""
    i = 0
    mk = 0
    bits = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            nn = n - mk
            if nn <= 1:
                return bits
            lb = nn.bit_length()
            m = (1 << lb) - nn
            return bits + (lb - 1 if (v - mk) < m else lb)
        if v < mk + a:
            return bits + 1 + b
        bits += 1
        i += 1
        mk += a


def _refsubexpfin_bits(n: int, k: int, ref: int, v: int) -> int:
    if 2 * ref <= n:
        return _subexpfin_bits(n, k, _recenter_nonneg(ref, v))
    return _subexpfin_bits(n, k, _recenter_nonneg(n - 1 - ref, n - 1 - v))


# ---------------------------------------------------------------------------
# Unit geometry (mirrors LR.filter_frame_plane's walk)
# ---------------------------------------------------------------------------


def unit_rects(pr: LR.PlaneRestoration, h: int, w: int, ss_y: int):
    """(unit_idx, v_start, v_end, h_start, h_end) per restoration unit,
    exactly tiling the plane."""
    unit_size = pr.unit_size
    ext = unit_size * 3 // 2
    stripe_off = LR.UNIT_OFFSET >> ss_y
    out = []
    y0 = 0
    ri = 0
    while y0 < h:
        rem = h - y0
        uh = rem if rem < ext else unit_size
        v0 = max(0, y0 - stripe_off)
        v1 = y0 + uh
        if v1 < h:
            v1 -= stripe_off
        x0 = 0
        ci = 0
        while x0 < w:
            remw = w - x0
            uw = remw if remw < ext else unit_size
            out.append((ri * pr.hunits + ci, v0, v1, x0, x0 + uw))
            x0 += uw
            ci += 1
        y0 += uh
        ri += 1
    return out


# ---------------------------------------------------------------------------
# Wiener solve (wiener_decompose_sep_sym analog: alternating LS)
# ---------------------------------------------------------------------------


def _eff(taps) -> np.ndarray:
    """Effective normalized 7-tap filter from 3 half-taps."""
    f0, f1, f2 = taps
    return np.array([f0, f1, f2, 128 - 2 * (f0 + f1 + f2), f2, f1, f0],
                    np.float64) / 128.0


def _conv1d(x: np.ndarray, f: np.ndarray, axis: int) -> np.ndarray:
    """Valid 7-tap correlation along axis (x has a 3-px border)."""
    n = x.shape[axis] - 6
    sl = [slice(None)] * x.ndim
    acc = None
    for k in range(7):
        sl[axis] = slice(k, k + n)
        term = f[k] * x[tuple(sl)]
        acc = term if acc is None else acc + term
    return acc


def solve_wiener(dgd: np.ndarray, src: np.ndarray, win: int,
                 iters: int = 3):
    """dgd: unit pixels with a 3-px valid border (h+6, w+6) float64;
    src: (h, w).  Returns integer half-taps ((h0,h1,h2), (v0,v1,v2)) in
    decoder tap convention; win 7 => 3 free taps, win 5 => tap0 = 0."""
    h, w = src.shape
    free = range(0 if win == LR.WIENER_WIN else 1, 3)
    vt = list(LR.WIENER_TAP_MID)
    ht = list(LR.WIENER_TAP_MID)
    if win != LR.WIENER_WIN:
        vt[0] = ht[0] = 0

    def clampq(t, i):
        return int(np.clip(round(t), LR.WIENER_TAP_MIN[i],
                           LR.WIENER_TAP_MAX[i]))

    for _ in range(iters):
        # horizontal solve given vertical
        inter = _conv1d(dgd, _eff(vt), 0)         # (h, w+6)
        x0 = inter[:, 3:3 + w]
        basis = [(inter[:, t:t + w] + inter[:, 6 - t:6 - t + w]
                  - 2 * x0) / 128.0 for t in free]
        tgt = src - x0
        A = np.array([[float((a * b).sum()) for b in basis]
                      for a in basis])
        rhs = np.array([float((a * tgt).sum()) for a in basis])
        try:
            sol = np.linalg.solve(A + 1e-6 * np.eye(len(basis)), rhs)
        except np.linalg.LinAlgError:
            sol = np.zeros(len(basis))
        for j, t in enumerate(free):
            ht[t] = clampq(sol[j], t)
        # vertical solve given horizontal
        inter = _conv1d(dgd, _eff(ht), 1)         # (h+6, w)
        x0 = inter[3:3 + h]
        basis = [(inter[t:t + h] + inter[6 - t:6 - t + h] - 2 * x0)
                 / 128.0 for t in free]
        tgt = src - x0
        A = np.array([[float((a * b).sum()) for b in basis]
                      for a in basis])
        rhs = np.array([float((a * tgt).sum()) for a in basis])
        try:
            sol = np.linalg.solve(A + 1e-6 * np.eye(len(basis)), rhs)
        except np.linalg.LinAlgError:
            sol = np.zeros(len(basis))
        for j, t in enumerate(free):
            vt[t] = clampq(sol[j], t)
    return tuple(ht), tuple(vt)


def taps_to_filter(taps) -> list:
    f0, f1, f2 = taps
    return [f0, f1, f2, -2 * (f0 + f1 + f2), f2, f1, f0, 0]


# ---------------------------------------------------------------------------
# SGR solve (get_proj_subspace analog)
# ---------------------------------------------------------------------------


def solve_sgr(dgd_ext: np.ndarray, src: np.ndarray, ep: int, bd: int = 8):
    """dgd_ext: (h+6, w+6) int64 unit with 3-px border; returns xqd or
    None when the system is degenerate."""
    h, w = src.shape
    r0, r1, s0, s1 = LR.SGR_PARAMS[ep]
    dat = dgd_ext[3:3 + h, 3:3 + w]
    u = (dat << LR.SGRPROJ_RST_BITS).astype(np.float64)
    tgt = (src.astype(np.float64) * (1 << LR.SGRPROJ_RST_BITS)) - u
    fs = []
    if r0 > 0:
        fs.append((LR._sgr_flt_fast(dgd_ext, w, h, s0, bd) - u) / 128.0)
    if r1 > 0:
        fs.append((LR._sgr_flt_normal(dgd_ext, w, h, s1, bd) - u) / 128.0)
    A = np.array([[float((a * b).sum()) for b in fs] for a in fs])
    rhs = np.array([float((a * tgt).sum()) for a in fs])
    try:
        xq = np.linalg.solve(A + 1e-6 * np.eye(len(fs)), rhs)
    except np.linalg.LinAlgError:
        return None
    xqd = [0, 0]
    if r0 == 0:
        xqd[0] = 0
        xqd[1] = int(np.clip(round(128 - xq[0]), LR.SGRPROJ_PRJ_MIN1,
                             LR.SGRPROJ_PRJ_MAX1))
    elif r1 == 0:
        xqd[0] = int(np.clip(round(xq[0]), LR.SGRPROJ_PRJ_MIN0,
                             LR.SGRPROJ_PRJ_MAX0))
        xqd[1] = int(np.clip(128 - xqd[0], LR.SGRPROJ_PRJ_MIN1,
                             LR.SGRPROJ_PRJ_MAX1))
    else:
        xqd[0] = int(np.clip(round(xq[0]), LR.SGRPROJ_PRJ_MIN0,
                             LR.SGRPROJ_PRJ_MAX0))
        xqd[1] = int(np.clip(round(128 - xqd[0] - xq[1]),
                             LR.SGRPROJ_PRJ_MIN1, LR.SGRPROJ_PRJ_MAX1))
    return xqd


# ---------------------------------------------------------------------------
# Per-plane search
# ---------------------------------------------------------------------------

SGR_EPS = (0, 3, 5, 7, 9, 11, 12, 14)    # spread over the 3 param classes


def _wiener_bits(taps, ref, win) -> int:
    bits = 0
    for tap in range(3):
        if tap == 0 and win != LR.WIENER_WIN:
            continue
        mn, mx = LR.WIENER_TAP_MIN[tap], LR.WIENER_TAP_MAX[tap]
        bits += _refsubexpfin_bits(mx - mn + 1, LR.WIENER_TAP_K[tap],
                                   ref[tap] - mn, taps[tap] - mn)
    return bits


def pick_restoration_plane(src, recon, pr: LR.PlaneRestoration, ss_y,
                           bounds, optimized, lam, win=LR.WIENER_WIN,
                           speed_eps=SGR_EPS, bd=8):
    """Fill pr.unit_info with per-unit RD decisions; returns the set of
    rtypes used.  src/recon: plane views (h, w) uint8; win: 7 for luma,
    5 for chroma."""
    h, w = pr.plane_h, pr.plane_w
    src = src[:h, :w].astype(np.int64)
    P = LR.PAD
    data = np.empty((h + 2 * P, w + 2 * P), recon.dtype)
    data[P:P + h, P:P + w] = recon[:h, :w]
    data[P:P + h, :P] = recon[:h, :1]
    data[P:P + h, P + w:] = recon[:h, w - 1:w]
    data[:P] = data[P]
    data[P + h:] = data[P + h - 1]
    dst = data.copy()
    used = set()

    def unit_sse(rect, rtype, info):
        _, v0, v1, x0, x1 = rect
        LR._filter_unit(data, dst, v0, v1, x0, x1, rtype, info, ss_y,
                        h, bounds, optimized, bd)
        d = dst[P + v0:P + v1, P + x0:P + x1].astype(np.int64) \
            - src[v0:v1, x0:x1]
        return float((d * d).sum())

    wiener_ref = {"v": LR.default_wiener(), "h": LR.default_wiener()}
    for rect in unit_rects(pr, h, w, ss_y):
        idx, v0, v1, x0, x1 = rect
        none_sse = unit_sse(rect, LR.RESTORE_NONE, None)
        best = (none_sse + lam * 2.0, LR.RESTORE_NONE, None)

        # Wiener: solve on the bordered unit, evaluate bit-exactly
        dpad = data[P + v0 - 3:P + v1 + 3, P + x0 - 3:P + x1 + 3] \
            .astype(np.float64)
        ht, vt = solve_wiener(dpad, src[v0:v1, x0:x1].astype(np.float64),
                              win)
        if any(ht) or any(vt):
            info = (taps_to_filter(ht), taps_to_filter(vt))
            sse = unit_sse(rect, LR.RESTORE_WIENER, info)
            bits = (_wiener_bits(ht, wiener_ref["h"], win)
                    + _wiener_bits(vt, wiener_ref["v"], win) + 2)
            cost = sse + lam * bits
            if cost < best[0]:
                best = (cost, LR.RESTORE_WIENER, info)

        # SGR: per-ep least squares, evaluate best candidate exactly
        dext = data[P + v0 - 3:P + v1 + 3, P + x0 - 3:P + x1 + 3] \
            .astype(np.int64)
        for ep in speed_eps:
            xqd = solve_sgr(dext, src[v0:v1, x0:x1], ep, bd)
            if xqd is None:
                continue
            sse = unit_sse(rect, LR.RESTORE_SGRPROJ, (ep, xqd))
            cost = sse + lam * (LR.SGRPROJ_PARAMS_BITS + 12)
            if cost < best[0]:
                best = (cost, LR.RESTORE_SGRPROJ, (ep, xqd))

        _, rtype, info = best
        pr.unit_info[idx] = (rtype, info)
        used.add(rtype)
        if rtype == LR.RESTORE_WIENER:
            wiener_ref = {"h": list(info[0]), "v": list(info[1])}
    return used
