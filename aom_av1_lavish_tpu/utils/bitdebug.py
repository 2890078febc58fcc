"""Bitstream mismatch debugging (CONFIG_BITSTREAM_DEBUG analog).

The reference's debug_util.h:30-40 has the encoder push every
(bit, prob) into a queue and the decoder pop + compare, pinpointing the
first diverging symbol.  This build's equivalent is decoder-centric:
decode two candidate streams of the same content with a per-symbol
trace on the range decoder and report the first ordinal where the
symbol sequences diverge, with the decode call site as the label.
Typical use: an emitter rewrite (e.g. the native C tile walker) must be
byte-identical to the Python emitter — `diff_streams(a, b)` turns a
byte diff deep inside a frame into a one-line "symbol #1234
(read_coeffs_txb) a=2 b=3" diagnosis.

Tracing hooks `bitstream.entropy.RangeDecoder` (pure-Python decode);
set AVL_NO_NATIVE=1 so no symbols bypass it through the native C tail.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

_trace = None


@dataclass
class SymRec:
    value: int
    nsymbs: int
    label: str
    tell: int       # whole bits consumed after this symbol


def trace_active() -> bool:
    return _trace is not None


def start_trace() -> None:
    global _trace
    _trace = []
    _install()


def stop_trace():
    global _trace
    t = _trace
    _trace = None
    return t


def record(dec, value: int, nsymbs: int) -> None:
    if _trace is None:
        return
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.endswith("entropy.py"):
        f = f.f_back
    label = f.f_code.co_name if f is not None else "?"
    if f is not None:
        loc = f.f_locals
        extra = [f"{k}={loc[k]}" for k in ("plane", "tx_size", "x4", "y4",
                                           "mi_row", "mi_col", "bsize")
                 if k in loc]
        if extra:
            label += "[" + ",".join(extra) + "]"
    _trace.append(SymRec(int(value), int(nsymbs), label, dec.tell()))


_installed = False


def _install() -> None:
    """Wrap RangeDecoder's read entry points once."""
    global _installed
    if _installed:
        return
    from ..bitstream import entropy as E

    orig_sym = E.RangeDecoder.decode_symbol
    orig_bool = E.RangeDecoder.decode_bool_q15

    def decode_symbol(self, cdf, nsymbs):
        ret = orig_sym(self, cdf, nsymbs)
        record(self, ret, nsymbs)
        return ret

    def decode_bool_q15(self, f):
        ret = orig_bool(self, f)
        record(self, ret, 2)
        return ret

    E.RangeDecoder.decode_symbol = decode_symbol
    E.RangeDecoder.decode_bool_q15 = decode_bool_q15
    _installed = True


def trace_ivf(path: str, max_frames=None):
    """Decode an ivf with symbol tracing; returns the SymRec list."""
    os.environ["AVL_NO_NATIVE"] = "1"
    from ..decoder.decoder import decode_ivf
    start_trace()
    try:
        decode_ivf(path, max_frames=max_frames) if max_frames else \
            decode_ivf(path)
    except Exception:
        pass    # corrupt tail: the partial trace still locates the break
    finally:
        t = stop_trace()
    return t


def diff_streams(path_a: str, path_b: str, context: int = 4):
    """First diverging decode symbol between two streams of the same
    content.  Returns None if identical, else a dict with the ordinal,
    labels and a context window; also prints a one-line diagnosis."""
    ta = trace_ivf(path_a)
    tb = trace_ivf(path_b)
    n = min(len(ta), len(tb))
    for i in range(n):
        a, b = ta[i], tb[i]
        if (a.value, a.nsymbs) != (b.value, b.nsymbs):
            win = [(j, ta[j].label, ta[j].value,
                    tb[j].value if j < len(tb) else None)
                   for j in range(max(0, i - context),
                                  min(n, i + context + 1))]
            print(f"bitdebug: first divergence at symbol #{i} "
                  f"({a.label}): a={a.value}/{a.nsymbs} "
                  f"b={b.value}/{b.nsymbs} at ~bit {a.tell}")
            return dict(ordinal=i, label=a.label, a=a, b=b, window=win)
    if len(ta) != len(tb):
        print(f"bitdebug: common prefix identical; lengths differ "
              f"({len(ta)} vs {len(tb)})")
        return dict(ordinal=n, label="<length>", a=None, b=None,
                    window=[])
    print("bitdebug: streams decode identically "
          f"({len(ta)} symbols)")
    return None
