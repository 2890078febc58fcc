"""Device→host transfer discipline.

Every synchronous device→host read waits for the device and pays a
fixed per-transfer cost before any byte moves.  Fetching N result arrays
one `np.asarray` at a time therefore pays that N times; issuing all
copies asynchronously first pipelines them.  (The reference codec has
no analog — its "device" is the local CPU; this module replaces its
shared-memory result handoff.)

Rules encoded here:
  * `fetch(...)` — always announce every array via `copy_to_host_async`
    before the first blocking read.
  * keep payloads small at the source: prefer int16/uint8 outputs from
    kernels over int32 (see ops/inter_tpu.py, ops/lossless.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["fetch"]


def fetch(*arrays):
    """Fetch one or more device arrays to host numpy, pipelined.

    Accepts jax arrays, numpy arrays, or nested tuples/lists of them;
    returns matching structure (single input -> single output).
    """
    flat = []

    def _collect(x):
        if isinstance(x, (tuple, list)):
            for e in x:
                _collect(e)
        else:
            flat.append(x)

    _collect(arrays)
    for a in flat:
        f = getattr(a, "copy_to_host_async", None)
        if f is not None:
            try:
                f()
            except Exception:        # committed/deleted arrays: fall back
                pass

    def _realize(x):
        if isinstance(x, tuple):
            return tuple(_realize(e) for e in x)
        if isinstance(x, list):
            return [_realize(e) for e in x]
        return np.asarray(x)

    out = tuple(_realize(x) for x in arrays)
    return out[0] if len(out) == 1 else out
