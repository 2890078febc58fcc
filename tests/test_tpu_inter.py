"""Device low-delay encoder: device-batched P-frames must be conformant."""

import os
import subprocess

import numpy as np
import pytest

from aom_av1_lavish_tpu.decoder import decode_ivf
from aom_av1_lavish_tpu.encoder.tpu_inter import encode_tpu_lowdelay_ivf
from aom_av1_lavish_tpu.utils.y4m import read_y4m

AOMDEC = os.path.join(os.path.dirname(__file__), "..", ".oracle", "build",
                      "aomdec")
HAVE_ORACLE = os.path.exists(AOMDEC)


def _content(w, h, n, seed=5):
    rng = np.random.default_rng(seed)
    bh, bw = h + 80, w + 80
    base = (np.kron(rng.integers(0, 256, (bh // 10 + 1, bw // 10 + 1)),
                    np.ones((10, 10)))[:bh, :bw]
            + rng.integers(-15, 15, (bh, bw))).clip(0, 255).astype(np.uint8)
    out = []
    for i in range(n):
        y = base[5 + i:5 + i + h, 6 + 2 * i:6 + 2 * i + w].copy()
        y[20 + 3 * i:40 + 3 * i, 10 + 4 * i:30 + 4 * i] = (60 + 25 * i) % 255
        u = (128 + 30 * np.sin((np.mgrid[0:h // 2, 0:w // 2][0] + 4 * i)
                               / 13)).astype(np.uint8)
        v = base[:h // 2, i:i + w // 2]
        out.append((y, u, v))
    return out


def test_tpu_lowdelay_selfdecode(tmp_path):
    w, h = 128, 96
    frames = _content(w, h, 3)
    ivf = str(tmp_path / "t.ivf")
    encode_tpu_lowdelay_ivf(ivf, frames, w, h, qindex=60)
    dec = decode_ivf(ivf)
    assert len(dec) == 3
    for o, s in zip(dec, frames):
        mse = np.mean((o[0].astype(float) - s[0].astype(float)) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) > 28


@pytest.mark.skipif(not HAVE_ORACLE, reason="aomdec oracle not built")
def test_tpu_lowdelay_conformance(tmp_path):
    w, h = 128, 96
    frames = _content(w, h, 4)
    ivf = str(tmp_path / "t.ivf")
    out = str(tmp_path / "dec.y4m")
    encode_tpu_lowdelay_ivf(ivf, frames, w, h, qindex=80)
    subprocess.run([AOMDEC, "-o", out, ivf], check=True, capture_output=True)
    ours = decode_ivf(ivf)
    ref = read_y4m(out)[0]
    for i, (o, r) in enumerate(zip(ours, ref)):
        for pi, (a, b) in enumerate(zip(o, r)):
            np.testing.assert_array_equal(
                a, b, err_msg=f"frame {i} plane {pi}")
