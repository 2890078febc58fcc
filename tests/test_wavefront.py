"""Wavefront device encoder: conformance vs own decoder and stock aomdec."""

import os
import subprocess

import numpy as np
import pytest

from aom_av1_lavish_tpu.decoder import decode_ivf
from aom_av1_lavish_tpu.encoder.tpu_intra import encode_tpu_ivf
from aom_av1_lavish_tpu.utils.y4m import read_y4m

AOMDEC = os.path.join(os.path.dirname(__file__), "..", ".oracle", "build",
                      "aomdec")


def _frame(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 17) * np.cos(yy / 23)
         + rng.integers(-4, 5, (h, w))).clip(0, 255).astype(np.uint8)
    u = (128 + 40 * np.sin(xx[::2, ::2] / 31)).clip(0, 255).astype(np.uint8)
    v = rng.integers(100, 160, (h // 2, w // 2)).astype(np.uint8)
    return y, u, v


@pytest.mark.parametrize("dims", [(64, 64), (176, 144)])
def test_wavefront_selfdecode(tmp_path, dims):
    w, h = dims
    f = _frame(w, h)
    ivf = str(tmp_path / "w.ivf")
    encode_tpu_ivf(ivf, [f], w, h, qindex=60)
    y, u, v = decode_ivf(ivf)[0]
    mse = np.mean((y.astype(float) - f[0].astype(float)) ** 2)
    assert 10 * np.log10(255 ** 2 / mse) > 30


@pytest.mark.skipif(not os.path.exists(AOMDEC), reason="no aomdec oracle")
def test_wavefront_conformance(tmp_path):
    w, h = 176, 144
    f = _frame(w, h, seed=2)
    ivf = str(tmp_path / "w.ivf")
    out = str(tmp_path / "w.y4m")
    encode_tpu_ivf(ivf, [f], w, h, qindex=60)
    subprocess.run([AOMDEC, "-o", out, ivf], check=True, capture_output=True)
    ours = decode_ivf(ivf)[0]
    ref = read_y4m(out)[0][0]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
