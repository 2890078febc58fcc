"""Tests that need the GPU.  They skip elsewhere; on the chip:
AVL_CHIP_TESTS=1 python -m pytest tests/ -m chip."""

import numpy as np
import pytest

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("bsz,radius,peak", [(16, 16, 255), (8, 16, 1020)])
def test_ssd_surface_exact_on_gpu(gpu, bsz, radius, peak):
    """The cuDNN grouped conv keeps full float32 (no TF32): the surface
    is exact at 1080p block counts."""
    import jax
    import jax.numpy as jnp
    from aom_av1_lavish_tpu.ops import pallas_kernels as PK
    rng = np.random.default_rng(1)
    B, W = 8160, 2 * radius + bsz
    src = rng.integers(0, peak + 1, (B, bsz, bsz)).astype(np.int32)
    win = rng.integers(0, peak + 1, (B, W, W)).astype(np.int32)
    f = jax.jit(lambda s, w: PK.ssd_surface(s, w, bsz, radius, peak=peak))
    got = np.asarray(f(jnp.asarray(src), jnp.asarray(win)))
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(f(jnp.asarray(src), jnp.asarray(win)))
    np.testing.assert_array_equal(got, want)


def test_gop_stream_decodes_to_recon_on_gpu(gpu):
    """The device GOP path on the card: every reference slot of the
    encoder equals the decoder's, byte for byte."""
    import bench
    from aom_av1_lavish_tpu.decoder.decoder import decode_frame_obus
    from aom_av1_lavish_tpu.encoder.gop import GopEncoder
    w, h = 352, 288
    frames = bench.make_frames(n=5, w=w, h=h)
    enc = GopEncoder(w, h, qindex=100, gf_length=4, use_tpu=True)
    payloads = enc.encode_sequence(frames)
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in payloads:
        fr, sh = decode_frame_obus(p, sh, state)
        shown.extend(fr)
    assert len(shown) == len(frames)
    for slot in range(8):
        if enc.slots[slot] is not None:
            for pe, pd in zip(enc.slots[slot],
                              state["slots"][slot]["planes"]):
                np.testing.assert_array_equal(pe, pd)
