"""Lossless all-intra encode (reference: examples/lossless_encoder.c).

    python examples/lossless_encoder.py in.y4m out.ivf
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    from aom_av1_lavish_tpu.encoder import encode_lossless_ivf
    from aom_av1_lavish_tpu.utils.y4m import read_y4m
    frames, w, h, _ = read_y4m(sys.argv[1])
    encode_lossless_ivf(sys.argv[2], frames, w, h)
    print(f"losslessly encoded {len(frames)} frames")


if __name__ == "__main__":
    main()
