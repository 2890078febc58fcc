"""Minimal fixed-q encoder (reference: examples/simple_encoder.c).

    python examples/simple_encoder.py in.y4m out.ivf [qindex]
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    from aom_av1_lavish_tpu.encoder.gop import encode_gop_ivf
    from aom_av1_lavish_tpu.utils.y4m import read_y4m
    src, out = sys.argv[1], sys.argv[2]
    q = int(sys.argv[3]) if len(sys.argv) > 3 else 60
    frames, w, h, _ = read_y4m(src)
    encode_gop_ivf(out, frames, w, h, qindex=q)
    print(f"encoded {len(frames)} frames -> {out}")


if __name__ == "__main__":
    main()
