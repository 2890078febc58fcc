"""Minimal decoder to y4m (reference: examples/simple_decoder.c).

    python examples/simple_decoder.py in.ivf out.y4m
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    from aom_av1_lavish_tpu.decoder import decode_ivf
    from aom_av1_lavish_tpu.utils.y4m import write_y4m
    frames = decode_ivf(sys.argv[1])
    h, w = frames[0][0].shape
    write_y4m(sys.argv[2], frames, w, h)
    print(f"decoded {len(frames)} frames -> {sys.argv[2]}")


if __name__ == "__main__":
    main()
