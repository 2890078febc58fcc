"""Frame-parallel decode across keyframe segments (reference:
av1/decoder frame-parallel mode, examples/decode_to_md5.c spirit).

    python examples/decode_parallel.py in.ivf [workers]
"""
import hashlib
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    from aom_av1_lavish_tpu.decoder.parallel import decode_ivf_parallel
    workers = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    frames = decode_ivf_parallel(sys.argv[1], workers=workers)
    for i, (y, u, v) in enumerate(frames):
        md5 = hashlib.md5(y.tobytes() + u.tobytes()
                          + v.tobytes()).hexdigest()
        print(f"frame {i}: {md5}")


if __name__ == "__main__":
    main()
