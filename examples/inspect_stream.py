"""Per-frame bitstream inspection (reference: tools/inspect.c).

    python examples/inspect_stream.py in.ivf
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    from aom_av1_lavish_tpu.decoder.inspect import inspect_ivf
    import numpy as np
    for i, info in enumerate(inspect_ivf(sys.argv[1])):
        modes, counts = np.unique(info.mode_grid, return_counts=True)
        top = sorted(zip(counts, modes), reverse=True)[:4]
        print(f"frame {i}: type={info.frame_type} q={info.base_qindex} "
              f"{info.width}x{info.height} "
              f"top-modes={[(int(m), int(n)) for n, m in top]} "
              f"acct={info.accounting}")


if __name__ == "__main__":
    main()
