"""show: decode a file and show it through a display sink; an
animation shows each frame.

    python -m ffpic_tpu_torch.apps.show FILE [--sink window|bmp|png]
        [--device cpu]

Copied from ``ffpic_tpu/apps/show.py`` over the port's registry and
sinks (``ffpic_tpu_torch.display``), with ``--device`` for the decode:
CUDA unless it says ``cpu``.  The ``window`` sink needs PIL; ``bmp`` and
``png`` write files beside the input's name.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="show")
    ap.add_argument("file")
    ap.add_argument("--sink", default="window",
                    choices=["window", "bmp", "png"])
    ap.add_argument("--device", default=None,
                    help="where to decode: cpu, or CUDA when not given")
    args = ap.parse_args(argv)

    import ffpic_tpu_torch
    from ffpic_tpu_torch import display
    pic = ffpic_tpu_torch.load(args.file, device=args.device)
    frames = [pic] + pic.frames
    for i, fr in enumerate(frames):
        title = args.file if len(frames) == 1 else f"{args.file}.frame{i}"
        out = display.show(fr, sink=args.sink, title=title)
        if out:
            print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
