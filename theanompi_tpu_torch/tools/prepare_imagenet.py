"""ImageNet preparation: an image tree -> the shard tree training reads.

Counterpart of ``tools/prepare_imagenet.py``, with the same flags:

    python -m theanompi_tpu_torch.tools.prepare_imagenet \\
        /data/imagenet/train out/ --prefix train --store 256 \\
        --shard-size 1024
    python -m theanompi_tpu_torch.tools.prepare_imagenet \\
        /data/imagenet/val out/ --prefix val --classes out/classes.json

Expects the ImageFolder layout (``<src>/<class>/<img>.jpeg``) and needs
Pillow.  Pass the train run's ``classes.json`` to the val run so that
the labels agree.  The tree is the JAX tool's byte for byte
(data/imagenet.py ``prepare_imagenet_from_images``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src_dir", help="raw image tree (<src>/<class>/*.jpeg)")
    ap.add_argument("out_dir", help="shard output directory")
    ap.add_argument("--prefix", default="train", choices=("train", "val"))
    ap.add_argument("--store", type=int, default=256,
                    help="stored image side (shorter side resized, then a "
                         "center crop); training crops store->crop")
    ap.add_argument("--shard-size", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--classes", default=None,
                    help="classes.json of an earlier run (the train run's "
                         "mapping for val)")
    ap.add_argument("--no-shuffle", action="store_true",
                    help="keep directory order (default: one global "
                         "shuffle, so that shards mix the classes)")
    ap.add_argument("--format", default="npy", choices=("npy", "npz"),
                    dest="shard_format",
                    help="npy (default): memory-mapped .x.npy/.y.npy "
                         "pairs; npz: one zip per shard")
    args = ap.parse_args(argv)

    from theanompi_tpu_torch.data.imagenet import prepare_imagenet_from_images

    class_to_idx = None
    if args.classes:
        with open(args.classes) as fh:
            class_to_idx = json.load(fh)
    t0 = time.monotonic()
    paths = prepare_imagenet_from_images(
        args.src_dir, args.out_dir, prefix=args.prefix, store=args.store,
        shard_size=args.shard_size, class_to_idx=class_to_idx,
        workers=args.workers,
        shuffle_seed=None if args.no_shuffle else 0,
        shard_format=args.shard_format)
    print(f"wrote {len(paths)} {args.prefix} shards to {args.out_dir} "
          f"in {time.monotonic() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
