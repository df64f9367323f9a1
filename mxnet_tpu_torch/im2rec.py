"""im2rec: build .lst / .rec+.idx image datasets (the port's copy of
``tools/im2rec.py``, with its CLI).

Reference surface: tools/im2rec.py (list generation + packing modes,
same CLI verbs) over dmlc recordio, driven through the port's
:mod:`mxnet_tpu_torch.recordio` and :mod:`mxnet_tpu_torch.image`. Images
are decoded, resized and cropped on the host (the CPU context): packing
needs no card, and writes the bytes ``tools/im2rec.py`` writes.

Usage:
  # 1. generate prefix.lst from an image directory tree
  python -m mxnet_tpu_torch.im2rec --list prefix image_root [--recursive]
      [--train-ratio R] [--shuffle]
  # 2. pack prefix.lst -> prefix.rec + prefix.idx
  python -m mxnet_tpu_torch.im2rec prefix image_root [--resize N]
      [--quality Q] [--center-crop]
"""
from __future__ import annotations

import argparse
import os
import random

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def list_images(root, recursive):
    """Yield (relpath, label) with labels assigned per sorted
    subdirectory (reference: im2rec.py list_image)."""
    if recursive:
        cats = {}
        for dirpath, dirnames, filenames in sorted(os.walk(root)):
            dirnames.sort()
            for fname in sorted(filenames):
                if fname.lower().endswith(_EXTS):
                    if dirpath not in cats:
                        cats[dirpath] = len(cats)
                    yield (os.path.relpath(os.path.join(dirpath, fname),
                                           root), cats[dirpath])
    else:
        for i, fname in enumerate(sorted(os.listdir(root))):
            if fname.lower().endswith(_EXTS):
                yield (fname, 0)


def write_list(prefix, items, train_ratio=1.0, test_ratio=0.0,
               shuffle=False, chunks=1):
    items = list(items)
    if shuffle:
        random.shuffle(items)
    n = len(items)
    n_train = int(n * train_ratio)
    n_test = int(n * test_ratio)
    splits = [("train" if train_ratio < 1.0 else "", items[:n_train]),
              ("val", items[n_train:n - n_test]),
              ("test", items[n - n_test:])]
    for tag, chunk in splits:
        if not chunk and tag:
            continue
        path = f"{prefix}_{tag}.lst" if tag else f"{prefix}.lst"
        with open(path, "w") as f:
            for i, (rel, label) in enumerate(chunk):
                f.write(f"{i}\t{label}\t{rel}\n")
        print(f"wrote {len(chunk)} entries to {path}")


def read_list(path):
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            label = [float(x) for x in parts[1:-1]]
            yield idx, label[0] if len(label) == 1 else label, parts[-1]


def pack(prefix, root, resize=0, quality=95, center_crop=False,
         color=1):
    from . import recordio
    from .context import cpu
    from .image import imread, resize_short, center_crop as _cc

    lst = prefix + ".lst"
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                     "w")
    n = 0
    for idx, label, rel in read_list(lst):
        path = os.path.join(root, rel)
        header = recordio.IRHeader(0, label, idx, 0)
        if resize or center_crop:
            with cpu():
                img = imread(path, flag=color)
                if resize:
                    img = resize_short(img, resize)
                if center_crop:
                    s = min(img.shape[0], img.shape[1])
                    img, _ = _cc(img, (s, s))
            packed = recordio.pack_img(header, img.asnumpy(),
                                       quality=quality)
        else:
            with open(path, "rb") as f:
                packed = recordio.pack(header, f.read())
        rec.write_idx(idx, packed)
        n += 1
        if n % 1000 == 0:
            print(f"packed {n} images")
    rec.close()
    print(f"wrote {n} records to {prefix}.rec (+ {prefix}.idx)")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("prefix", help="prefix of .lst/.rec files")
    ap.add_argument("root", help="image root directory")
    ap.add_argument("--list", action="store_true",
                    help="generate the .lst instead of packing")
    ap.add_argument("--recursive", action="store_true")
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--train-ratio", type=float, default=1.0)
    ap.add_argument("--test-ratio", type=float, default=0.0)
    ap.add_argument("--resize", type=int, default=0,
                    help="resize shorter edge to this many pixels")
    ap.add_argument("--center-crop", action="store_true")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--color", type=int, default=1, choices=[0, 1])
    args = ap.parse_args()

    if args.list:
        write_list(args.prefix, list_images(args.root, args.recursive),
                   train_ratio=args.train_ratio,
                   test_ratio=args.test_ratio, shuffle=args.shuffle)
    else:
        pack(args.prefix, args.root, resize=args.resize,
             quality=args.quality, center_crop=args.center_crop,
             color=args.color)


if __name__ == "__main__":
    main()
