"""im2rec: build RecordIO packs from image folders / .lst files.

    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT [--list] [...]

The port of the repository's ``tools/im2rec.py`` (reference:
``tools/im2rec.py``) — the same CLI surface (``--list`` to generate a
``.lst``, then pack to ``.rec`` / ``.idx``) and the same on-disk formats,
written through the port's ``recordio``, so datasets packed by either tool
are byte for byte the same.
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np

from .. import recordio


def list_image(root, recursive, exts):
    i = 0
    if recursive:
        cat = {}
        for path, dirs, files in os.walk(root, followlinks=True):
            dirs.sort()
            files.sort()
            for fname in files:
                fpath = os.path.join(path, fname)
                suffix = os.path.splitext(fname)[1].lower()
                if os.path.isfile(fpath) and suffix in exts:
                    if path not in cat:
                        cat[path] = len(cat)
                    yield (i, os.path.relpath(fpath, root), cat[path])
                    i += 1
        for k, v in sorted(cat.items(), key=lambda x: x[1]):
            print(os.path.relpath(k, root), v)
    else:
        for fname in sorted(os.listdir(root)):
            fpath = os.path.join(root, fname)
            suffix = os.path.splitext(fname)[1].lower()
            if os.path.isfile(fpath) and suffix in exts:
                yield (i, os.path.relpath(fpath, root), 0)
                i += 1


def write_list(path_out, image_list):
    with open(path_out, "w") as fout:
        for i, item in enumerate(image_list):
            line = "%d\t" % item[0]
            for j in item[2:]:
                line += "%f\t" % j
            line += "%s\n" % item[1]
            fout.write(line)


def make_list(args):
    image_list = list(list_image(args.root, args.recursive, args.exts))
    if args.shuffle:
        random.seed(100)
        random.shuffle(image_list)
    n = len(image_list)
    chunk_size = (n + args.chunks - 1) // args.chunks
    for i in range(args.chunks):
        chunk = image_list[i * chunk_size:(i + 1) * chunk_size]
        str_chunk = "_%d" % i if args.chunks > 1 else ""
        sep = int(chunk_size * args.train_ratio)
        sep_test = int(chunk_size * args.test_ratio)
        if args.train_ratio == 1.0:
            write_list(args.prefix + str_chunk + ".lst", chunk)
        else:
            if args.test_ratio:
                write_list(args.prefix + str_chunk + "_test.lst",
                           chunk[:sep_test])
            if args.train_ratio + args.test_ratio < 1.0:
                write_list(args.prefix + str_chunk + "_val.lst",
                           chunk[sep_test + sep:])
            write_list(args.prefix + str_chunk + "_train.lst",
                       chunk[sep_test:sep_test + sep])


def read_list(path_in):
    with open(path_in) as fin:
        for line_num, line in enumerate(fin):
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                print("lst should have at least 3 parts, skipping line %d"
                      % line_num)
                continue
            yield (int(parts[0]),) + tuple(float(i) for i in parts[1:-1]) + \
                (parts[-1],)


def image_encode(args, i, item, q_out):
    import cv2
    fullpath = os.path.join(args.root, item[-1])
    header = recordio.IRHeader(0, item[1] if len(item) == 3 else
                               np.array(item[1:-1], dtype=np.float32),
                               item[0], 0)
    if args.pass_through:
        with open(fullpath, "rb") as fin:
            img = fin.read()
        s = recordio.pack(header, img)
        q_out.append((i, s, item))
        return
    img = cv2.imread(fullpath, args.color)
    if img is None:
        print("imread read blank (None) image for file: %s" % fullpath)
        return
    if args.center_crop:
        if img.shape[0] > img.shape[1]:
            margin = (img.shape[0] - img.shape[1]) // 2
            img = img[margin:margin + img.shape[1], :]
        else:
            margin = (img.shape[1] - img.shape[0]) // 2
            img = img[:, margin:margin + img.shape[0]]
    if args.resize:
        if img.shape[0] > img.shape[1]:
            newsize = (args.resize,
                       img.shape[0] * args.resize // img.shape[1])
        else:
            newsize = (img.shape[1] * args.resize // img.shape[0],
                       args.resize)
        img = cv2.resize(img, newsize)
    s = recordio.pack_img(header, img, quality=args.quality,
                          img_fmt=args.encoding)
    q_out.append((i, s, item))


def make_rec(args):
    for lst in [l for l in os.listdir(os.path.dirname(args.prefix) or ".")
                if l.startswith(os.path.basename(args.prefix)) and
                l.endswith(".lst")]:
        path_lst = os.path.join(os.path.dirname(args.prefix) or ".", lst)
        print("Creating .rec file from", path_lst)
        base = os.path.splitext(path_lst)[0]
        record = recordio.MXIndexedRecordIO(base + ".idx", base + ".rec", "w")
        items = list(enumerate(read_list(path_lst)))
        if args.num_thread > 1:
            # cv2 releases the GIL, so a thread pool parallelizes the
            # decode/encode work (reference tool uses a process pool)
            from multiprocessing.pool import ThreadPool

            def encode_one(pair):
                i, item = pair
                q = []
                image_encode(args, i, item, q)
                return q[0] if q else None
            with ThreadPool(args.num_thread) as pool:
                out = [r for r in pool.map(encode_one, items) if r is not None]
        else:
            out = []
            for i, item in items:
                image_encode(args, i, item, out)
        for i, s, item in out:
            record.write_idx(item[0], s)
        record.close()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Create an image list or RecordIO pack "
                    "(reference tools/im2rec.py CLI)")
    parser.add_argument("prefix", help="prefix of input/output lst/rec files")
    parser.add_argument("root", help="path to folder containing images")
    cgroup = parser.add_argument_group("Options for creating image lists")
    cgroup.add_argument("--list", action="store_true")
    cgroup.add_argument("--exts", nargs="+",
                        default=[".jpeg", ".jpg", ".png"])
    cgroup.add_argument("--chunks", type=int, default=1)
    cgroup.add_argument("--train-ratio", type=float, default=1.0)
    cgroup.add_argument("--test-ratio", type=float, default=0)
    cgroup.add_argument("--recursive", action="store_true")
    cgroup.add_argument("--no-shuffle", dest="shuffle", action="store_false")
    rgroup = parser.add_argument_group("Options for creating rec files")
    rgroup.add_argument("--pass-through", action="store_true")
    rgroup.add_argument("--resize", type=int, default=0)
    rgroup.add_argument("--center-crop", action="store_true")
    rgroup.add_argument("--quality", type=int, default=95)
    rgroup.add_argument("--num-thread", type=int, default=1)
    rgroup.add_argument("--color", type=int, default=1, choices=[-1, 0, 1])
    rgroup.add_argument("--encoding", type=str, default=".jpg",
                        choices=[".jpg", ".png"])
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.list:
        make_list(args)
    else:
        make_rec(args)


if __name__ == "__main__":
    main()
