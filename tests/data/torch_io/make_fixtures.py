"""Write the JPEG fixtures of the port's data-pipeline tests and chip run.

    python tests/data/torch_io/make_fixtures.py [--seed 0] [--out DIR]

Draws 16 images of 500 x 375 (width x height) from ``--seed``: a smooth
two-colour gradient at a random angle, a few filled ellipses and
rectangles, mild Gaussian noise, and writes each with OpenCV as
``img_NN.jpg`` at JPEG quality 90 beside this script (about 0.4 MB in
all).  ``chip_smoke.py`` phase 26 and ``python -m mxnet_tpu_torch.io.bench``
pack their ``.rec`` from these bytes, so the card's host needs no encoder.
"""
import argparse
import os

import cv2
import numpy as np

N, WIDTH, HEIGHT, QUALITY = 16, 500, 375, 90


def draw(rng):
    """One BGR uint8 image of HEIGHT x WIDTH."""
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi)
    t = (np.cos(angle) * xx / WIDTH + np.sin(angle) * yy / HEIGHT)
    t = (t - t.min()) / (t.max() - t.min())
    a, b = rng.uniform(0, 255, 3), rng.uniform(0, 255, 3)
    img = a[None, None] * (1 - t[..., None]) + b[None, None] * t[..., None]
    for _ in range(rng.randint(2, 6)):
        colour = tuple(float(c) for c in rng.uniform(0, 255, 3))
        cx, cy = int(rng.uniform(0, WIDTH)), int(rng.uniform(0, HEIGHT))
        if rng.rand() < 0.5:
            axes = (int(rng.uniform(20, 120)), int(rng.uniform(20, 120)))
            cv2.ellipse(img, (cx, cy), axes, float(rng.uniform(0, 180)),
                        0, 360, colour, -1)
        else:
            w, h = int(rng.uniform(30, 200)), int(rng.uniform(30, 150))
            cv2.rectangle(img, (cx, cy), (cx + w, cy + h), colour, -1)
    img = cv2.GaussianBlur(img, (0, 0), 2.0)
    img += rng.normal(0, 3.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.dirname(os.path.abspath(
        __file__)))
    args = ap.parse_args(argv)
    rng = np.random.RandomState(args.seed)
    total = 0
    for i in range(N):
        ok, buf = cv2.imencode(".jpg", draw(rng),
                               [cv2.IMWRITE_JPEG_QUALITY, QUALITY])
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        path = os.path.join(args.out, "img_%02d.jpg" % i)
        with open(path, "wb") as f:
            f.write(buf.tobytes())
        total += len(buf)
    print("%d JPEGs, %d bytes, in %s" % (N, total, args.out))


if __name__ == "__main__":
    main()
