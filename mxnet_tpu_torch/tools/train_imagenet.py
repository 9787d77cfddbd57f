"""ImageNet training through ``Module.fit``: the port of
``examples/image_classification/train_imagenet.py``.

    python -m mxnet_tpu_torch.tools.train_imagenet --data-train X.rec
        [--data-val V.rec] [--num-layers 50] [--image-shape 3,224,224]
        [--num-classes 1000] [--batch-size 128] [--lr 0.1]
        [--lr-factor 0.1] [--lr-step-epochs 30,60,80] [--num-epochs 90]
        [--num-examples 1281167] [--kv-store local] [--model-prefix P]
        [--load-epoch N] [--data-nthreads 0] [--ctx gpu|cpu]

``ImageRecordIter`` over the JPEG ``.rec`` (shuffled, random crop and
mirror, resize 256 at 224 pixels and above, the ImageNet mean; the
validation records without augmentation) feeds the symbolic ResNet of
``tools/symbols/resnet.py`` through ``Module.fit``: SGD with momentum
0.9, wd 1e-4 and a ``MultiFactorScheduler`` stepping the rate by
``--lr-factor`` at each of ``--lr-step-epochs`` (epochs of
``--num-examples / --batch-size`` updates), ``Xavier(gaussian, in, 2)``
initialization, ``Speedometer`` every 20 batches and, with
``--model-prefix``, a checkpoint per epoch.  ``--data-nthreads`` is the
decode worker count (``preprocess_threads``; 0 decodes in-process, as
the reference's script does).  Runs on the card unless ``--ctx cpu``.
:func:`main` returns the trained module; ``batch_end_callback`` adds
callers' callbacks after the ``Speedometer``.
"""
from __future__ import annotations

import argparse
import logging

from .. import callback, initializer, io, lr_scheduler, model, module
from ..context import cpu, gpu
from .symbols import resnet

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data-train", required=True,
                        help="path to train .rec")
    parser.add_argument("--data-val", default=None)
    parser.add_argument("--network", default="resnet")
    parser.add_argument("--num-layers", type=int, default=50)
    parser.add_argument("--image-shape", default="3,224,224")
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--lr-factor", type=float, default=0.1)
    parser.add_argument("--lr-step-epochs", default="30,60,80")
    parser.add_argument("--num-epochs", type=int, default=90)
    parser.add_argument("--num-examples", type=int, default=1281167)
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--model-prefix", default=None)
    parser.add_argument("--load-epoch", type=int, default=None)
    parser.add_argument("--data-nthreads", type=int, default=0)
    parser.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    return parser.parse_args(argv)


def main(argv=None, batch_end_callback=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.network != "resnet":
        raise ValueError("--network %r: the port's symbols are resnet"
                         % args.network)
    shape = tuple(int(i) for i in args.image_shape.split(","))
    net = resnet.get_symbol(args.num_classes, args.num_layers, shape)
    resize = 256 if shape[1] >= 224 else 0
    mean = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94)
    train = io.ImageRecordIter(
        path_imgrec=args.data_train, data_shape=shape,
        batch_size=args.batch_size, shuffle=True, rand_crop=True,
        rand_mirror=True, resize=resize,
        preprocess_threads=args.data_nthreads, **mean)
    val = io.ImageRecordIter(
        path_imgrec=args.data_val, data_shape=shape,
        batch_size=args.batch_size, resize=resize,
        preprocess_threads=args.data_nthreads, **mean) \
        if args.data_val else None

    steps = [int(e) for e in args.lr_step_epochs.split(",") if e]
    epoch_size = max(args.num_examples // args.batch_size, 1)
    scheduler = lr_scheduler.MultiFactorScheduler(
        [epoch_size * s for s in steps], factor=args.lr_factor)

    mod = module.Module(net, context=gpu() if args.ctx == "gpu" else cpu())
    arg_params = aux_params = None
    begin = 0
    if args.model_prefix and args.load_epoch is not None:
        _, arg_params, aux_params = model.load_checkpoint(
            args.model_prefix, args.load_epoch)
        begin = args.load_epoch
    callbacks = [callback.Speedometer(args.batch_size, 20)]
    if batch_end_callback is not None:
        callbacks += batch_end_callback if isinstance(
            batch_end_callback, (list, tuple)) else [batch_end_callback]
    try:
        mod.fit(train, eval_data=val, kvstore=args.kv_store,
                optimizer="sgd",
                optimizer_params={"learning_rate": args.lr, "momentum": 0.9,
                                  "wd": 1e-4, "lr_scheduler": scheduler},
                initializer=initializer.Xavier(rnd_type="gaussian",
                                               factor_type="in",
                                               magnitude=2),
                num_epoch=args.num_epochs, arg_params=arg_params,
                aux_params=aux_params, begin_epoch=begin,
                batch_end_callback=callbacks,
                epoch_end_callback=(callback.do_checkpoint(
                    args.model_prefix) if args.model_prefix else None))
    finally:
        for it in (train, val):
            if hasattr(it, "close"):
                it.close()
    return mod


if __name__ == "__main__":
    main()
