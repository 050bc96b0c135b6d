#!/usr/bin/env python
"""CLI: data-parallel ImageNet ResNet training, one process per card.

The port of ``examples/imagenet/train_imagenet.py``: the same flags and
the same path (communicator → ResNet → multi-node SGD with momentum and
weight decay → ``make_flax_train_step``, fed by the native prefetcher),
plus ``--device``.  Each process trains on its rows of the global batch;
the gradient mean and the BatchNorm statistics cross the process group
(NCCL).  Without ``--data-dir`` it trains on synthetic records; with it,
on a :func:`~chainermn_tpu_torch.runtime.write_file_dataset` directory,
written with synthetic records first if it is empty.  Prints the loss,
the accuracy and the throughput, as the example does.

Run:  python -m chainermn_tpu_torch.train_imagenet --arch resnet50
      torchrun --nproc-per-node 4 -m chainermn_tpu_torch.train_imagenet \\
          --arch resnet50 --conv-impl pallas
      python -m chainermn_tpu_torch.train_imagenet --device cpu \\
          --arch resnet18 --image-size 32 --batchsize 8 --steps 3
"""

import argparse
import os
import time

PORTED_ARCHS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")
_LATER = "is not ported yet: see ROADMAP.md, queue A"


def _refuse_unported(parser, args):
    from chainermn_tpu_torch.models.resnet import NOT_PORTED_ARCHS

    if args.arch in NOT_PORTED_ARCHS:
        parser.error(f"--arch {args.arch} {_LATER} (NF-ResNets, ViT)")
    if args.fsdp:
        parser.error(f"--fsdp {_LATER} item 9 (ZeRO / FSDP)")
    if args.norm != "bn":
        parser.error(f"--norm {args.norm} {_LATER} (stalebn / affine)")
    if args.optimizer != "sgd":
        parser.error(f"--optimizer {args.optimizer} {_LATER} (LARS / LAMB)")
    if args.agc:
        parser.error(f"--agc {_LATER} (adaptive gradient clipping)")
    if args.allreduce_grad_dtype == "int8":
        parser.error(f"--allreduce-grad-dtype int8 {_LATER} item 9")


def build_step(arch="resnet50", image_size=224, conv_impl="xla", allreduce_grad_dtype=None,
               double_buffering=False, num_classes=1000, lr=0.1,
               momentum=0.9, weight_decay=1e-4, communicator="xla",
               device="cuda", seed=0, preprocess=None):
    """``(step, model, comm)``: ``bench.py :: build_step``'s recipe, the
    repo's headline configuration at its defaults (ResNet-50, image 224,
    SGD 0.1 with momentum 0.9 and weight decay 1e-4 through the
    multi-node optimizer, 1,000 classes; ``bench.py`` feeds it 128 images
    per card).  ``step(model, batch) -> (loss, {"accuracy": ...})`` takes
    this rank's rows (images NHWC, integer labels) on ``comm.device``; the
    model is rank 0's on every rank."""
    import torch

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import ARCHS, cross_entropy_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_flax_train_step, replicate

    comm = create_communicator(communicator, device=device)
    model = ARCHS[arch](num_classes=num_classes,
                        stem_strides=2 if image_size >= 64 else 1,
                        conv_impl=conv_impl, seed=seed, device=comm.device)
    replicate(model, comm)
    optimizer = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                        weight_decay=weight_decay),
        comm, double_buffering=double_buffering,
        allreduce_grad_dtype=allreduce_grad_dtype)

    def loss_and_metrics(logits, batch):
        labels = batch[1].long()
        return cross_entropy_loss(logits, labels), {
            "accuracy": (logits.argmax(-1) == labels).float().mean()}

    step = make_flax_train_step(model, loss_and_metrics, optimizer,
                                mesh=comm.mesh,
                                allreduce_grad_dtype=allreduce_grad_dtype,
                                preprocess=preprocess)
    return step, model, comm


def synthetic_batch(n, image_size, num_classes=1000, seed=0):
    """``bench.py``'s synthetic global batch: ``(n, S, S, 3)`` fp32 normal
    images and uniform integer labels, from ``seed``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.randn(n, image_size, image_size, 3).astype(np.float32),
            rng.randint(0, num_classes, n).astype(np.int32))


def main(argv=None):
    from chainermn_tpu_torch.models.resnet import NOT_PORTED_ARCHS

    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: data-parallel ImageNet training")
    parser.add_argument("--arch", default="resnet50",
                        choices=list(PORTED_ARCHS) + list(NOT_PORTED_ARCHS))
    parser.add_argument("--batchsize", type=int, default=64,
                        help="per-card batch")
    parser.add_argument("--dataset-size", type=int, default=512,
                        help="synthetic records held in the prefetch buffer")
    parser.add_argument("--data-dir", default=None,
                        help="train from an on-disk record dataset "
                             "(write_file_dataset layout); written with "
                             "synthetic records if absent")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight-decay", type=float, default=1e-4)
    parser.add_argument("--double-buffering", action="store_true")
    parser.add_argument("--allreduce-grad-dtype", default=None,
                        choices=["bfloat16", "float32", "int8"],
                        help="wire dtype of the cross-card gradient mean")
    parser.add_argument("--conv-impl", default="xla",
                        choices=["xla", "pallas"],
                        help="3x3 conv backward: 'xla' = F.conv2d's own "
                             "(cuDNN), 'pallas' = the hand-written "
                             "conv_wgrad / conv_dgrad kernels")
    parser.add_argument("--communicator", default="xla")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions over gloo)")
    # the JAX example's flags for paths not ported: refused, not ignored
    parser.add_argument("--norm", default="bn",
                        choices=["bn", "stalebn", "affine"])
    parser.add_argument("--optimizer", default="sgd",
                        choices=["sgd", "lars", "lamb"])
    parser.add_argument("--agc", type=float, default=0.0)
    parser.add_argument("--fsdp", action="store_true")
    args = parser.parse_args(argv)
    _refuse_unported(parser, args)

    import torch

    from chainermn_tpu_torch.runtime import (FileDataset, PrefetchIterator,
                                             native_available,
                                             write_file_dataset)
    from chainermn_tpu_torch.train import shard_batch

    def normalize_on_card(batch):
        # uint8 corpora upload 4x fewer bytes and are scaled on the card
        images, labels = batch
        if images.dtype == torch.uint8:
            images = images.float() / 255.0 - 0.5
        return images, labels.long()

    step, model, comm = build_step(
        args.arch, args.image_size, conv_impl=args.conv_impl,
        allreduce_grad_dtype=args.allreduce_grad_dtype,
        double_buffering=args.double_buffering, num_classes=args.num_classes,
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        communicator=args.communicator, device=args.device,
        preprocess=normalize_on_card)
    device = comm.device
    n_cards = comm.size
    global_batch = args.batchsize * n_cards
    if comm.rank == 0:
        print(f"{args.arch}  cards={n_cards}  global_batch={global_batch}  "
              f"image={args.image_size}  conv_impl={args.conv_impl}  "
              f"device={device}", flush=True)

    n_records = max(args.dataset_size, global_batch)

    def synthetic():
        return synthetic_batch(n_records, args.image_size, args.num_classes)

    if args.data_dir:
        # rank 0 alone decides whether to write; the broadcast is the same
        # collective on every rank, and the barrier before the readers
        if comm.owns_rank(0) and not os.path.exists(
                os.path.join(args.data_dir, "meta.json")):
            write_file_dataset(args.data_dir, list(synthetic()))
            print(f"materialized {n_records} records to {args.data_dir}")
        comm.bcast_obj(None)
        dataset = FileDataset(args.data_dir)
    else:
        dataset = synthetic()
    it = PrefetchIterator(dataset, batch_size=global_batch, shuffle=True,
                          seed=1, copy=True)
    if comm.rank == 0 and not native_available():
        print("note: native prefetcher unavailable, python fallback in use")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    loss, metrics = step(model, shard_batch(it.next(), device, comm.mesh))
    sync()
    t0 = time.time()
    for _ in range(args.steps):
        loss, metrics = step(model, shard_batch(it.next(), device, comm.mesh))
    final, acc = float(loss), float(metrics["accuracy"])   # waits
    sync()
    dt = time.time() - t0
    it.close()
    if comm.rank == 0:
        ips = args.steps * global_batch / dt
        print(f"loss {final:.4f}  acc {acc:.4f}")
        print(f"throughput: {ips:.1f} images/sec total, "
              f"{ips / n_cards:.1f} images/sec/card", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
