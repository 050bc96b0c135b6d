#!/usr/bin/env python
"""CLI: data-parallel ImageNet training, one process per card.

The port of ``examples/imagenet/train_imagenet.py``: the same flags, archs
(the ResNets, the NF-ResNets, AlexNet, VGG-16, GoogLeNet and the ViTs) and
path (communicator → model → the optimizer chain under the multi-node
optimizer → ``make_flax_train_step``, fed by the native prefetcher), plus
``--device``.  Each process trains on its rows of the global batch; the
gradient mean and the BatchNorm statistics cross the process group (NCCL).
``--optimizer sgd`` is SGD with momentum and decayed weights, ``lars`` /
``lamb`` the large-batch optimizers of :mod:`chainermn_tpu_torch.optim`;
``--warmup-steps`` warms the learning rate up linearly from 0 and ``--agc``
clips the mean gradients unit-wise ahead of the optimizer, as the example
chains them.  Without ``--data-dir`` it trains on synthetic records; with
it, on a :func:`~chainermn_tpu_torch.runtime.write_file_dataset`
directory, written with synthetic records first if it is empty.  Prints
the loss, the accuracy and the throughput, as the example does.
``--allreduce-grad-dtype int8`` means the gradients through the
block-scaled int8 ring.  ``--fsdp`` shards the parameters, gradients and
optimizer state ``1/P`` a rank (``parallel.make_fsdp_train_step``; the
model runs through ``torch.func.functional_call`` on the gathered leaves)
and takes a BatchNorm-free arch, e.g. ``--arch vit_s16``.

Run:  python -m chainermn_tpu_torch.train_imagenet --arch resnet50
      torchrun --nproc-per-node 4 -m chainermn_tpu_torch.train_imagenet \\
          --arch nf_resnet50 --conv-impl pallas --optimizer lars --agc 0.01
      python -m chainermn_tpu_torch.train_imagenet --device cpu \\
          --arch resnet18 --image-size 32 --batchsize 8 --steps 3
      torchrun --nproc-per-node 2 -m chainermn_tpu_torch.train_imagenet \\
          --fsdp --arch vit_s16 --optimizer lamb --agc 0.01
"""

import argparse
import os
import time

# the JAX example's --arch choices (its literal list; main checks it
# against the registry)
ARCH_CHOICES = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                "nf_resnet50", "nf_resnet101", "nf_resnet152", "alex",
                "googlenet", "vgg16", "vit_ti16", "vit_s16", "vit_b16")
# the JAX example's words
FSDP_WIRE = ("--fsdp handles gradient reduction itself (GSPMD "
             "reduce-scatter); --allreduce-grad-dtype/--double-buffering "
             "do not apply")


def arch_kwargs(arch, image_size=224, conv_impl="xla", norm="bn"):
    """The model's keyword arguments beside ``num_classes``, as the JAX
    example builds them: ``stem_strides`` 1 below 64 pixels, ``norm`` for
    the ResNets only, ``conv_impl`` for the (NF-)ResNets only, and the
    image size that sizes ViT's ``pos_embed`` and the convnets' first
    ``Dense``.  A flag that does not apply to ``arch`` raises."""
    kw = {"stem_strides": 2 if image_size >= 64 else 1}
    if norm != "bn":
        if not arch.startswith("resnet"):
            raise ValueError("--norm applies to the resnet archs only")
        kw["norm"] = norm
    if conv_impl != "xla":
        if "resnet" not in arch:
            raise ValueError("--conv-impl applies to the (nf_)resnet archs "
                             "only")
        kw["conv_impl"] = conv_impl
    if arch.startswith(("vit", "alex", "vgg")):
        kw["image_size"] = image_size
    return kw


def make_optimizer(model, optimizer="sgd", lr=0.1, momentum=0.9,
                   weight_decay=1e-4, warmup_steps=0, agc=0.0, params=None,
                   transposed=None):
    """The JAX example's chain over ``model.parameters()`` (or ``params``,
    the linear weights among them ``transposed``): SGD (decayed weights,
    then momentum), LARS or LAMB, at ``lr`` or warmed up linearly from 0
    over ``warmup_steps``, behind adaptive gradient clipping when ``agc``
    > 0."""
    import torch

    from chainermn_tpu_torch import optim

    params = list(model.parameters() if params is None else params)
    if transposed is None:
        transposed = optim.linear_weights(model)
    if optimizer == "lars":
        opt = optim.Lars(params, lr, weight_decay=weight_decay,
                         momentum=momentum)
    elif optimizer == "lamb":
        opt = optim.Lamb(params, lr, weight_decay=weight_decay)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if warmup_steps:
        opt = optim.Scheduled(opt, optim.linear_schedule(0.0, lr,
                                                         warmup_steps))
    if agc:
        opt = optim.AdaptiveGradClip(opt, agc, transposed=transposed)
    return opt


def build_step(arch="resnet50", image_size=224, conv_impl="xla",
               allreduce_grad_dtype=None, double_buffering=False,
               num_classes=1000, lr=0.1, momentum=0.9, weight_decay=1e-4,
               communicator="xla", device="cuda", seed=0, preprocess=None,
               optimizer="sgd", warmup_steps=0, agc=0.0, norm="bn",
               variables=None, dtype=None, fsdp=False, error_feedback=False):
    """``(step, model, comm)``: at its defaults ``bench.py :: build_step``'s
    recipe, the repo's headline configuration (ResNet-50, image 224, SGD
    0.1 with momentum 0.9 and weight decay 1e-4 through the multi-node
    optimizer, 1,000 classes; ``bench.py`` feeds it 128 images per card);
    the other arguments are the example's flags.  ``variables`` (flax's
    ``{"params", "batch_stats"}`` as numpy) replace the seeded weights;
    ``dtype`` is the compute dtype (the model's default, bf16, if None);
    ``error_feedback`` adds the int8 wire's residual.
    ``step(model, batch) -> (loss, {"accuracy": ...})`` takes this rank's
    rows (images NHWC, integer labels) on ``comm.device``; the model is
    rank 0's on every rank.  With ``fsdp`` (:func:`fsdp_step`) the step
    trains this rank's blocks, ``step.params``, and ``step.gather()``
    returns the whole parameters by name."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.convert import resnet_from_jax
    from chainermn_tpu_torch.models import ARCHS, cross_entropy_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.train import make_flax_train_step, replicate

    if fsdp and (allreduce_grad_dtype or double_buffering):
        # these knobs live in the replicated-DP wrapper
        raise SystemExit(FSDP_WIRE)
    kw = arch_kwargs(arch, image_size, conv_impl, norm)
    if dtype is not None:
        kw["dtype"] = dtype
    comm = create_communicator(communicator, device=device)
    model = ARCHS[arch](num_classes=num_classes, seed=seed,
                        device=comm.device, **kw)
    if variables is not None:
        resnet_from_jax(variables, model)
    replicate(model, comm)

    def loss_and_metrics(logits, batch):
        labels = batch[1].long()
        return cross_entropy_loss(logits, labels), {
            "accuracy": (logits.argmax(-1) == labels).float().mean()}

    def chain(**over):
        return make_optimizer(model, optimizer, lr, momentum, weight_decay,
                              warmup_steps, agc, **over)

    if fsdp:
        return fsdp_step(model, comm, arch, chain, loss_and_metrics,
                         preprocess), model, comm
    opt = create_multi_node_optimizer(
        chain(), comm, double_buffering=double_buffering,
        allreduce_grad_dtype=allreduce_grad_dtype,
        error_feedback=error_feedback)
    step = make_flax_train_step(model, loss_and_metrics, opt,
                                mesh=comm.mesh,
                                allreduce_grad_dtype=allreduce_grad_dtype,
                                preprocess=preprocess)
    return step, model, comm


def fsdp_step(model, comm, arch, chain, loss_and_metrics, preprocess=None):
    """The example's ``--fsdp`` path: ``model``'s parameters cut into this
    rank's blocks by ``zero1_specs`` (the ``nn.Linear`` weights by their
    JAX layout), the optimizer ``chain(params=..., transposed=...)`` over
    the blocks, and ``make_fsdp_train_step`` over ``model`` run by
    ``torch.func.functional_call`` on the gathered leaves.  The module's
    own parameters are released: the blocks are the model.  A BatchNorm
    arch (running statistics) exits, as the example does."""
    import torch

    from chainermn_tpu_torch.optim import linear_weights
    from chainermn_tpu_torch.parallel import (init_fsdp_params,
                                              init_fsdp_state,
                                              make_fsdp_train_step,
                                              zero1_specs)

    if any(True for _ in model.buffers()):
        raise SystemExit(f"--fsdp needs a BatchNorm-free arch (got {arch}); "
                         f"try --arch vit_s16")
    full = dict(model.named_parameters())
    linear = {id(w) for w in linear_weights(model)}
    flipped = [n for n, t in full.items() if id(t) in linear]
    specs = zero1_specs(full, comm.mesh, transposed=flipped)
    blocks = init_fsdp_params(full, comm.mesh, transposed=flipped)
    opt = init_fsdp_state(lambda leaves: chain(
        params=leaves, transposed=[blocks[n] for n in flipped]),
        blocks, comm.mesh, specs)
    for t in full.values():
        t.data = t.data.new_empty(0)

    def fsdp_loss(params, batch):
        if preprocess is not None:
            batch = preprocess(batch)
        logits = torch.func.functional_call(model, params, (batch[0],))
        return loss_and_metrics(logits, batch)

    raw = make_fsdp_train_step(fsdp_loss, opt, blocks, comm.mesh, specs,
                               has_aux=True)

    def step(module, batch):
        if module is not model:
            raise ValueError("the step was built for another module")
        module.train()
        return raw(blocks, batch)

    step.optimizer, step.params, step.gather = opt, blocks, raw.gather
    return step


def synthetic_batch(n, image_size, num_classes=1000, seed=0):
    """``bench.py``'s synthetic global batch: ``(n, S, S, 3)`` fp32 normal
    images and uniform integer labels, from ``seed`` (the example's
    records and labels at seed 0)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.randn(n, image_size, image_size, 3).astype(np.float32),
            rng.randint(0, num_classes, n).astype(np.int32))


def _parser():
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: data-parallel ImageNet training")
    parser.add_argument("--arch", default="resnet50", choices=ARCH_CHOICES)
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
    parser.add_argument("--optimizer", default="sgd",
                        choices=["sgd", "lars", "lamb"],
                        help="lars / lamb: the large-batch optimizers "
                             "(layer-wise trust ratios)")
    parser.add_argument("--warmup-steps", type=int, default=0,
                        help="linear learning-rate warmup from 0")
    parser.add_argument("--allreduce-grad-dtype", default=None,
                        choices=["bfloat16", "float16", "float32", "int8"],
                        help="wire dtype of the cross-card gradient mean "
                             "(int8: the block-scaled quantized ring)")
    parser.add_argument("--conv-impl", default="xla",
                        choices=["xla", "pallas"],
                        help="(NF-)ResNet conv backward: 'xla' = F.conv2d's "
                             "own (cuDNN), 'pallas' = the hand-written "
                             "conv_wgrad / conv_dgrad kernels on the "
                             "eligible stride-1 3x3 (and, in the NF-ResNets, "
                             "1x1) convs; PERF.md has both step times")
    parser.add_argument("--norm", default="bn",
                        choices=["bn", "stalebn", "affine"],
                        help="ResNet norm layer: 'stalebn' normalises with "
                             "the previous step's batch statistics, "
                             "'affine' with none")
    parser.add_argument("--agc", type=float, default=0.0,
                        help="adaptive gradient clipping threshold (0 = "
                             "off), ahead of the optimizer")
    parser.add_argument("--communicator", default="xla")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions over gloo)")
    parser.add_argument("--fsdp", action="store_true",
                        help="ZeRO-3: params, grads and optimizer state all "
                             "sharded 1/P (BatchNorm-free archs only: use "
                             "a ViT, e.g. --arch vit_s16)")
    return parser


def _check(parser, args):
    """The JAX example's flag checks."""
    from chainermn_tpu_torch.models import ARCHS

    try:
        arch_kwargs(args.arch, args.image_size, args.conv_impl, args.norm)
    except ValueError as e:
        parser.error(str(e))
    if args.agc < 0:
        # a negative clip would negate every update (gradient ascent)
        parser.error("--agc must be >= 0")
    missing = [c for c in ARCH_CHOICES if c not in ARCHS]
    if missing:
        parser.error(f"--arch choices drifted from the model registry: "
                     f"{missing} not in {sorted(ARCHS)}")


def run(argv=None, variables=None, dtype=None, error_feedback=False):
    """``python -m chainermn_tpu_torch.train_imagenet``'s run: the
    warm-up step, then ``--steps`` steps.  ``variables`` (flax's, as
    numpy) replace the seeded initial weights; ``dtype`` is the compute
    dtype (the model's default, bf16, if None); ``error_feedback`` adds the
    int8 wire's residual (``build_step``'s).  Returns ``{"losses":
    [the warm-up step's, then each step's], "accuracy", "images_per_s",
    ..., "model", "step"}``."""
    parser = _parser()
    args = parser.parse_args(argv)
    _check(parser, args)

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
        preprocess=normalize_on_card, optimizer=args.optimizer,
        warmup_steps=args.warmup_steps, agc=args.agc, norm=args.norm,
        variables=variables, dtype=dtype, fsdp=args.fsdp,
        error_feedback=error_feedback)
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
    losses = [loss]
    sync()
    t0 = time.time()
    for _ in range(args.steps):
        loss, metrics = step(model, shard_batch(it.next(), device, comm.mesh))
        losses.append(loss)
    losses = [float(v) for v in losses]                  # waits
    acc = float(metrics["accuracy"])
    sync()
    dt = time.time() - t0
    it.close()
    ips = args.steps * global_batch / dt
    if comm.rank == 0:
        print(f"loss {losses[-1]:.4f}  acc {acc:.4f}")
        print(f"throughput: {ips:.1f} images/sec total, "
              f"{ips / n_cards:.1f} images/sec/card", flush=True)
    return {"arch": args.arch, "cards": n_cards, "losses": losses,
            "accuracy": acc, "images_per_s": ips, "model": model,
            "step": step}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
