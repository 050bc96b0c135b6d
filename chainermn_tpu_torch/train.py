"""Data-parallel training steps over ``torch.distributed``.

Counterpart of ``chainermn_tpu/train.py`` (``make_train_step``,
``make_flax_train_step``, ``make_demo_step``, ``replicate``,
``shard_batch``, ``shard_batch_local`` and the demo CLI ``main``).  JAX's step is one SPMD program over a mesh that
is handed the GLOBAL batch; here each rank is a process that runs its
local shard eagerly, and the step updates the module's tensors in place:

* the loss is the mean over the LOCAL rows; ``backward`` gives local
  gradients; the gradient is meaned across ranks exactly ONCE, by the
  optimizer wrapper (:func:`~chainermn_tpu_torch.optimizers
  .create_multi_node_optimizer`), or by the step itself before a plain
  ``torch.optim`` step (JAX gets the same mean from differentiating the
  pmean'd loss);
* the returned loss (and metrics) are the cross-rank means;
* ``make_flax_train_step`` then means the BatchNorm running statistics
  across ranks (JAX's ``pmean`` of ``batch_stats`` after the update).

``shard_batch`` takes the global batch every process holds and gives
rank ``r`` rows ``[r·B/P, (r+1)·B/P)`` (JAX's rank-major sharding) on its
device; ``shard_batch_local`` moves rows a process loaded itself.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .observability.comm import collective as _acc
from .optimizers import (MultiNodeOptimizer, _grads_of, compressed_mean,
                         gradient_average)
from .topology import DEFAULT_AXIS_NAME, make_mesh


def _pmean(tensors, mesh):
    """The cross-rank mean of a list of tensors in fp32: one bucket on the
    wire, booked as one ``pmean`` of the list as given (JAX's ``pmean`` of
    a pytree)."""
    return _acc("pmean", mesh, tensors, lambda: compressed_mean(
        [t.detach().float() for t in tensors], mesh))


def _mean_metrics(loss, metrics, mesh, aux=True):
    """The cross-rank means of the loss and, with ``aux``, of the metrics
    dict: two collectives, as JAX's steps ``pmean`` the loss and the aux
    tree apart."""
    loss = _pmean([loss], mesh)[0]
    if not aux:
        return loss, {}
    names = sorted(metrics or {})
    values = _pmean([torch.as_tensor(metrics[k], device=loss.device)
                     for k in names], mesh)
    return loss, dict(zip(names, values))


def _apply(optimizer, params, mesh, allreduce_grad_dtype, grad_reduce=None,
           autodiff_mean=False):
    """The one cross-rank gradient mean (``grad_reduce`` when given, else
    this step's own unless the optimizer wrapper owns it), then the
    update.  ``autodiff_mean``: the step is JAX's default path, whose
    gradient mean autodiff inserts and JAX notes in its comm ledger as
    ``grad_allreduce_ad`` at the gradient tree's size; the mean run here
    is booked so, with its bytes as ``noted_bytes``."""
    owner = optimizer if isinstance(optimizer, MultiNodeOptimizer) else None
    if grad_reduce is not None:
        for p, g in zip(params, grad_reduce(_grads_of(params))):
            p.grad = g
    elif autodiff_mean:
        _acc("grad_allreduce_ad", mesh, params,
             owner.reduce_grads if owner is not None
             else lambda: gradient_average(params, mesh),
             noted=True)
        optimizer = owner.actual_optimizer if owner is not None \
            else optimizer
    elif owner is None:
        gradient_average(params, mesh, allreduce_grad_dtype)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def _step_once(loss_of, optimizer, mesh, allreduce_grad_dtype):
    loss, metrics = loss_of()
    loss.backward()
    _apply(optimizer, [p for g in optimizer.param_groups for p in g["params"]],
           mesh, allreduce_grad_dtype,
           autodiff_mean=allreduce_grad_dtype is None)
    return _mean_metrics(loss.detach(), metrics, mesh)


def _microbatches(batch, steps):
    leaves = batch if isinstance(batch, (tuple, list)) else (batch,)
    rows = leaves[0].shape[0]
    if rows % steps:
        raise ValueError(f"per-rank batch {rows} not divisible by "
                         f"grad_accum_steps {steps}")
    per = rows // steps
    for i in range(steps):
        mb = tuple(t[i * per:(i + 1) * per] for t in leaves)
        yield mb if isinstance(batch, (tuple, list)) else mb[0]


def _accumulated_local_grads(local_loss, params, batch, steps):
    """The mean LOCAL loss / aux over ``steps`` microbatches, and each
    param's ``grad`` set to the mean of the microbatch gradients, summed in
    fp32 (JAX's ``_accumulated_local_grads``; each backward keeps only its
    microbatch's activations)."""
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    loss_sum, aux_sum = 0.0, {}
    for mb in _microbatches(batch, steps):
        loss, aux = local_loss(mb)
        for a, g in zip(acc, torch.autograd.grad(loss, params,
                                                 allow_unused=True)):
            if g is not None:
                a.add_(g.float())
        loss_sum = loss_sum + loss.detach().float()
        for k, v in aux.items():
            aux_sum[k] = aux_sum.get(k, 0.0) + torch.as_tensor(v).float()
    for p, a in zip(params, acc):
        p.grad = (a / steps).to(p.dtype)
    return loss_sum / steps, {k: v / steps for k, v in aux_sum.items()}


def make_train_step(loss_fn: Callable, optimizer, mesh=None,
                    axis_name: str = DEFAULT_AXIS_NAME, has_aux: bool = False,
                    allreduce_grad_dtype=None,
                    grad_reduce: Optional[Callable] = None,
                    grad_accum_steps: int = 1,
                    error_feedback: bool = False):
    """``step(module, batch) -> loss`` (``(loss, aux)`` with ``has_aux``):
    ``loss_fn(module, local_batch)`` is the mean loss over this rank's rows
    (and an aux dict of scalars), ``optimizer`` was built over the module's
    parameters.

    ``grad_reduce(grads) -> grads`` (lists of tensors) replaces the step's
    cross-rank gradient mean.  ``grad_accum_steps > 1`` splits this rank's
    rows into that many microbatches, their gradients summed in fp32 and
    divided by the count before the ONE cross-rank mean and update; a batch
    it does not divide raises.  ``allreduce_grad_dtype="int8"`` means the
    gradients through the block-scaled int8 ring.  ``error_feedback=True``
    (an optimizer of ``create_multi_node_optimizer(...,
    error_feedback=True)``): the optimizer owns the wire, and the local
    gradients reach it uncorrected; it excludes ``grad_reduce``."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got "
                         f"{grad_accum_steps}")
    if error_feedback and grad_reduce is not None:
        raise ValueError("error_feedback=True and grad_reduce are exclusive "
                         "(the optimizer owns the wire collective under EF)")
    if error_feedback and not getattr(optimizer, "error_feedback", False):
        raise ValueError("error_feedback=True needs the optimizer of "
                         "create_multi_node_optimizer(..., "
                         "error_feedback=True): it owns the wire collective")
    mesh = mesh or make_mesh(axis_name)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    # JAX's default path: the gradient mean is autodiff's (see _apply)
    autodiff_mean = (allreduce_grad_dtype is None and grad_reduce is None
                     and grad_accum_steps == 1 and not error_feedback)

    def step(module, batch):
        def local_loss(b):
            out = loss_fn(module, b)
            return out if has_aux else (out, {})

        module.train()
        if grad_accum_steps == 1:
            loss, aux = local_loss(batch)
            loss.backward()
        else:
            loss, aux = _accumulated_local_grads(local_loss, params, batch,
                                                 grad_accum_steps)
        _apply(optimizer, params, mesh, allreduce_grad_dtype, grad_reduce,
               autodiff_mean=autodiff_mean)
        loss, aux = _mean_metrics(loss.detach(), aux, mesh, aux=has_aux)
        return (loss, aux) if has_aux else loss

    return step


def make_flax_train_step(model, loss_and_metrics: Callable, optimizer,
                         mesh=None, axis_name: str = DEFAULT_AXIS_NAME,
                         allreduce_grad_dtype=None,
                         preprocess: Optional[Callable] = None):
    """``step(model, batch) -> (loss, metrics)`` for a flax-style module:
    ``loss_and_metrics(logits, batch) -> (loss, metrics)`` over this rank's
    rows; ``batch[0]`` goes into the model in training mode;
    ``preprocess(batch)`` runs first, on the device.  After the update the
    floating buffers (the running statistics, if the module has any: the
    NF-ResNets, ViT and ``norm="affine"`` have none) are meaned across
    ranks.  ``step.optimizer`` is ``optimizer`` (a checkpoint carries its
    state beside the model's)."""
    mesh = mesh or make_mesh(axis_name)
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    if any(id(p) not in owned for p in model.parameters()):
        raise ValueError("the optimizer must be built over model.parameters()")

    def step(module, batch):
        if module is not model:
            raise ValueError("the step was built for another module")
        if preprocess is not None:
            batch = preprocess(batch)
        module.train()

        def loss_of():
            return loss_and_metrics(module(batch[0]), batch)

        loss, metrics = _step_once(loss_of, optimizer, mesh,
                                   allreduce_grad_dtype)
        stats = [b for b in module.buffers() if b.is_floating_point()]
        with torch.no_grad():
            for b, m in zip(stats, _pmean(stats, mesh)):
                b.copy_(m)
        return loss, metrics

    step.optimizer = optimizer   # the state a checkpoint must carry
    return step


def replicate(module, communicator):
    """Rank 0's parameters and buffers on every rank (in place)."""
    return communicator.broadcast_data(module)


def _to_device(x, device):
    """A host array onto ``device`` as a copy: through pinned memory and a
    non-blocking copy on the card, so the caller may reuse its buffer."""
    t = torch.as_tensor(np.asarray(x))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


def shard_batch_local(local_batch, device):
    """This process's rows (a tuple of host arrays) on its device."""
    return tuple(_to_device(b, device) for b in local_batch)


def local_rows(batch, mesh):
    """Rank ``r``'s rows ``[r·B/P, (r+1)·B/P)`` of each host array of the
    global ``batch`` (a tuple), as numpy views."""
    rank = dist.get_rank(mesh.group)
    rows = len(batch[0])
    if rows % mesh.size:
        raise ValueError(f"global batch {rows} is not divisible by the "
                         f"world size {mesh.size}")
    per = rows // mesh.size
    return tuple(np.asarray(b)[rank * per:(rank + 1) * per] for b in batch)


def shard_batch(batch, device, mesh=None, axis_name: str = DEFAULT_AXIS_NAME):
    """Rank ``r``'s rows ``[r·B/P, (r+1)·B/P)`` of the global host batch
    every process holds, on ``device``."""
    return shard_batch_local(local_rows(batch, mesh or make_mesh(axis_name)),
                             device)


def _ring_mean(g, mesh, world: int):
    """Cross-rank mean as an explicit ring decomposition:
    ``all_gather(reduce_scatter(g) / P)`` when the leading dim divides by
    the world size, ``psum(g) / P`` otherwise (JAX's ``_ring_mean``: the
    same math as ``pmean``, spelled out so each wire leg is its own
    collective)."""
    from .ops import collective as col

    if world > 1 and g.dim() >= 1 and g.shape[0] % world == 0:
        return col.all_gather(col.reduce_scatter(g, mesh) / world, mesh)
    return col.psum(g, mesh) / world


def make_demo_step(mesh=None, axis_name: str = DEFAULT_AXIS_NAME):
    """The tanh-MLP classification step of ``python -m
    chainermn_tpu_torch.train`` (JAX's ``make_demo_step``).

    ``step(state, batch) -> (state, observation)``, the
    :class:`~chainermn_tpu_torch.training.StandardUpdater` contract, with
    ``state = (params, optimizer)``: ``params`` the dict ``w1, b1, w2, b2``
    of leaf tensors and ``optimizer`` a ``torch.optim`` optimizer over them
    (the torch counterpart of JAX's ``(params, opt_state)``).  The LOCAL
    loss is differentiated and :func:`_ring_mean` is the one cross-rank
    gradient mean; ``main/loss`` and ``main/accuracy`` are reduced with
    ``psum`` as JAX reduces them."""
    from .ops import collective as col

    mesh = mesh or make_mesh(axis_name)
    world = mesh.size

    def step(state, batch):
        params, optimizer = state
        x, y = batch
        h = torch.tanh(x @ params["w1"] + params["b1"])
        logits = h @ params["w2"] + params["b2"]
        logp = torch.log_softmax(logits, -1)
        nll = -logp.gather(1, y.long()[:, None]).mean()
        correct = (logits.argmax(-1) == y.long()).sum(dtype=torch.int32)
        names = list(params)
        grads = torch.autograd.grad(nll, [params[k] for k in names])
        for k, g in zip(names, grads):
            params[k].grad = _ring_mean(g, mesh, world)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        observation = {
            "main/loss": col.psum(nll.detach(), mesh) / world,
            "main/accuracy": col.psum(correct, mesh) / (x.shape[0] * world),
        }
        return state, observation

    return step


class _GoodputFold:
    """Folds the updater's phase stamps (data → host, compute → compute)
    and the extension pass (host) into a goodput ledger each iteration;
    priority 331, right after ``MetricsReport``'s 330 (JAX's CLI's
    fold)."""

    trigger = (1, "iteration")
    priority = 331

    def __init__(self, ledger):
        self.ledger = ledger

    def observe(self, trainer) -> None:
        phases = getattr(trainer.updater, "phase_times", None) or {}
        self.ledger.add("host", phases.get("data", 0.0))
        self.ledger.add("compute", phases.get("compute", 0.0))
        ext = getattr(trainer, "last_extension_time", None)
        if ext:
            self.ledger.add("host", ext)

    def __call__(self, trainer) -> None:
        pass

    def state_dict(self):
        return {}

    def load_state_dict(self, state):
        pass


def _parse(argv):
    import argparse

    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch demo trainer: a tanh MLP through "
                    "Trainer / StandardUpdater")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: this process's card) or cpu")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batchsize", type=int, default=64,
                        help="GLOBAL batch (split across the ranks)")
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--n-train", type=int, default=512)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--out", default="result")
    parser.add_argument("--prefetch", action="store_true",
                        help="assemble batch k+1 on a background thread "
                             "while step k runs")
    parser.add_argument("--trace-out", default=None,
                        help="write a Chrome-trace / Perfetto JSON here "
                             "(also enables tracing); at world > 1 each "
                             "rank writes its own shard, <base>.rankNNNNN"
                             ".json, and rank 0 merges them into this "
                             "path (one Perfetto lane a rank)")
    parser.add_argument("--metrics-out", default=None,
                        help="append a versioned JSONL metrics stream here "
                             "(also enables tracing); a Prometheus textfile "
                             "lands next to it at <path>.prom and the "
                             "cross-rank skew report is appended at exit")
    parser.add_argument("--watchdog-timeout", type=float, default=1800.0,
                        help="abort the gang (exit 43) when no step "
                             "completes for this many seconds")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="v2 manifest checkpoints here: a save every "
                             "--checkpoint-every iterations and automatic "
                             "resume, from another world size too")
    parser.add_argument("--checkpoint-every", type=int, default=5)
    parser.add_argument("--preemption-grace-s", type=float, default=None,
                        help="treat SIGTERM as a preemption: a final "
                             "checkpoint, a flight bundle and exit 0, all "
                             "within this grace budget (the save needs "
                             "--checkpoint-dir)")
    parser.add_argument("--self-heal", action="store_true",
                        help="run the rank health plane: a heartbeat lease "
                             "per rank over the process group's store and "
                             "a collective guard that names a lost rank "
                             "(exit 44) instead of hanging")
    parser.add_argument("--self-heal-min-world", type=int, default=1,
                        help="live-shrink floor: below this many survivors "
                             "heal() refuses and the job falls back to the "
                             "checkpoint restart")
    parser.add_argument("--self-heal-beat-s", type=float, default=0.05,
                        help="heartbeat interval; the detection window is "
                             "beat * (miss_beats + 1) with miss_beats=4")
    parser.add_argument("--statusz-port", type=int, default=None,
                        help="live introspection HTTP server (/statusz "
                             "/metricsz /requestz /debugz) on this port; "
                             "0 picks a free port (printed to stderr)")
    parser.add_argument("--flight-dump-dir", default=None,
                        help="crash-bundle directory of the flight recorder "
                             "(SIGTERM / SIGUSR1 / uncaught exception / "
                             "watchdog dumps land here; --out when "
                             "--trace-out, --metrics-out or "
                             "--statusz-port is given)")
    return parser.parse_args(argv)


def run(argv=None):
    """``python -m chainermn_tpu_torch.train``'s run: ``(result,
    trainer)``.  The JAX CLI's synthetic task and initial weights
    (``RandomState(42)`` map, ``(0)`` inputs, ``(1)`` weights), SGD with
    momentum 0.9, through create_communicator → StandardUpdater (rank
    ``r``'s rows of each global batch) → Trainer with the
    ObservationAggregator, the step breakdown, LogReport, PrintReport, the
    goodput fold and the Watchdog, and, as the flags ask, the health
    monitor and the metrics stream, the checkpointer (with resume), the
    preemption handler and the self-healing gang, wired as JAX's ``main``
    wires them."""
    import sys

    from .communicators import create_communicator
    from .convert import demo_params_from_numpy
    from .extensions import ObservationAggregator, Watchdog
    from .iterators import SerialIterator
    from .observability import (aggregate, anomaly, comm as ledger, export,
                                flight, introspect, metrics, slo, trace)
    from .training.extensions import LogReport, PrintReport
    from .training.trainer import PRIORITY_EDITOR, Trainer
    from .training.updaters import StandardUpdater

    args = _parse(argv)
    sink = bool(args.trace_out or args.metrics_out)
    if sink:
        trace.reset()
        ledger.get_accountant().reset()
        trace.enable()
    # the flight recorder: the ring always tees the tracer; crash bundles
    # go to --flight-dump-dir, or to --out once a sink or /statusz is on
    flight.install_tracer_tee()
    dump_dir = args.flight_dump_dir or (
        args.out if sink or args.statusz_port is not None else None)
    # run() is also called in-process (tests, the smoke): the handlers and
    # the hook it installs are put back as they were when it returns
    restore = {}
    if dump_dir:
        import signal

        from . import global_except_hook
        restore = {sig: signal.getsignal(sig)
                   for sig in (signal.SIGTERM, signal.SIGUSR1)}
        flight.install_signal_handlers(dump_dir)
        global_except_hook.add_hook()
    comm = create_communicator("xla", device=args.device)
    world = comm.size
    rank = comm.rank if world > 1 else None
    if args.batchsize % world:
        raise SystemExit(f"--batchsize {args.batchsize} must divide by the "
                         f"world size {world}")

    in_dim, n_classes = 32, 10
    w_true = np.random.RandomState(42).randn(in_dim, n_classes)
    xs = np.random.RandomState(0).randn(args.n_train, in_dim).astype(
        np.float32)
    ys = (xs @ w_true).argmax(-1).astype(np.int32)
    dataset = list(zip(xs, ys))
    rng = np.random.RandomState(1)
    params = demo_params_from_numpy({
        "w1": (rng.randn(in_dim, args.hidden) / np.sqrt(in_dim)
               ).astype(np.float32),
        "b1": np.zeros((args.hidden,), np.float32),
        "w2": (rng.randn(args.hidden, n_classes) / np.sqrt(args.hidden)
               ).astype(np.float32),
        "b2": np.zeros((n_classes,), np.float32),
    }, comm.device)
    optimizer = torch.optim.SGD(list(params.values()), lr=args.lr,
                                momentum=0.9)

    updater = StandardUpdater(
        SerialIterator(dataset, args.batchsize, seed=0),
        make_demo_step(comm.mesh), (params, optimizer), mesh=comm.mesh,
        prefetch=args.prefetch, device=comm.device)
    trainer = Trainer(updater, (args.steps, "iteration"), out=args.out)
    trainer.extend(ObservationAggregator(comm), trigger=(1, "iteration"),
                   priority=PRIORITY_EDITOR)
    trainer.extend(metrics.StepBreakdownReport(
        items_per_step=args.batchsize))
    monitor = None
    if sink:
        monitor = anomaly.HealthMonitor()
        trainer.extend(monitor)
    metrics_path = None
    if args.metrics_out:
        metrics_path = (aggregate.shard_path(args.metrics_out, rank)
                        if rank is not None else args.metrics_out)
        trainer.extend(export.MetricsReport(
            metrics_path, prometheus_path=metrics_path + ".prom",
            monitor=monitor, rank=rank))
    # goodput of the train loop: data → host, compute → compute, the
    # extension pass → host; surfaced by /statusz and the result
    goodput = slo.GoodputLedger()
    trainer.extend(_GoodputFold(goodput), name="goodput_fold")
    flight.register_provider("train", lambda: {
        "iteration": trainer.iteration, "last_phase": trainer.last_phase,
        "elapsed_time": trainer.elapsed_time, "goodput": goodput.report()})
    statusz = None
    if args.statusz_port is not None:
        statusz = introspect.start_status_server(
            args.statusz_port, dump_dir=dump_dir, rank=rank)
        statusz_port = statusz.port
    log = LogReport(trigger=(args.log_every, "iteration"))
    trainer.extend(log)
    trainer.extend(PrintReport(
        ["iteration", "main/loss", "main/accuracy", "time/data",
         "time/compute", "comm/bytes", "throughput/items_per_sec"],
        log, trigger=(args.log_every, "iteration")))
    trainer.extend(Watchdog(timeout=args.watchdog_timeout, dump_dir=args.out,
                            monitor=monitor, rank=rank))
    # v2 manifest checkpoints resume across world-size changes; SIGTERM
    # within the grace budget saves a final generation, books the save
    # into the goodput ledger's `checkpoint` bucket, dumps a `preempt`
    # bundle and exits 0
    checkpointer = None
    if args.checkpoint_dir:
        from .extensions import create_multi_node_checkpointer
        checkpointer = create_multi_node_checkpointer(
            "train", comm, cp_interval=args.checkpoint_every,
            path=args.checkpoint_dir)
        trainer.extend(checkpointer,
                       trigger=(args.checkpoint_every, "iteration"))
        loaded, it_resumed = checkpointer.maybe_load()
        if it_resumed is not None:
            trainer.load_checkpoint_state(loaded)
            print(f"[chainermn_tpu_torch train] resumed from generation "
                  f"{it_resumed} in {args.checkpoint_dir}", file=sys.stderr,
                  flush=True)
    if args.preemption_grace_s is not None:
        from .extensions import PreemptionHandler
        # installed after the flight handlers: SIGTERM now means
        # checkpoint-and-exit-0, SIGUSR1 stays dump-and-continue
        trainer.extend(PreemptionHandler(
            checkpointer, grace_s=args.preemption_grace_s,
            dump_dir=dump_dir or args.out, ledger=goodput, rank=rank))
    # the rank health plane: a heartbeat lease per rank over the process
    # group's store, and the collective guard on every eager collective:
    # a rank lost mid-collective aborts loudly naming it (exit 44, a
    # `rank_lost` bundle) instead of wedging the gang
    gang = None
    if args.self_heal:
        from .extensions import SelfHealingGang
        gang = SelfHealingGang(
            comm.gang_lease_store(), rank=comm.rank, world=world,
            name="train", beat_interval_s=args.self_heal_beat_s,
            min_world=args.self_heal_min_world,
            dump_dir=dump_dir or args.out)
        gang.start()
        # the join barrier before any detector is armed: a peer that has
        # not started yet must not read as a death
        gang.wait_for_members(timeout_s=120.0)
        # the guard's bound is the gang's op bound, floored at 30 s so a
        # slow object collective is not mistaken for a death
        gang.install_collective_guard(timeout_s=max(gang.op_timeout_s, 30.0))
    try:
        trainer.run()
    finally:
        if gang is not None:
            gang.stop()
        if statusz is not None:
            statusz.stop()
        updater.close()
        flight.unregister_provider("train")
        if restore:
            import signal

            from . import global_except_hook
            for sig, prev in restore.items():
                signal.signal(sig, prev)
            global_except_hook.remove_hook()

    final = log.log[-1] if log.log else {}
    result = {"steps": trainer.iteration, "world": world,
              "final_loss": final.get("main/loss"),
              "final_accuracy": final.get("main/accuracy"),
              "goodput": goodput.report()}
    if gang is not None:
        st = gang.stats()
        result["self_heal"] = {
            k: st[k] for k in (
                "epoch", "world", "min_world", "detection_window_s",
                "rank_lost_events", "reconfigs", "fenced_refusals")}
    if statusz is not None:
        result["statusz_port"] = statusz_port
    if args.trace_out:
        trace.export_chrome_trace(args.trace_out, rank=rank)
        result["trace_out"] = (args.trace_out if rank is None
                               else trace.shard_path(args.trace_out, rank))
        result["trace_events"] = len(trace.get_tracer().events())
        result["comm_totals"] = {
            k: {kk: vv for kk, vv in v.items() if kk != "host_time_s"}
            for k, v in ledger.get_accountant().report()["per_op"].items()}
        if rank is not None:
            # every shard on disk before rank 0 merges them
            comm.allgather_obj("trace-exported")
            if rank == 0:
                merged = aggregate.merge_trace_shards(
                    args.trace_out, out_path=args.trace_out,
                    expected_ranks=world)
                result["merged_trace"] = args.trace_out
                result["merged_ranks"] = merged["metadata"]["merged_ranks"]
    if sink:
        # the cross-rank skew report: a collective over the object lane
        skew = aggregate.cross_rank_report(comm)
        result["straggler_rank"] = skew["straggler_rank"]
        result["step_time_skew"] = {
            k: round(v, 6) for k, v in skew["step_time"].items()
            if k != "per_rank"}
        if metrics_path and (rank is None or rank == 0):
            w = export.MetricsWriter(metrics_path, rank=rank)
            w.write(skew, kind="skew_report")
            w.close()
        trace.disable()
    return result, trainer


def main(argv=None) -> int:
    """``python -m chainermn_tpu_torch.train``: the JAX package's demo
    trainer (``python -m chainermn_tpu.train``) on the port, one process
    per rank (``torchrun --nproc-per-node N`` for N > 1), wired through
    the observability stack (the step breakdown, the comm ledger, the
    health monitor, ``--trace-out`` and ``--metrics-out``) and the
    robustness flags: the watchdog (always on), checkpoints with resume,
    preemption, the self-healing gang and the flight recorder's crash
    bundles.  Prints JAX's result as one JSON line.  ``--statusz-port``
    serves ``/statusz`` (with the ``train`` provider) while it runs.
    ``--devices`` (JAX's virtual CPU devices) is ``--device`` and
    torchrun here."""
    import json

    result, _ = run(argv)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
