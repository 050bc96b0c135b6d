#!/usr/bin/env python
"""CLI: train the toy LM, then serve it with continuous batching.

``python -m chainermn_tpu.serve``'s single-engine path with the same flags:
train the LM on the arithmetic-progression corpus (``--train-steps``,
default 60, Adam at ``--lr`` on ``--seq-len`` tokens; the loss goes to
stderr every 30 steps), then stand up a
:class:`chainermn_tpu_torch.serving.ServingEngine` and push a
STAGGERED request schedule through it (the first wave fills the slot pool,
later requests arrive every ``--stagger-every`` engine steps while it is
still decoding).  Prompts come from the same arithmetic-progression corpus
as the JAX CLI.  Prints one ``chainermn_tpu.serve.v1`` summary JSON line
on stdout (per-request outcomes + the serving metrics).

``--tp N`` (launched by ``torchrun``, or by ``--devices``; N must divide
the world size) trains on the ``(world/N, N)`` ``('data', 'model')`` mesh
and serves on the first N ranks with the model sharded over them: rank 0
hosts the service (the engine, or the router with every replica, or the
role-split fleet with every worker), runs its queues and prints the
summary, ranks 1 to N-1 build the same service and follow its plan, and
the other ranks stop after training.  ``--devices N`` is the JAX CLI's
flag: it forces the CPU and starts the N ranks itself, over gloo, as
``torchrun --nproc-per-node N ... --device cpu`` would (so ``--devices 2
--tp 2 --disagg 1:1`` runs in one command).

``--replicas N`` stands up N engines on the card behind the serving
router (``serving.build_fleet``: prefix-affine, least-loaded dispatch and
SLO-aware shedding); the summary then carries the ``router/*`` keys and
each replica's goodput.  ``--disagg P:D`` serves through the
disaggregated fleet instead (``serving.build_disagg_fleet``: P prefill
workers, D decode workers, the KV-transfer plane between them over
``--transport local`` (a row copy on the card) or ``lanes`` (pack, object
lane, unpack, the slab bytes booked in the comm ledger)); the summary
carries ``disagg``, the ``disagg/*`` keys and every worker's goodput.
``--fleet-procs N`` spawns N engine workers as separate processes over the
file lanes in ``--lane-dir`` (``serving.build_proc_fleet``: each worker on
the card, supervised by the heartbeat / lease plane with in-flight
failover and zombie fencing); ``--disagg P:D --procs`` runs the role-split
workers as processes the same way.  The load generator retries a rejected
submit (``serving.submit_with_retry``: ``--submit-retries`` attempts,
honoring ``retry_after_ms``), the run ends with a graceful rolling drain,
and the summary's ``fleet_exit_codes`` holds every worker's exit code.
``--autoscale MIN:MAX`` (with ``--fleet-procs``) attaches the load-driven
autoscaler: a scale-up spawns worker processes on the run's device, a
scale-down always drains; its decisions land as ``autoscale_decision``
flight events and under ``autoscale`` in the summary.  A worker process
serves at the width JAX's worker gets under the same flags, the number
of devices the CLI runs on (its ranks: ``--devices N`` or torchrun's
world): at a width T > 1 each worker is a group of T processes (its
leader holds the lease; NCCL when each rank has its own card, gloo on the
CPU or one shared card), the ranks gather the trained params to rank 0,
which spawns the fleet, and the summary's ``fleet_group`` names the width
and the backend.
``--tenants`` bills even requests to the paid tenant ``gold`` and odd ones
to the budgeted best-effort ``free`` (a router topology only).
``--metrics-out`` streams the JSONL metrics (``serving_step`` records and
a ``serving_summary``, the router's ``router_rejection`` /
``router_summary``, or the fleet's ``disagg_summary``), ``--prom-out``
writes a
Prometheus textfile at the end, ``--trace-out`` turns the tracer on and
writes its Chrome trace, ``--flight-dump-dir`` arms the flight recorder's
crash bundles (SIGTERM / SIGUSR1 / an uncaught exception), and
``--ttft-slo-ms`` / ``--tps-slo`` attach the burn-rate tracker (its
status lands in the summary), and ``--statusz-port`` serves ``/statusz``,
``/metricsz``, ``/requestz`` and ``/debugz`` while the run lasts (0 picks
a free port, printed to stderr).  The engines run with JAX's defaults: the
prefix cache and a 32 MiB host spill tier.

The model is random-init from ``--seed`` (or loaded with ``--params`` from
a ``convert.save_npz`` file) before training; ``--train-steps 0`` serves
it untrained.  ``--kv-heads`` makes it a GQA model.  ``--temperature T``
samples every request at ``T``, request ``i`` with the key
``fold_in(PRNGKey(seed + 1), i)`` (the JAX CLI's keys, so both CLIs draw
the same noise).

Run:  python -m chainermn_tpu_torch.serve --device cuda
      torchrun --nproc-per-node 2 -m chainermn_tpu_torch.serve --tp 2
      python -m chainermn_tpu_torch.serve --devices 2 --tp 2 --disagg 1:1
      python -m chainermn_tpu_torch.serve --devices 2 --tp 2 --fleet-procs 2
      python -m chainermn_tpu_torch.serve --device cuda --fleet-procs 1 \
          --autoscale 1:2 --statusz-port 0
      python -m chainermn_tpu_torch.serve --device cuda --replicas 2 \\
          --metrics-out serve.jsonl --prom-out serve.prom
      python -m chainermn_tpu_torch.serve --device cuda --disagg 1:2 \\
          --transport lanes --tenants
      python -m chainermn_tpu_torch.serve --device cuda --fleet-procs 2
      python -m chainermn_tpu_torch.serve --device cuda --disagg 1:1 --procs
      python -m chainermn_tpu_torch.serve --device cuda --dtype bfloat16 \\
          --vocab 32768 --d-model 1024 --n-heads 16 --n-layers 8 \\
          --n-slots 8 --max-total 1024 --requests 16 --prompt-len 512 \\
          --max-new-tokens 64
      python -m chainermn_tpu_torch.serve --device cpu --requests 4
"""

import argparse
import json
import os
import sys
import time


def make_corpus(rng, n, seq_len, vocab):
    """Arithmetic progressions mod vocab (the JAX CLI's corpus)."""
    import numpy as np

    starts = rng.randint(0, vocab, n)
    steps = rng.randint(1, 4, n)
    pos = np.arange(seq_len + 1)
    return ((starts[:, None] + steps[:, None] * pos[None]) % vocab
            ).astype("int32")


def train(params, args, head_dim, vocab, mesh):
    """The JAX CLI's recipe on the ``('data', 'model')`` mesh: Adam at
    ``args.lr``, global batches of ``8 · dp`` corpus sequences of
    ``args.seq_len + 1`` tokens from ``RandomState(0)``, each data rank
    taking its 8.  Returns this rank's trained shards, detached."""
    from functools import partial

    import numpy as np
    import torch

    from chainermn_tpu_torch.convert import tree_map
    from chainermn_tpu_torch.parallel import (make_hybrid_train_step,
                                              param_leaves,
                                              tp_transformer_lm_loss)

    optimizer = torch.optim.Adam(param_leaves(params), lr=args.lr)
    step = make_hybrid_train_step(
        partial(tp_transformer_lm_loss, head_dim=head_dim,
                axis_name="model"), optimizer, params, mesh)
    rng = np.random.RandomState(0)
    device = params["embed"].device
    dp = mesh.shape["data"]
    for i in range(args.train_steps):
        tokens = make_corpus(rng, 8 * dp, args.seq_len, vocab)
        loss = step(params, (torch.as_tensor(tokens, device=device),))
        if i % 30 == 0 or i == args.train_steps - 1:
            print(f"train step {i:3d}  loss {float(loss):.4f}",
                  file=sys.stderr)
    return tree_map(params, lambda t: t.detach())


def run(argv=None, params=None):
    """Train, then serve; returns the ``chainermn_tpu.serve.v1`` summary on
    model rank 0 of the serving ranks, None on the others.  ``params``:
    global initial params (the JAX package's numpy tree, or the port's
    tensors) in place of the random init or ``--params``."""
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch serving demo: continuous-batching "
                    "inference over a slot-managed KV-cache pool")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--devices", type=int, default=0,
                        help="start N ranks on the CPU over gloo (0 = "
                             "leave the launch alone: one process, or "
                             "torchrun's)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--tp", type=int, default=1,
                        help="model-axis width for serving (and training)")
    parser.add_argument("--params", default=None,
                        help="load params from a convert.save_npz file "
                             "instead of a random init")
    parser.add_argument("--vocab", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=32)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--kv-heads", type=int, default=None,
                        help="KV heads (GQA); default: one per query head")
    parser.add_argument("--seq-len", type=int, default=24)
    parser.add_argument("--pos-impl", default="learned",
                        choices=["learned", "rope"])
    parser.add_argument("--train-steps", type=int, default=60,
                        help="toy-LM training steps before serving")
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random init")
    parser.add_argument("--n-slots", type=int, default=4)
    parser.add_argument("--max-total", type=int, default=None,
                        help="per-slot capacity (default: fits prompt + "
                             "max-new)")
    parser.add_argument("--queue-capacity", type=int, default=16)
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--prompt-len", type=int, default=6)
    parser.add_argument("--max-new-tokens", type=int, default=8)
    parser.add_argument("--stagger-every", type=int, default=2,
                        help="submit one later-wave request every N engine "
                             "steps after the first wave")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="per-request sampling temperature (0 = greedy); "
                             "request i samples with fold_in(PRNGKey(seed + "
                             "1), i)")
    parser.add_argument("--steps-budget", type=int, default=None,
                        help="hard cap on engine iterations (the run exits "
                             "cleanly with whatever finished)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="serving replicas behind the router: N "
                             "engines, least-loaded prefix-affine "
                             "dispatch, SLO-aware shedding; 1 = the "
                             "single-engine path")
    parser.add_argument("--disagg", default=None, metavar="P:D",
                        help="disaggregated topology: P prefill workers + D "
                             "decode workers with the KV-transfer plane "
                             "between them (e.g. --disagg 1:2); mutually "
                             "exclusive with --replicas > 1")
    parser.add_argument("--transport", default="local",
                        choices=["local", "lanes"],
                        help="disagg KV-transfer transport: 'local' = a row "
                             "copy between the pools on the card, 'lanes' = "
                             "the object lanes (ledger-booked bytes)")
    parser.add_argument("--fleet-procs", type=int, default=0,
                        help="cross-PROCESS fleet: spawn N engine workers "
                             "as separate processes over the file lanes, "
                             "supervised by the heartbeat/lease health "
                             "plane with in-flight failover; mutually "
                             "exclusive with --replicas > 1 / --disagg")
    parser.add_argument("--procs", action="store_true",
                        help="with --disagg P:D: run the role workers as "
                             "separate PROCESSES over the lanes instead of "
                             "in-process")
    parser.add_argument("--lane-dir", default=None,
                        help="directory for the cross-process file lanes "
                             "(default: a fresh temp dir)")
    parser.add_argument("--beat-interval-s", type=float, default=0.05,
                        help="worker heartbeat interval; the router "
                             "declares death after miss_beats=4 missed "
                             "beats (detection window = beat * (4+1))")
    parser.add_argument("--submit-retries", type=int, default=3,
                        help="client-side submit attempts: shed/full "
                             "rejections honor retry_after_ms with "
                             "jittered backoff before giving up "
                             "machine-readably (submit_with_retry)")
    parser.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                        help="with --fleet-procs: attach the load-driven "
                             "autoscaler (scale-up spawns worker "
                             "processes, scale-down always drains; e.g. "
                             "--autoscale 1:4); decisions land as "
                             "autoscale_decision flight events and in the "
                             "summary")
    parser.add_argument("--tenants", action="store_true",
                        help="two-tenant QoS demo: even requests bill to "
                             "tenant 'gold' (paid), odd to 'free' "
                             "(best_effort, budgeted); needs a router "
                             "topology (--replicas/--disagg/--fleet-procs)")
    parser.add_argument("--metrics-out", default=None,
                        help="JSONL metrics stream (serving_step records + "
                             "serving_summary roll-up)")
    parser.add_argument("--prom-out", default=None,
                        help="Prometheus textfile with the serving gauges")
    parser.add_argument("--trace-out", default=None,
                        help="enable the tracer; Chrome-trace JSON with the "
                             "per-request serving spans/instants")
    parser.add_argument("--statusz-port", type=int, default=None,
                        help="start the live introspection HTTP server "
                             "(/statusz /metricsz /requestz /debugz) on "
                             "this port; 0 picks a free port (printed to "
                             "stderr)")
    parser.add_argument("--flight-dump-dir", default=None,
                        help="enable the flight recorder's crash bundles: "
                             "SIGTERM/SIGUSR1/uncaught exceptions dump a "
                             "debug bundle into this directory")
    parser.add_argument("--ttft-slo-ms", type=float, default=None,
                        help="TTFT SLO target; enables the multi-window "
                             "burn-rate tracker")
    parser.add_argument("--tps-slo", type=float, default=None,
                        help="tokens/sec SLO target for the burn tracker")
    args = parser.parse_args(argv)
    if args.devices:
        if args.devices < 1 or args.devices % args.tp:
            raise SystemExit(f"--tp {args.tp} does not divide "
                             f"{args.devices} devices")
        if "RANK" not in os.environ:
            return _launch_ranks(list(sys.argv[1:] if argv is None
                                      else argv), args.devices, params)
        args.device = "cpu"
    if args.tenants and args.replicas <= 1 and not args.disagg \
            and not args.fleet_procs:
        raise SystemExit("--tenants needs a router topology (--replicas N "
                         "/ --disagg P:D / --fleet-procs N) — the tenant "
                         "plane lives at the router's admission gate")
    n_p = n_d = 0
    if args.disagg:
        if args.replicas > 1:
            raise SystemExit("--disagg and --replicas > 1 are mutually "
                             "exclusive topologies")
        try:
            n_p, n_d = (int(x) for x in args.disagg.split(":"))
        except ValueError:
            raise SystemExit(f"--disagg wants P:D (e.g. 1:2), got "
                             f"{args.disagg!r}")
        if n_p < 1 or n_d < 1:
            raise SystemExit(f"--disagg needs at least one worker per "
                             f"role, got {args.disagg!r}")
    autoscale_range = None
    if args.autoscale:
        # validated before build_proc_fleet: failing after the spawn would
        # leak orphaned worker processes on the SystemExit
        if not args.fleet_procs:
            raise SystemExit("--autoscale drives the cross-process "
                             "fleet: combine it with --fleet-procs N")
        try:
            autoscale_range = tuple(
                int(x) for x in args.autoscale.split(":"))
        except ValueError:
            raise SystemExit(f"--autoscale wants MIN:MAX (e.g. 1:4), "
                             f"got {args.autoscale!r}")
        if len(autoscale_range) != 2 \
                or not 1 <= autoscale_range[0] <= autoscale_range[1]:
            raise SystemExit(f"--autoscale needs 1 <= MIN <= MAX, "
                             f"got {args.autoscale!r}")
    procs = bool(args.fleet_procs or (args.disagg and args.procs))
    if procs:
        if args.fleet_procs and (args.replicas > 1 or args.disagg):
            raise SystemExit("--fleet-procs is mutually exclusive with "
                             "--replicas > 1 / --disagg")

    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch import prng
    from chainermn_tpu_torch._device import resolve_device
    from chainermn_tpu_torch.convert import (gather_to_numpy, load_npz,
                                             shard_from_jax, tree_map)
    from chainermn_tpu_torch.parallel import (init_tp_transformer_lm,
                                              transformer_lm_specs)
    from chainermn_tpu_torch.serving import (AdmissionError, ServingEngine,
                                             TenantTable, build_disagg_fleet,
                                             build_fleet, build_proc_fleet,
                                             submit_with_retry)
    from chainermn_tpu_torch.topology import (dp_tp_mesh, init_distributed,
                                              make_nd_mesh)

    if args.trace_out:
        obs.enable()
    # the flight recorder: always on (a bounded ring); crash bundles and
    # signal handlers only with a dump directory
    obs.install_tracer_tee()
    if args.flight_dump_dir:
        from chainermn_tpu_torch import global_except_hook
        obs.install_signal_handlers(args.flight_dump_dir)
        global_except_hook.add_hook()

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    init_distributed(device)
    train_mesh = dp_tp_mesh(args.tp, "--tp {tp} does not divide {n} devices")
    total_len = args.prompt_len + args.max_new_tokens
    max_total = args.max_total or max(total_len, 8)
    if params is None and args.params:
        params = load_npz(args.params, device="cpu", dtype=dtype)
    elif params is None:
        params = init_tp_transformer_lm(
            torch.Generator().manual_seed(args.seed), args.vocab,
            args.d_model, args.n_heads, args.n_layers,
            max_len=max(max_total, args.seq_len), dtype=dtype,
            n_kv_heads=args.kv_heads, pos_impl=args.pos_impl, device="cpu")
    head_dim = params["embed"].shape[1] // args.n_heads
    vocab = params["embed"].shape[0]
    params = shard_from_jax(params, transformer_lm_specs(params, "model"),
                            train_mesh, device=device, dtype=dtype)
    if args.train_steps > 0:
        params = train(params, args, head_dim, vocab, train_mesh)
    serve_mesh = width = None
    if procs:
        # a worker serves at the width of this launch (JAX's worker
        # meshes every device its process sees); rank 0 spawns the fleet
        # from the global params
        width = dist.get_world_size()
        if width > 1:
            host = gather_to_numpy(params,
                                   transformer_lm_specs(params, "model"),
                                   train_mesh)
            if dist.get_rank() != 0:
                return None
            params = tree_map(host, lambda a: torch.as_tensor(a).to(dtype))
    else:
        # serving on the first tp ranks: their model coordinates on the
        # training mesh are the serving mesh's, so their shards carry over
        serve_mesh = make_nd_mesh(("model",), (args.tp,), range(args.tp))
        if serve_mesh.coords is None:
            return None
    writer = None
    if args.metrics_out and dist.get_rank() == 0:
        from chainermn_tpu_torch.observability.export import MetricsWriter
        writer = MetricsWriter(args.metrics_out)
    slo = None
    if args.ttft_slo_ms is not None or args.tps_slo is not None:
        from chainermn_tpu_torch.observability.slo import SLOTracker
        slo = SLOTracker(ttft_target_ms=args.ttft_slo_ms,
                         tokens_per_sec_target=args.tps_slo)
    eng_kwargs = dict(head_dim=head_dim, n_slots=args.n_slots,
                      max_total=max_total, mesh=serve_mesh,
                      queue_capacity=args.queue_capacity, device=device)
    tenancy = None
    if args.tenants:
        tenancy = TenantTable()
        tenancy.register("gold", "paid")
        # the best-effort tenant carries a modest concurrency budget so
        # the demo shows budget sheds under the staggered burst
        tenancy.register("free", "best_effort",
                         max_inflight=max(args.n_slots // 2, 1))
    router = eng = disagg = fleet = autoscaler = None
    fleet_exit_codes = None
    if procs:
        # every worker a separate process over the file lanes, on this
        # run's device, supervised by the lease plane
        import tempfile
        topology = ({"engine": args.fleet_procs} if args.fleet_procs
                    else {"prefill": n_p, "decode": n_d})
        lane_dir = args.lane_dir or tempfile.mkdtemp(
            prefix="chainermn_tpu_lanes_")
        fleet = build_proc_fleet(
            params, topology, lane_dir, head_dim=head_dim,
            beat_interval_s=args.beat_interval_s,
            bundle_dir=args.flight_dump_dir, device=device.type,
            worker_kwargs=dict(n_slots=args.n_slots, max_total=max_total,
                               queue_capacity=args.queue_capacity),
            tp=width, slo=slo, metrics_writer=writer, tenancy=tenancy)
        group = ("" if width == 1 else
                 f" of {width} ranks each over {fleet.group['backend']}")
        print(f"fleet: spawned {topology} worker process(es){group}, "
              f"lanes at {lane_dir}", file=sys.stderr)
        if autoscale_range is not None:
            from chainermn_tpu_torch.serving.autoscale import (
                AutoscalePolicy, FleetAutoscaler, proc_spawn_factory)
            lo, hi = autoscale_range
            autoscaler = FleetAutoscaler(
                fleet,
                proc_spawn_factory(
                    lane_dir, os.path.join(lane_dir, "fleet_params.pkl"),
                    beat_interval_s=args.beat_interval_s,
                    bundle_dir=args.flight_dump_dir, device=device.type,
                    tp=width),
                policies=[AutoscalePolicy(
                    role=role, min_workers=lo, max_workers=hi)
                    for role in topology],
                metrics_writer=writer)
            print(f"autoscale: {args.autoscale} attached (scale-down is "
                  f"always a drain)", file=sys.stderr)
        service = fleet
    elif args.disagg:
        disagg = build_disagg_fleet(
            params, n_p, n_d, transport_mode=args.transport, slo=slo,
            metrics_writer=writer, tenancy=tenancy,
            bundle_dir=args.flight_dump_dir, **eng_kwargs)
        service = disagg
    elif args.replicas > 1:
        # one SLO tracker for the fleet (every replica burns one budget);
        # the router owns the JSONL writer
        router = build_fleet(params, args.replicas, slo=slo,
                             metrics_writer=writer, tenancy=tenancy,
                             **eng_kwargs)
        service = router
    else:
        eng = ServingEngine(params, metrics_writer=writer, slo=slo,
                            **eng_kwargs)
        service = eng
    if not (eng.engine.leader if eng is not None else service.leader):
        # a model rank of the service: run its leader's device calls
        service.follow()
        return None
    statusz = None

    test = make_corpus(np.random.RandomState(99), args.requests, total_len,
                       vocab)
    prompts = test[:, : args.prompt_len]
    want = test[:, args.prompt_len: args.prompt_len + args.max_new_tokens]

    handles, rejected = {}, {}
    sample_kw = {}
    if args.temperature > 0:
        base_key = prng.PRNGKey(args.seed + 1)
        sample_kw = {i: {"temperature": args.temperature,
                         "rng": prng.fold_in(base_key, i)}
                     for i in range(args.requests)}

    # client-side honor of retry_after_ms: a rejected submit backs off
    # (jittered, bounded) and retries before giving up machine-readably;
    # while it waits the service keeps being driven, so the backlog the
    # rejection named can drain
    def driving_sleep(seconds):
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            service.step()

    def submit(i):
        tenant_kw = {}
        if tenancy is not None:
            tenant_kw = {"tenant": "gold" if i % 2 == 0 else "free"}
        try:
            handles[i] = submit_with_retry(
                service.submit, prompts[i], args.max_new_tokens,
                max_attempts=max(args.submit_retries, 1),
                sleep=driving_sleep, **tenant_kw, **sample_kw.get(i, {}))
        except AdmissionError as e:
            rejected[i] = e.to_dict()
            print(f"request {i} rejected after "
                  f"{max(args.submit_retries, 1)} attempt(s): {e}",
                  file=sys.stderr)

    try:     # the followers wait in follow() until the leader closes
        if args.statusz_port is not None:
            statusz = obs.start_status_server(
                args.statusz_port, extra_gauges=service.metrics,
                requests_fn=service.requests_table,
                dump_dir=args.flight_dump_dir)
        first_wave = min(args.n_slots, args.requests)
        for i in range(first_wave):
            submit(i)
        steps, nxt = 0, first_wave
        budget = args.steps_budget

        def busy():
            if fleet is not None:
                return fleet.busy
            if disagg is not None:
                return (any(not w.idle for w in disagg.prefill_workers)
                        or any(not w.idle for w in disagg.decode_workers))
            if router is not None:
                return any(not rep.idle for rep in router.replicas)
            return eng.scheduler.queue_depth > 0 or eng.pool.busy_count > 0

        while (budget is None or steps < budget) and (nxt < args.requests
                                                      or busy()):
            service.step()
            steps += 1
            if nxt < args.requests and steps % max(args.stagger_every, 1) == 0:
                submit(nxt)
                nxt += 1
        if autoscaler is not None:
            # latched off first: the below-min rule would re-spawn what
            # the drain takes down
            autoscaler.stop()
        if fleet is not None:
            # graceful rolling drain: in-flight work finishes, nothing
            # sheds, every worker exits 0
            for name in list(fleet.workers):
                if fleet.workers[name].state in ("starting", "live"):
                    fleet.drain(name)
                    fleet.wait_drained(name, timeout_s=60)
            fleet_exit_codes = fleet.shutdown()
            print(f"fleet: drained; worker exit codes {fleet_exit_codes}",
                  file=sys.stderr)
        metrics = service.metrics()
        if fleet is not None:
            goodput = fleet.goodput.report()
        elif disagg is not None:
            # per-worker wall-clock partitions: the prefill ledgers carry
            # the transfer bucket, the decode ledgers the ticks
            goodput = dict(
                {w.name: w.goodput.report()
                 for w in disagg.prefill_workers},
                **{w.name: w.engine.goodput.report()
                   for w in disagg.decode_workers})
        elif router is not None:
            goodput = {rep.name: rep.engine.goodput.report()
                       for rep in router.replicas}
        else:
            goodput = eng.goodput.report()
        if writer is not None:
            service.finalize_metrics()
            writer.close()
        if args.prom_out:
            service.write_prometheus(args.prom_out)
        if args.trace_out:
            obs.export_chrome_trace(args.trace_out)
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        if statusz is not None:
            statusz.stop()
        if fleet is not None and fleet_exit_codes is None:
            fleet.shutdown()         # every worker reaped, or killed
        service.close()

    per_request, correct = [], []
    for i in range(args.requests):
        if i in rejected:
            per_request.append(dict({"id": i, "status": "rejected"},
                                    **rejected[i]))
            continue
        h = handles.get(i)
        if h is None:
            per_request.append({"id": i, "status": "not_submitted"})
            continue
        toks = h.tokens
        row = {"id": h.id, "status": h.status,
               "finish_reason": h.finish_reason, "n_tokens": len(toks),
               "tokens": toks,
               "ttft_ms": (round(h.ttft_ms, 2)
                           if h.ttft_ms is not None else None)}
        if h.status == "done" and len(toks) == args.max_new_tokens:
            acc = float((np.asarray(toks) == want[i]).mean())
            row["continuation_accuracy"] = round(acc, 3)
            correct.append(acc)
        per_request.append(row)

    summary = {
        "schema": "chainermn_tpu.serve.v1",
        "engine_steps": steps,
        "replicas": args.replicas,
        "disagg": args.disagg,
        "fleet_procs": args.fleet_procs or (
            len(fleet.workers) if fleet is not None else 0),
        "fleet_exit_codes": fleet_exit_codes,
        "device": str(device),
        "dtype": args.dtype,
        "tp": args.tp,
        "world": dist.get_world_size(),
        "requests": per_request,
        "mean_continuation_accuracy": (
            round(float(np.mean(correct)), 3) if correct else None),
        "metrics": {k: round(float(v), 3) for k, v in metrics.items()},
        "goodput": goodput,
    }
    if fleet is not None and width > 1:
        summary["fleet_group"] = dict(fleet.group)
    if slo is not None:
        summary["slo"] = slo.status()
    if tenancy is not None:
        summary["tenancy"] = tenancy.state()
    if autoscaler is not None:
        summary["autoscale"] = autoscaler.state()
    return summary


def _launch_ranks(argv, n, params=None):
    """``--devices N``: run this CLI as N ranks on the CPU over gloo
    (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, a free
    port on localhost) and return rank 0's summary.  In-process ``params``
    travel to the ranks as a ``convert.save_npz`` file."""
    import socket
    import subprocess
    import tempfile

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tmp = None
    argv = list(argv) + ["--device", "cpu"]
    if params is not None:
        from chainermn_tpu_torch.convert import save_npz
        tmp = tempfile.TemporaryDirectory(prefix="chainermn_tpu_serve_")
        path = os.path.join(tmp.name, "params.npz")
        save_npz(path, params)
        argv += ["--params", path]
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "chainermn_tpu_torch.serve", *argv],
                env=env, text=True,
                stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL))
        out = procs[0].communicate()[0]
        codes = [procs[0].returncode] + [p.wait() for p in procs[1:]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if tmp is not None:
            tmp.cleanup()
    if any(codes):
        raise SystemExit(f"--devices {n}: the ranks exited {codes}")
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None):
    summary = run(argv)
    if summary is not None:
        print(json.dumps(summary), flush=True)
    import torch.distributed as dist
    if dist.is_initialized():
        # a process group left to the interpreter's exit can abort it
        # (its threads are torn down unjoined)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
