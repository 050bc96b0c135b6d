"""Registered entry points for the trace engine.

Counterpart of ``chainermn_tpu/analysis/entrypoints.py``: the same 17
registrations under JAX's names, each built over the port.  Every builder
takes ``device`` (the card by default; the tests pass ``"cpu"``, which
runs the kernels' plain versions) and ``size``:

* ``"tiny"`` is JAX's fixture (one layer, two heads, a 16-token vocab, 8
  cache rows, axis size 1), so the whole sweep runs in seconds on one
  CPU — with heads of 64 where JAX's are 4 wide (d_model 128 for JAX's
  8): the port's attention kernels take head_dim 64 or 128, and the
  entries run on the card by default;
* ``"full"`` is the decode-bench LM width that ``chip_smoke.py``'s serving
  phase runs (vocab 32768, d_model 1024, 16 heads; depth cut to 2 layers,
  fp32), for the two kernel-bearing entries,
  ``parallel.decode.lm_decode_tick`` (the decode kernel with the tick's
  K/V append folded in, after a prefill through the flash forward and the
  append kernel) and ``serving.prefill_family`` (the flash forward and the
  append kernel).  The other entries are host or collective programs and
  build at ``"tiny"`` whatever ``size`` says.

Axis size 1 is enough, as in JAX: the port's collectives run and book at
world 1.  A builder joins a one-rank process group when none exists and
leaves it again in its ``teardown``; one that finds a group needs it to
have one rank.

Every build dict of a shard-flow entry keeps JAX's shard-flow keys
(``data_axis``, ``arg_labels``, ``expected_replication``, ``noted``) and
adds the bindings JAX reads off its ``shard_map`` equations: ``in_specs``,
one spec tree (or prefix) per ``arg_labels`` root, copied from JAX's
registrations, over ``shardflow_args`` where the trace arguments are not
the labelled leaves (the train steps take a module; their optimizer state
exists before the call, as JAX's ``optimizer.init(params)`` does).  The
shard-flow analyzer (``shardflow.py``) reads them.  Token ids are int32,
as JAX's are.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

from .trace_engine import EntryPoint

_SEED = 0  # analysis must run the same program every run

#: JAX names of the analysis package the port has not: none.
NOT_PORTED: Dict[str, str] = {}

#: the LM widths: JAX's tiny fixture, and the decode-bench LM (depth cut)
SIZES = {
    "tiny": dict(vocab=16, d_model=128, n_heads=2, n_layers=1, total=8,
                 batch=1, prompt=3, prompts=(2, 3)),
    "full": dict(vocab=32768, d_model=1024, n_heads=16, n_layers=2,
                 total=512, batch=8, prompt=128, prompts=(96, 128)),
}

_MEGATRON = ("Megatron TP layout: matmul weights shard over 'model', norm "
             "scales/biases/embedding remainders replicate by design")
_KV_ROWS = ("KV pool rows are whole per replica at the registered cache "
            "specs (TP>1 shards heads inside the flat K/V rows)")


def _sized(size: str) -> Dict[str, Any]:
    if size not in SIZES:
        raise ValueError(f"size must be one of {sorted(SIZES)}, got "
                         f"{size!r}")
    cfg = dict(SIZES[size])
    cfg["head_dim"] = cfg["d_model"] // cfg["n_heads"]
    return cfg


def _one_rank_group(device):
    """Join a one-rank process group for ``device`` when none exists;
    returns the teardown that leaves it (a no-op for a group found)."""
    import torch.distributed as dist

    from ..topology import init_distributed

    created = not dist.is_initialized()
    if created:
        init_distributed(device)
    if dist.get_world_size() != 1:
        if created:
            dist.destroy_process_group()
        raise RuntimeError(
            "the registered entry points run at world 1 (axis size 1, as "
            f"JAX's): this process group has {dist.get_world_size()} ranks")

    def teardown():
        if created and dist.is_initialized():
            dist.destroy_process_group()

    return teardown


def _mesh(name: str):
    """The one-rank N-D mesh binding axis ``name`` (JAX's
    ``make_nd_mesh((name,), (1,), devices[:1])``)."""
    from ..topology import make_nd_mesh

    return make_nd_mesh((name,), (1,))


def _bound(mesh, fn):
    """``fn`` run under ``with mesh:`` and inference mode."""
    def run(*a):
        import torch

        with torch.inference_mode(), mesh:
            return fn(*a)
    return run


def _tiny_lm(device, size: str = "tiny"):
    """Shared TP transformer-LM fixture at ``size``: ``(params, cfg)``,
    whole (TP = 1), fp32, from a seeded generator."""
    import torch

    from ..parallel.transformer import init_tp_transformer_lm

    cfg = _sized(size)
    params = init_tp_transformer_lm(
        torch.Generator().manual_seed(_SEED), cfg["vocab"], cfg["d_model"],
        cfg["n_heads"], cfg["n_layers"], max_len=cfg["total"],
        dtype=torch.float32, device=device)
    return params, cfg


def _tokens(cfg, shape, device, salt: int = 0):
    """Seeded int32 token ids of ``shape`` on ``device``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(_SEED + salt)
    return torch.as_tensor(rng.randint(0, cfg["vocab"], shape),
                           dtype=torch.int32, device=device)


def _P(*axes):
    """A spec leaf (``parallel._factory.PartitionSpec``, JAX's ``P``)."""
    from ..parallel._factory import P

    return P(*axes)


def _lm_specs(params):
    from ..parallel.transformer import transformer_lm_specs

    return transformer_lm_specs(params, "model")


#: JAX's CachePool binding of the pool buffers: K/V columns over 'model'
def _pool_spec():
    return _P(None, None, "model")


def _build_collective_ring(device="cuda", size="tiny") -> Dict[str, Any]:
    """The ops/collective.py vocabulary under one mesh binding — psum /
    reduce_scatter / all_gather / shift in the gradient-ring order the
    train CLI demos."""
    import torch

    from ..ops import collective as C

    teardown = _one_rank_group(device)
    mesh = _mesh("mn")

    def body(x):
        g = C.reduce_scatter(x, "mn")
        g = C.all_gather(g, "mn")
        g = C.shift(g, 1, "mn", size=1)
        return C.psum(g, "mn")

    x = torch.ones(4, device=device)
    return {"trace": (_bound(mesh, body), (x,)), "bound_axes": {"mn"},
            "teardown": teardown,
            # shard-flow: the ring's input is replicated by the P() feed
            # — deliberately NOT annotated (JAX's baseline keeper)
            "data_axis": "mn", "arg_labels": ("x",), "in_specs": (_P(),)}


def _prefilled(device, size):
    """``(params, cfg, mesh, teardown, caches)``: the LM prefilled with a
    seeded prompt of ``cfg["batch"]`` rows."""
    from ..parallel.decode import lm_prefill

    teardown = _one_rank_group(device)
    mesh = _mesh("model")
    params, cfg = _tiny_lm(device, size)
    prompt = _tokens(cfg, (cfg["batch"], cfg["prompt"]), device)
    _, caches = _bound(mesh, lambda p, pr: lm_prefill(
        p, pr, cfg["total"], head_dim=cfg["head_dim"],
        axis_name="model"))(params, prompt)
    return params, cfg, mesh, teardown, caches


def _build_decode_tick(device="cuda", size="tiny") -> Dict[str, Any]:
    """One serving decode tick (the pool-lifetime program): run for its
    collective sequence AND probed for recompilation — two calls with
    different token/pos VALUES must reuse ONE program.  The tick's MHA
    attention is the decode kernel with the K/V append folded in; the
    build's prefill runs the flash forward and the append kernel."""
    import torch

    from ..parallel.decode import lm_decode_tick

    params, cfg, mesh, teardown, caches = _prefilled(device, size)
    n = cfg["batch"]

    def tick(p, tokens, c, pos):
        return lm_decode_tick(p, tokens, c, pos, head_dim=cfg["head_dim"],
                              axis_name="model")

    run = _bound(mesh, tick)
    tokens = _tokens(cfg, (n,), device, salt=1)
    pos = torch.full((n,), cfg["prompt"], dtype=torch.int32, device=device)
    variants = (run, [
        (params, tokens, caches, pos),
        (params, (tokens + 1) % cfg["vocab"], caches, pos + 1),
    ])
    return {"trace": (run, (params, tokens, caches, pos)),
            "bound_axes": {"model"},
            "variants": variants,
            "teardown": teardown,
            "data_axis": "model",
            "arg_labels": ("params", "tokens", "caches", "pos"),
            "in_specs": _tick_specs(params, caches),
            "expected_replication": {"params": _MEGATRON,
                                     "caches": _KV_ROWS}}


def _tick_specs(params, caches):
    """JAX's tick binding: ``(specs, P(), cache_specs, P())``, the cache
    rows whole per replica."""
    return (_lm_specs(params), _P(), [(_P(), _P()) for _ in caches], _P())


def _build_prefill_family(device="cuda", size="tiny") -> Dict[str, Any]:
    """The per-prompt-length prefill programs: one program PER prompt
    length is the serving engine's documented design (its
    ``prefill_compiles`` counts them) — registered allow_recompile=True
    so the hazard is named, not flagged."""
    from ..parallel.decode import lm_prefill

    teardown = _one_rank_group(device)
    mesh = _mesh("model")
    params, cfg = _tiny_lm(device, size)

    def prefill(p, pr):
        return lm_prefill(p, pr, cfg["total"], head_dim=cfg["head_dim"],
                          axis_name="model")

    run = _bound(mesh, prefill)
    s2, s3 = cfg["prompts"]
    p2 = _tokens(cfg, (1, s2), device)
    p3 = _tokens(cfg, (1, s3), device, salt=1)
    return {"trace": (run, (params, p2)),
            "bound_axes": {"model"},
            "variants": (run, [(params, p2), (params, p3)]),
            "teardown": teardown,
            "data_axis": "model",
            "arg_labels": ("params", "prompt"),
            "in_specs": (_lm_specs(params), _P()),
            "expected_replication": {
                "params": _MEGATRON,
                "prompt": "every TP rank consumes the full prompt "
                          "(vocab-parallel embedding resolves its own "
                          "vocab range)",
            }}


class _traced_obs_state:
    """Context manager: tracer enabled + flight tee installed for the
    duration of ONE entry-point call, prior state restored after — an
    analysis run must not leave process-global observability state
    flipped on for whatever runs next."""

    def __enter__(self):
        from .. import observability as obs
        from ..observability import flight
        self._obs, self._flight = obs, flight
        self._was_enabled = obs.enabled()
        obs.enable()
        flight.install_tracer_tee()
        return self

    def __exit__(self, *exc):
        self._flight.uninstall_tracer_tee()
        if not self._was_enabled:
            self._obs.disable()
        return False


class _TracedVariantProbe:
    """Runs every call under the scoped tracer+tee state."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, *a):
        from .. import observability as obs
        from ..observability import flight
        with _traced_obs_state():
            with obs.span("serving/tick", cat="serving"):
                out = self._fn(*a)
            flight.note("phase", name="serving/step")
        return out


def _build_tick_with_tracing(device="cuda", size="tiny") -> Dict[str, Any]:
    """The serving tick with the TRACER ENABLED and the FLIGHT-RECORDER
    TEE installed must still be ONE program across value variants —
    observability is host-side bookkeeping and must never change what the
    kernels are asked to run."""
    base = _build_decode_tick(device, size)
    fn, args = base["trace"]
    probe = _TracedVariantProbe(fn)
    return {"trace": (probe, args),
            "bound_axes": base["bound_axes"],
            "variants": (probe, base["variants"][1]),
            "teardown": base["teardown"]}


class _RouterTeeProbe:
    """Variant probe for the ROUTER-driven tick: every call runs under
    the scoped tracer+tee state AND the router's per-request emissions
    (dispatch complete-event, per-slot decode-tick complete-events with
    trace ids) — the fleet observability surface the replica tick lives
    under in production."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, *a):
        from .. import observability as obs
        from ..observability import flight
        with _traced_obs_state():
            t0 = obs.now_us()
            obs.complete_event("router/dispatch", t0, 1,
                               cat="serving_request",
                               trace_id="req-analysis-rt00000000",
                               replica="replica0", prefix_match_len=0)
            with obs.span("serving/tick", cat="serving"):
                out = self._fn(*a)
            obs.complete_event("request/decode_tick", t0,
                               obs.now_us() - t0, cat="serving_request",
                               trace_id="req-analysis-rt00000000",
                               request=0, slot=0, active=1)
            flight.note("router", event="dispatched",
                        trace_id="req-analysis-rt00000000",
                        replica="replica0")
            flight.note("phase", name="serving/step")
        return out


def _build_router_tick(device="cuda", size="tiny") -> Dict[str, Any]:
    """The REPLICA decode tick as the serving router drives it: tracer
    enabled, flight tee installed, router dispatch + per-request
    decode-tick complete-events emitted around the device call.  The
    router hop must add zero device traffic and zero programs."""
    base = _build_decode_tick(device, size)
    fn, args = base["trace"]
    probe = _RouterTeeProbe(fn)
    return {"trace": (probe, args),
            "bound_axes": base["bound_axes"],
            "variants": (probe, base["variants"][1]),
            "teardown": base["teardown"],
            "data_axis": "model",
            "arg_labels": ("params", "tokens", "caches", "pos"),
            "in_specs": base["in_specs"],
            "expected_replication": {
                "params": _MEGATRON,
                "caches": _KV_ROWS,
                "pos": "per-slot position vector: 4 host-fed bytes "
                       "copied to every TP rank each tick — the same "
                       "replication the base decode-tick entry keeps "
                       "as a baseline keeper",
            }}


def _tiny_pool(device, n_slots: int = 2):
    """A CachePool at the tiny LM's shapes (one layer, its two KV heads,
    8 rows a slot), fp32."""
    import torch

    from ..serving.cache_pool import CachePool

    cfg = _sized("tiny")
    return CachePool(n_slots, cfg["total"], cfg["n_layers"],
                     cfg["d_model"], torch.float32, device)


def _build_prefix_copy(device="cuda", size="tiny") -> Dict[str, Any]:
    """The prefix cache's copy-on-extend (``DecodeEngine.copy_prefix``)
    over the REAL pool buffers at tiny shapes.  Contract: pure data
    movement — ZERO collectives and ONE program across (src, dst)
    slot-index variants (the indices are operands, never part of the
    program: a new program per pair would rebuild it on every hit)."""
    from ..serving.engine import DecodeEngine

    params, cfg = _tiny_lm(device)
    pool = _tiny_pool(device)
    eng = DecodeEngine(params, pool, head_dim=cfg["head_dim"])

    def run(src, dst):
        eng.copy_prefix(src, dst, 4)

    return {"trace": (run, (0, 1)),
            "bound_axes": {"model"},
            "variants": (run, [(0, 1), (1, 0)]),
            "data_axis": "model",
            "arg_labels": ("caches", "src", "dst"),
            # the REAL pool buffers thread in sharded, as JAX's do
            "shardflow_args": (pool.caches, 0, 1),
            "in_specs": (_pool_spec(), _P(), _P()),
            "expected_replication": {
                "src": "source slot index: one host-fed int32 scalar "
                       "per copy, replicated to every TP rank by "
                       "design",
                "dst": "destination slot index: same 4-byte host-fed "
                       "scalar as src",
            }}


def _build_kv_transfer(device="cuda", size="tiny") -> Dict[str, Any]:
    """The disaggregated fleet's same-process KV-slab transfer
    (``KvTransferPlane.local_program``) over two REAL pools — a prefill
    worker's staging pool and a decode worker's pool — at tiny shapes.
    Contract: one program serves every (src, dst) slot pair, and with both
    pools holding the KV columns alike the copy needs no collective."""
    from ..serving.transfer import KvTransferPlane

    staging = _tiny_pool(device, 2)
    decode = _tiny_pool(device, 3)
    plane = KvTransferPlane()
    prog = plane.local_program(staging, decode)

    def run(src_caches, dst_caches, src, dst):
        return prog(src_caches, dst_caches, src, dst)

    args0 = (staging.caches, decode.caches, 0, 1)
    return {"trace": (run, args0),
            "bound_axes": {"model"},
            "variants": (run, [
                args0,
                (staging.caches, decode.caches, 1, 2),
                (staging.caches, decode.caches, 0, 0),
            ]),
            "data_axis": "model",
            "arg_labels": ("src_caches", "dst_caches", "src", "dst"),
            "in_specs": (_pool_spec(), _pool_spec(), _P(), _P()),
            "expected_replication": {
                "src": "source staging-slot index: one host-fed int32 "
                       "scalar per transfer, replicated to every TP "
                       "rank by design",
                "dst": "destination (reserved) slot index: same 4-byte "
                       "host-fed scalar as src",
            }}


def _build_reshard(device="cuda", size="tiny") -> Dict[str, Any]:
    """The portable redistribution primitive (``parallel/reshard.py``):
    BOTH wire-bearing (src, dst) spec pairs — S(0)→R (one all_gather) and
    S(0)→S(1) (one all_to_all) — in ONE program.  Spec pairs are static
    by construction, so value variants must reuse the single program."""
    import numpy as np
    import torch

    from ..parallel.reshard import reshard

    teardown = _one_rank_group(device)
    mesh = _mesh("mn")

    def body(t):
        gathered = reshard(t, 0, None, "mn")       # S(0) -> R
        transposed = reshard(t, 0, 1, "mn")        # S(0) -> S(1)
        return gathered, transposed

    run = _bound(mesh, body)
    x = torch.as_tensor(np.arange(32, dtype=np.float32).reshape(4, 8),
                        device=device)
    return {"trace": (run, (x,)),
            "bound_axes": {"mn"},
            "variants": (run, [(x,), (x + 1,)]),
            "teardown": teardown,
            # the input rides in SHARDED (that is the primitive's whole
            # point) — the replication report must stay empty here
            "data_axis": "mn", "arg_labels": ("tree",),
            "in_specs": (_P("mn", None),)}


def _build_flight_ring_program(device="cuda", size="tiny"
                               ) -> Dict[str, Any]:
    """Flight-recorder entry point: the accounted collective ring run
    UNDER the ring tee (comm deltas -> flight events).  The accountant's
    flight tee fires on the host only, so the collective sequence is the
    same with the recorder on."""
    from ..observability import flight

    base = _build_collective_ring(device, size)
    fn, args = base["trace"]

    def run_teed(*a):
        with _traced_obs_state():
            out = fn(*a)
            flight.note("phase", name="collective/ring")
        return out

    return {"trace": (run_teed, args), "bound_axes": base["bound_axes"],
            "teardown": base["teardown"]}


def _tiny_mlp_fixture():
    """Shared tiny-MLP (params, batch) for the train-step entry points —
    deterministic numpy (analysis must run the same program every run)."""
    import numpy as np

    rng = np.random.RandomState(_SEED)
    params = {
        "w1": rng.randn(8, 16).astype(np.float32) / 4,
        "b1": np.zeros((16,), np.float32),
        "w2": rng.randn(16, 4).astype(np.float32) / 4,
        "b2": np.zeros((4,), np.float32),
    }
    batch = (rng.randn(4, 8).astype(np.float32),
             rng.randint(0, 4, (4,)).astype(np.int32))
    return params, batch


def _tiny_mlp(device):
    """``(module, batch)``: the tiny MLP as a module on ``device``."""
    import torch

    params, batch = _tiny_mlp_fixture()

    class TinyMLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in params.items():
                setattr(self, k, torch.nn.Parameter(
                    torch.as_tensor(v, device=device)))

        def forward(self, x):
            h = torch.tanh(x @ self.w1 + self.b1)
            return h @ self.w2 + self.b2

    tb = tuple(torch.as_tensor(a, device=device) for a in batch)
    return TinyMLP(), tb


def _init_optimizer_state(optimizer):
    """Create the state ``optimizer`` (Adam, or SGD with momentum) makes
    at its first step, now: JAX's ``optimizer.init(params)``.  The
    tensors are torch's own first ones (Adam: a step count and two zero
    moments; SGD: a zero momentum buffer, which the first step fills with
    the gradient as a missing one would be), so the updates are
    unchanged."""
    import torch

    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            if isinstance(optimizer, torch.optim.Adam):
                state["step"] = torch.tensor(0.0, dtype=torch.float32)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            elif group.get("momentum", 0):
                state["momentum_buffer"] = torch.zeros_like(p)


def _module_params(module):
    """The tiny MLP's parameters by JAX's names (``w1, b1, w2, b2``)."""
    return {k: getattr(module, k) for k, _ in module.named_parameters()}


def _state_tree(optimizer, params):
    """``{param name: {state name: tensor}}``: the state
    ``hybrid.state_specs_like`` names."""
    return {k: dict(optimizer.state[p]) for k, p in params.items()}


def _state_specs(optimizer, params):
    from ..parallel.hybrid import state_specs_like

    return state_specs_like(optimizer, params, {k: _P() for k in params})


class _QuantOptState(NamedTuple):
    """The quantized step's optimizer state under JAX's root names: the
    inner optimizer's, the double buffer's stale mean gradients and this
    rank's error-feedback residual row."""

    inner: Any
    stale_grads: Any
    ef: Any


def _mlp_loss(m, b):
    import torch

    x, y = b
    return torch.nn.functional.cross_entropy(m(x), y.long())


def _build_train_step(device="cuda", size="tiny") -> Dict[str, Any]:
    """The PRODUCTION train-step builder (``make_train_step`` + adam) —
    the program whose replication report names the full optimizer-state
    replication ZeRO-1 removes.  Its gradient mean is the one JAX's
    autodiff inserts, booked by the port's step as a ``noted``
    ``grad_allreduce_ad`` row (the port's step means the gradient itself:
    a plain ``torch.optim`` optimizer stands where JAX's multi-node
    wrapper does)."""
    import numpy as np
    import torch

    from ..topology import make_mesh
    from ..train import make_train_step

    teardown = _one_rank_group(device)
    module, batch = _tiny_mlp(device)
    optimizer = torch.optim.Adam(module.parameters(), 1e-3)
    _init_optimizer_state(optimizer)
    step = make_train_step(_mlp_loss, optimizer, mesh=make_mesh("mn"))
    params, _ = _tiny_mlp_fixture()
    params_bytes = int(sum(np.prod(v.shape) * v.dtype.itemsize
                           for v in params.values()))
    tparams = _module_params(module)
    return {"trace": (step, (module, batch)),
            "bound_axes": {"mn"},
            "teardown": teardown,
            "data_axis": "mn",
            "arg_labels": ("params", "opt_state", "batch"),
            "shardflow_args": (tparams, _state_tree(optimizer, tparams),
                               batch),
            "in_specs": (_P(), _state_specs(optimizer, tparams), _P("mn")),
            "expected_replication": {
                "params": "data parallelism replicates parameters on "
                          "every replica by definition",
                "opt_state": "FULL optimizer-state replication — the "
                             "exact blowup ZeRO-1 weight-update sharding "
                             "removes; delete this annotation when it "
                             "lands",
            },
            "noted": {"grad_allreduce_ad@mn": params_bytes}}


def _build_quantized_train_step(device="cuda", size="tiny"
                                ) -> Dict[str, Any]:
    """The QUANTIZED train step: ``make_train_step`` +
    ``create_multi_node_optimizer(allreduce_grad_dtype='int8',
    error_feedback=True, double_buffering=True)`` — the combined
    quantized+double-buffered mode on the tiny MLP at world 1, where the
    ring short-circuits and the entry pins the one-program discipline
    across value variants."""
    import torch

    from ..optimizers import create_multi_node_optimizer
    from ..topology import make_mesh
    from ..train import make_train_step

    teardown = _one_rank_group(device)
    mesh = make_mesh("mn")
    module, batch = _tiny_mlp(device)
    inner = torch.optim.SGD(module.parameters(), 1e-2, momentum=0.9)
    _init_optimizer_state(inner)
    optimizer = create_multi_node_optimizer(
        inner, mesh, allreduce_grad_dtype="int8", error_feedback=True,
        double_buffering=True, quant_block=8, quant_pipeline=2, world=1)
    step = make_train_step(_mlp_loss, optimizer, mesh,
                           allreduce_grad_dtype="int8", error_feedback=True)
    shifted = tuple(b + 0.01 if b.is_floating_point() else b
                    for b in batch)
    tparams = _module_params(module)
    opt_state = _QuantOptState(_state_tree(inner, tparams),
                               optimizer.state.stale_grads,
                               optimizer.state.ef.residuals)
    # the EF residual rows shard over the data axis (one row a rank)
    opt_specs = _QuantOptState(_state_specs(inner, tparams), _P(),
                               _P("mn", None))
    return {"trace": (step, (module, batch)),
            "bound_axes": {"mn"},
            "variants": (step, [(module, batch), (module, shifted)]),
            "teardown": teardown,
            "data_axis": "mn",
            "arg_labels": ("params", "opt_state", "batch"),
            "shardflow_args": (tparams, opt_state, batch),
            "in_specs": (_P(), opt_specs, _P("mn")),
            "expected_replication": {
                "opt_state.inner": "inner momentum replicates per replica "
                                   "— the ZeRO-1 debt, tracked on "
                                   "train.step",
                "opt_state.stale_grads": "the double-buffer's 1-step-"
                                         "stale mean gradients are "
                                         "globally identical by "
                                         "construction",
            }}


def _build_demo_train_step(device="cuda", size="tiny") -> Dict[str, Any]:
    """The train CLI's demo step (``make_demo_step``): local grads + the
    EXPLICIT accounted ring mean + accounted metric psums — no declared
    collective at all."""
    import torch

    from ..topology import make_mesh
    from ..train import make_demo_step

    teardown = _one_rank_group(device)
    params, batch = _tiny_mlp_fixture()
    tparams = {k: torch.as_tensor(v, device=device).requires_grad_()
               for k, v in params.items()}
    optimizer = torch.optim.SGD(tparams.values(), 1e-2, momentum=0.9)
    _init_optimizer_state(optimizer)
    step = make_demo_step(mesh=make_mesh("mn"))
    tb = tuple(torch.as_tensor(a, device=device) for a in batch)

    def run(s, b):
        return step(s, b)

    return {"trace": (run, ((tparams, optimizer), tb)),
            "bound_axes": {"mn"},
            "teardown": teardown,
            "data_axis": "mn",
            "arg_labels": ("state", "batch"),
            "shardflow_args": ((tparams, _state_tree(optimizer, tparams)),
                               tb),
            "in_specs": (_P(), _P("mn")),
            "expected_replication": {
                "state": "the demo step replicates (params, momentum) "
                         "per replica — same ZeRO-1 debt as train.step, "
                         "tracked there per-argument",
            }}


class _SupervisedTickProbe:
    """Variant probe for the SUPERVISED tick: every call runs under the
    scoped tracer+tee state AND one full supervision-plane round —
    heartbeat lease publish, supervisor-side lease read + epoch-fence
    admission, circuit-breaker consult — the host path a fleet worker's
    device call lives under.  The health plane must add ZERO device
    traffic and ZERO programs."""

    def __init__(self, fn, plane):
        self._fn = fn
        self._plane = plane   # (publisher, table, fence, breaker)

    def __call__(self, *a):
        from .. import observability as obs
        from ..observability import flight
        pub, table, fence, breaker = self._plane
        with _traced_obs_state():
            pub.beat(queue_depth=0, free_slots=1, busy_slots=1)
            with obs.span("serving/tick", cat="serving"):
                out = self._fn(*a)
            lease = table.read("analysis-worker")
            fence.admit("analysis-worker", lease["epoch"], "lease")
            breaker.allow()
            flight.note("fleet", event="supervisor_tick",
                        worker="analysis-worker",
                        lease_seq=lease["seq"])
            flight.note("phase", name="fleet/supervise")
        return out


def _build_supervisor_tick(device="cuda", size="tiny") -> Dict[str, Any]:
    """The serving decode tick as a SUPERVISED fleet worker runs it:
    heartbeat publish on the loopback lane store, lease read +
    epoch-fence admission + breaker consult on the supervisor side,
    tracer + flight tee installed — all host-side bookkeeping.  One
    program across value variants."""
    from ..health import HeartbeatPublisher, LeaseTable
    from ..serving.health import CircuitBreaker, EpochFence
    from ..serving.transfer import InProcessLaneStore

    base = _build_decode_tick(device, size)
    fn, args = base["trace"]
    store = InProcessLaneStore()
    fence = EpochFence()
    epoch = fence.new_epoch("analysis-worker")
    plane = (HeartbeatPublisher(store, "analysis-worker", "engine", epoch),
             LeaseTable(store), fence, CircuitBreaker())
    probe = _SupervisedTickProbe(fn, plane)
    return {"trace": (probe, args),
            "bound_axes": base["bound_axes"],
            "variants": (probe, base["variants"][1]),
            "teardown": base["teardown"]}


class _AutoscaleTickProbe:
    """Variant probe for the AUTOSCALED tick: every call runs one full
    control-loop round around the decode tick — degradation-ladder update
    on an overload pressure signal, tenant budget check + admission
    bookkeeping, and an :class:`~chainermn_tpu_torch.serving.autoscale.AutoscalePolicy`
    decision over a synthetic oscillating signal trace (fake receiver
    clock, so the probe is deterministic).  Pure host bookkeeping: ZERO
    device traffic and ZERO programs."""

    def __init__(self, fn, policy, table):
        self._fn = fn
        self._policy = policy
        self._table = table
        self._calls = 0

    def __call__(self, *a):
        from ..observability import flight
        from ..serving.scheduler import Request

        self._calls += 1
        now = float(self._calls)          # fake receiver clock
        # oscillating synthetic load: hysteresis must absorb it
        backlog = 512 if self._calls % 2 else 0
        self._table.ladder.update(0.5 if backlog else 0.0, now=now)
        tenant = self._table.resolve("analysis-tenant", "best_effort")
        refused = self._table.admission_check(tenant, now=now)
        if refused is None:
            self._table.on_admit(tenant, Request([1], 1), capped=False)
        out = self._fn(*a)
        dec = self._policy.decide(
            {"live_workers": 1, "backlog_tokens": backlog,
             "queue_depth": 4 if backlog else 0, "shed_rate": 0.0},
            now)
        if dec is not None:
            flight.note("autoscale_decision",
                        **{k: v for k, v in dec.items() if k != "event"})
        flight.note("phase", name="fleet/autoscale_tick")
        return out


def _build_autoscale_tick(device="cuda", size="tiny") -> Dict[str, Any]:
    """The serving decode tick as the AUTOSCALED fleet runs it: ladder
    update + tenant budget bookkeeping + one policy decision per call,
    all host-side.  One program across value variants."""
    from ..serving.autoscale import AutoscalePolicy
    from ..serving.tenancy import TenantTable

    base = _build_decode_tick(device, size)
    fn, args = base["trace"]
    policy = AutoscalePolicy(min_workers=1, max_workers=2,
                             up_cooldown_s=3.0, down_cooldown_s=6.0,
                             down_stable_s=6.0)
    probe = _AutoscaleTickProbe(fn, policy, TenantTable())
    return {"trace": (probe, args),
            "bound_axes": base["bound_axes"],
            "variants": (probe, base["variants"][1]),
            "teardown": base["teardown"]}


def _tiny_slab(dtype_np="float32"):
    """One layer's seeded host K/V rows ``(rows, kv_dim)`` each, at the
    tiny pool's shapes."""
    import numpy as np

    cfg = _sized("tiny")
    rng = np.random.RandomState(_SEED)
    shape = (cfg["total"], cfg["d_model"])
    return [(rng.randn(*shape).astype(dtype_np),
             rng.randn(*shape).astype(dtype_np))]


class _WorkerLaneProbe:
    """Variant probe for the lane LANDING program: every call runs one
    worker-lane mailbox round trip (pickled control message out, consumed
    in order on the receiver side) around the slab write — the
    cross-process protocol's host path.  The mailbox hop must add zero
    device traffic and zero programs."""

    def __init__(self, fn, sender, receiver):
        self._fn = fn
        self._sender = sender
        self._receiver = receiver

    def __call__(self, *a):
        from ..observability import flight
        with _traced_obs_state():
            self._sender.send({"kind": "install", "epoch": 1,
                               "trace_id": "req-analysis-wl00000000",
                               "tag": "slab/req-analysis-wl00000000"})
            msg = self._receiver.recv()
            out = self._fn(*a)
            flight.note("worker", event="installed",
                        worker="analysis-decode0",
                        trace_id=msg["trace_id"])
            flight.note("phase", name="worker/step")
        return out


def _build_worker_lane(device="cuda", size="tiny") -> Dict[str, Any]:
    """The worker lane protocol's device half: the pool-lifetime slab
    INJECT program (:meth:`KvTransferPlane.inject_program`) that lands
    every cross-process transfer, run under one mailbox round trip per
    call.  Contract: pure data movement — ZERO collectives and ONE
    program across (slab values, dst slot) variants."""
    import torch

    from ..serving.lanes import MailboxReceiver, MailboxSender
    from ..serving.transfer import InProcessLaneStore, KvTransferPlane

    pool = _tiny_pool(device)
    prog = KvTransferPlane().inject_program(pool)
    store = InProcessLaneStore()
    probe = _WorkerLaneProbe(
        prog, MailboxSender(store, "ctl.analysis-decode0"),
        MailboxReceiver(store, "ctl.analysis-decode0"))
    slab = _tiny_slab()
    args0 = (pool.caches, slab, 0, torch.float32)
    return {"trace": (probe, args0),
            "bound_axes": {"model"},
            "variants": (probe, [args0,
                                 (pool.caches, slab, 1, torch.float32)]),
            "data_axis": "model",
            "arg_labels": ("dst_caches", "slabs", "dst"),
            # the caches and the slab's columns thread in sharded
            "shardflow_args": (pool.caches, slab, 0),
            "in_specs": (_pool_spec(), _P(None, "model"), _P()),
            "expected_replication": {
                "dst": "destination (reserved) slot index: one host-fed "
                       "int32 scalar per landing, replicated to every "
                       "TP rank by design",
            }}


class _KvSpillProbe:
    """Variant probe for the host-RAM spill tier: every call runs one
    full spill round trip around the inject program — pack the source
    slot (CRC stamped), put/get through the bounded host store,
    CRC-verified ``unpack_into`` restore into the restore slot — and
    asserts the restore is BYTE-EXACT vs the packed rows with its ledger
    booking equal to the ``transfer_cost`` statics."""

    def __init__(self, fn, pool, plane, spill, length):
        self._fn = fn
        self._pool = pool
        self._plane = plane
        self._spill = spill
        self._length = int(length)

    def __call__(self, *a):
        import pickle

        import numpy as np

        from ..observability import flight
        from ..serving.transfer import SPILL_AXIS, SPILL_OP, transfer_cost
        pool, L = self._pool, self._length
        seq = tuple(range(L))
        with _traced_obs_state():
            payload = self._plane.pack(pool, 0, L,
                                       meta={"seq": list(seq), "length": L})
            assert self._spill.put(seq, L, payload)
            got = self._spill.get(seq)
            stats = self._plane.unpack_into(
                got, pool, 1, ledger_op=SPILL_OP, ledger_axis=SPILL_AXIS)
            want = transfer_cost(pool.n_layers, L, pool.kv_dim,
                                 pool.caches[0][0].dtype, mode="lanes")
            assert stats["ledger_bytes"] == want["ledger_bytes"], (
                stats, want)
            # byte-exact round trip: the restored rows ARE the packed rows
            rows = pickle.loads(payload)["rows"]
            for (ks, vs), (kc, vc) in zip(rows, pool.caches):
                np.testing.assert_array_equal(ks, kc[1, :L].cpu().numpy())
                np.testing.assert_array_equal(vs, vc[1, :L].cpu().numpy())
            out = self._fn(*a)
            flight.note("serving", event="restore", prefix_len=L)
            flight.note("phase", name="serving/spill_restore")
        return out


def _build_kv_spill(device="cuda", size="tiny") -> Dict[str, Any]:
    """The host-RAM spill tier's device half: the SAME pool-lifetime
    inject program every lane transfer lands through, driven by the spill
    round trip (pack → bounded host LRU store → CRC verify → restore).
    Contract: one program across (slab, dst slot) variants, byte-exact
    restores, ledger-reconciled against ``transfer_cost`` statics — all
    asserted in-probe on every call."""
    import numpy as np
    import torch

    from ..serving.spill import HostSpillStore
    from ..serving.transfer import KvTransferPlane

    pool = _tiny_pool(device)
    # give slot 0 real (random) K/V so the byte-exact check is honest
    rng = np.random.RandomState(_SEED)
    with torch.inference_mode():
        for kc, vc in pool.caches:
            kc.copy_(torch.as_tensor(rng.randn(*kc.shape).astype(
                np.float32), device=kc.device))
            vc.copy_(torch.as_tensor(rng.randn(*vc.shape).astype(
                np.float32), device=vc.device))
    plane = KvTransferPlane()
    prog = plane.inject_program(pool)
    probe = _KvSpillProbe(prog, pool, plane,
                          HostSpillStore(capacity_bytes=1 << 20), length=6)
    slab = _tiny_slab()
    args0 = (pool.caches, slab, 0, torch.float32)
    return {"trace": (probe, args0),
            "bound_axes": {"model"},
            "variants": (probe, [args0,
                                 (pool.caches, slab, 1, torch.float32)]),
            "data_axis": "model",
            "arg_labels": ("dst_caches", "slabs", "dst"),
            "expected_replication": {
                "dst": "restore-slot index: one host-fed int32 scalar "
                       "per restore, replicated to every TP rank by "
                       "design",
            }}


class _RemotePullProbe:
    """Variant probe for the fleet remote-pull path: every call runs the
    full cross-worker host protocol around the inject program — owner
    pack (CRC stamped) → object lane put/get → RESERVED destination slot
    → CRC-verified ``unpack_into`` → reservation commit → recycle — and
    asserts the lane booking equals the ``transfer_cost(mode="lanes")``
    statics the router prices the pull decision with."""

    def __init__(self, fn, src_pool, dst_pool, plane, length):
        self._fn = fn
        self._src = src_pool
        self._dst = dst_pool
        self._plane = plane
        self._length = int(length)
        self._calls = 0

    def __call__(self, *a):
        from ..observability import flight
        from ..serving.transfer import transfer_cost
        self._calls += 1
        L = self._length
        tag = f"pfx/req-analysis-pull{self._calls:08d}"
        with _traced_obs_state():
            payload = self._plane.pack(
                self._src, 0, L, meta={"seq": list(range(L)), "length": L})
            self._plane.lane_put(tag, payload)
            slot = self._dst.reserve()
            assert slot is not None
            got = self._plane.lane_get(tag, 5.0)
            stats = self._plane.unpack_into(got, self._dst, slot)
            want = transfer_cost(self._dst.n_layers, L, self._dst.kv_dim,
                                 self._dst.caches[0][0].dtype, mode="lanes")
            assert stats["ledger_bytes"] == want["ledger_bytes"], (
                stats, want)
            self._dst.commit_reservation(slot)
            self._dst.release(slot)      # recycle for the next call
            self._plane.lane_delete(tag)
            out = self._fn(*a)
            flight.note("fleet", event="remote_pull_done", prefix_len=L)
            flight.note("phase", name="fleet/remote_pull")
        return out


def _build_remote_pull(device="cuda", size="tiny") -> Dict[str, Any]:
    """The fleet-global KV economy's remote prefix pull: owner-side pack
    → object lane → CRC-verified landing into a router-reserved slot
    through the pool-lifetime inject program.  Contract: one program
    across (slab, slot) variants, the reservation state machine exercised
    on every call, lane bytes ledger-reconciled against the same
    ``transfer_cost`` statics the router prices with."""
    import torch

    from ..serving.transfer import InProcessLaneStore, KvTransferPlane

    owner = _tiny_pool(device)
    dst = _tiny_pool(device)
    plane = KvTransferPlane(transport=InProcessLaneStore())
    prog = plane.inject_program(dst)
    probe = _RemotePullProbe(prog, owner, dst, plane, length=5)
    slab = _tiny_slab()
    args0 = (dst.caches, slab, 0, torch.float32)
    return {"trace": (probe, args0),
            "bound_axes": {"model"},
            "variants": (probe, [args0,
                                 (dst.caches, slab, 1, torch.float32)]),
            "data_axis": "model",
            "arg_labels": ("dst_caches", "slabs", "dst_slot"),
            "expected_replication": {
                "dst_slot": "reserved destination-slot index: one "
                            "host-fed int32 scalar per landing, "
                            "replicated to every TP rank by design",
            }}


def select_entrypoints(names=None, for_shardflow: bool = False):
    """Resolve ``--entry`` names against the registry.

    Returns ``(entrypoints, error)``.  ``names=None`` selects everything
    (minus ``shardflow=False`` entries when ``for_shardflow``).  An
    unknown name is an error, and so is EXPLICITLY naming a
    ``shardflow=False`` entry under ``for_shardflow`` — silently
    analyzing 0 entry points would read as a clean verdict.
    """
    if not names:
        eps = list(ENTRYPOINTS)
        if for_shardflow:
            eps = [ep for ep in eps if getattr(ep, "shardflow", True)]
        return eps, None
    by_name = {ep.name: ep for ep in ENTRYPOINTS}
    unknown = [n for n in names if n not in by_name]
    if unknown:
        return None, (f"unknown entry point(s): {', '.join(unknown)} "
                      f"(known: {', '.join(sorted(by_name))})")
    eps = [by_name[n] for n in names]
    if for_shardflow:
        skipped = [ep.name for ep in eps
                   if not getattr(ep, "shardflow", True)]
        if skipped:
            return None, (
                f"entry point(s) registered shardflow=False — the base "
                f"entry owns their program's shard-flow analysis: "
                f"{', '.join(skipped)}")
    return eps, None


ENTRYPOINTS = [
    EntryPoint(
        name="ops.collective.ring",
        build=_build_collective_ring,
        description="reduce_scatter+all_gather+shift+psum gradient ring "
                    "over axis 'mn' (the train CLI's demo reduction)"),
    EntryPoint(
        name="train.step",
        build=_build_train_step,
        description="make_train_step + adam on a tiny MLP — the "
                    "production DP step; replication report names the "
                    "optimizer-state blowup ZeRO-1 removes"),
    EntryPoint(
        name="train.quantized_step",
        build=_build_quantized_train_step,
        description="make_train_step + MultiNodeOptimizer(int8 wire, "
                    "error feedback, double buffering) — the combined "
                    "quantized+double-buffered step: one program across "
                    "value variants"),
    EntryPoint(
        name="train.demo_step",
        build=_build_demo_train_step,
        description="the train CLI's demo step: explicit accounted ring "
                    "mean, no declared collective"),
    EntryPoint(
        name="parallel.reshard",
        build=_build_reshard,
        description="portable redistribution primitive: S(0)->R "
                    "(all_gather) + S(0)->S(1) (all_to_all) in one "
                    "program"),
    EntryPoint(
        name="parallel.decode.lm_decode_tick",
        build=_build_decode_tick,
        description="serving decode tick over the 'model' axis — one "
                    "program for the pool's lifetime (the decode kernel "
                    "with the K/V append folded in)"),
    EntryPoint(
        name="serving.prefill_family",
        build=_build_prefill_family,
        allow_recompile=True,
        description="per-prompt-length prefill programs (intentional "
                    "program family, see docs/SERVING.md; the flash "
                    "forward and the append kernel)"),
    EntryPoint(
        name="serving.router_tick",
        build=_build_router_tick,
        description="replica decode tick under the ROUTER tee: tracer "
                    "+ flight tee + router dispatch/per-request "
                    "emissions — one program, zero extra device "
                    "traffic"),
    EntryPoint(
        name="serving.prefix_copy",
        build=_build_prefix_copy,
        description="prefix-cache copy-on-extend slab copy "
                    "(DecodeEngine.copy_prefix): zero collectives, one "
                    "program across (src, dst) slot variants"),
    EntryPoint(
        name="serving.kv_transfer",
        build=_build_kv_transfer,
        description="disaggregated KV-slab transfer "
                    "(KvTransferPlane.local_program): one program across "
                    "(src, dst) slot variants, zero collectives"),
    EntryPoint(
        name="serving.supervisor_tick",
        build=_build_supervisor_tick,
        shardflow=False,  # same program as the decode tick
        description="serving decode tick under the fleet supervision "
                    "plane: heartbeat lease publish + supervisor lease "
                    "read + epoch-fence admission + breaker consult — "
                    "one program, zero extra device traffic"),
    EntryPoint(
        name="serving.autoscale_tick",
        build=_build_autoscale_tick,
        shardflow=False,  # same program as the decode tick
        description="serving decode tick under the autoscale control "
                    "loop: degradation-ladder update + tenant budget "
                    "bookkeeping + one AutoscalePolicy decision per "
                    "call — one program, zero extra device traffic"),
    EntryPoint(
        name="serving.worker_lane",
        build=_build_worker_lane,
        description="cross-process worker lane landing program "
                    "(KvTransferPlane.inject_program) under a mailbox "
                    "round trip per call: zero collectives, one program "
                    "across (slab, dst slot) variants"),
    EntryPoint(
        name="serving.kv_spill",
        build=_build_kv_spill,
        shardflow=False,  # same inject program as serving.worker_lane
        description="host-RAM spill tier round trip (pack -> bounded "
                    "LRU store -> CRC verify -> restore): one program "
                    "across (slab, slot) variants, byte-exact restores "
                    "ledger-reconciled against transfer_cost statics"),
    EntryPoint(
        name="serving.remote_pull",
        build=_build_remote_pull,
        shardflow=False,  # same inject program as serving.worker_lane
        description="fleet remote prefix pull (owner pack -> object "
                    "lane -> reserved-slot CRC-verified landing): one "
                    "program, reservation state machine exercised per "
                    "call, lane bytes reconciled against the pricing "
                    "statics"),
    EntryPoint(
        name="serving.tick_with_tracing",
        build=_build_tick_with_tracing,
        shardflow=False,  # same program as the decode tick
        description="serving decode tick with the tracer enabled and "
                    "the flight-recorder tee installed — observability "
                    "must stay host-side: one program"),
    EntryPoint(
        name="observability.flight_ring",
        build=_build_flight_ring_program,
        shardflow=False,  # same program as ops.collective.ring
        description="accounted collective ring under the flight-"
                    "recorder comm tee — the ring records on the host "
                    "only, leaving the collective sequence unchanged"),
]
