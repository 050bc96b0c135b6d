"""One rank of the port's tensor parallelism, for tests/test_torch_tp*.py.

Run as ``python tests/_torch_tp_worker.py SUITE RANK WORLD STORE_FILE
OUT_DIR``.  Joins a gloo group through a ``FileStore`` (no port), reads
``OUT_DIR/inputs.pkl`` (the test's numpy inputs: JAX's global params and
tokens) where the suite needs it, runs every case of ``SUITE`` and pickles
what this rank got to ``OUT_DIR/rank<r>.pkl``:

* ``layers``: each case of :data:`LAYER_CASES` through the port's global
  face on a ``('model',)`` mesh of the world (output and the gradient of
  ``sum(out · R)`` for every float input), and the groups of
  ``make_nd_mesh`` / ``make_multislice_mesh``;
* ``lm``: on the ``(world/2, 2)`` ``('data', 'model')`` mesh, each case of
  :data:`LM_CASES`: this rank's gradients after the data mean, then five
  Adam steps of ``make_hybrid_train_step`` (losses, parameters gathered by
  ``gather_to_numpy``); and ``tp_block_sp`` through the global face;
* ``decode``: on a ``('model',)`` mesh of the world, the greedy, sampled
  and beam-4 generators, ``ServingEngine(mesh=...)`` on the staggered
  schedule of :func:`serve_schedule`, and a leader that raises
  (:func:`leader_raises`);
* ``cli``: ``train_transformer``, ``train_hybrid``, ``generate`` and
  ``serve`` with ``--tp 2``, each from JAX's initial params;
* ``prefix``: on a ``('model',)`` mesh of the world,
  ``ServingEngine(mesh=...)`` with the prefix cache and the spill tier on
  through :func:`prefix_schedule` (prefix hits, a spill, a restore),
  then again with the last rank's own spilled payloads corrupted (its CRC
  refusal must reach every rank, and the request re-prefills).

Imports no JAX.
"""

import contextlib
import io
import pickle
import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.convert import flatten
from chainermn_tpu_torch.ops import collective as col
from chainermn_tpu_torch.parallel import collective_matmul as cm
from chainermn_tpu_torch.parallel import tensor_parallel as tp
from chainermn_tpu_torch.parallel import transformer as tr
from chainermn_tpu_torch.parallel._factory import P, make_global_apply
from chainermn_tpu_torch.topology import (init_distributed,
                                          make_multislice_mesh, make_nd_mesh)

AX = "model"
MLP = {"wi": (None, AX), "bi": (AX,), "wo": (AX, None), "bo": ()}

# name -> (module attr, kwargs, [(arg shape, in spec)], out spec); a spec
# is a tuple of axis names (a dict of them for a params tree); an int
# arg's shape is marked ("int", high, shape).  The JAX twin calls the same
# name in chainermn_tpu.parallel with the same kwargs.
LAYER_CASES = {
    "tp_mlp": ("tensor_parallel.tp_mlp", {},
               [((4, 16), ()), ({"wi": (16, 32), "bi": (32,),
                                 "wo": (32, 16), "bo": (16,)}, MLP)], ()),
    "column_gather": ("tensor_parallel.column_parallel_dense",
                      {"gather_output": True},
                      [((3, 16), ()), ((16, 8), (None, AX)), ((8,), (AX,))],
                      ()),
    "row_replicated": ("tensor_parallel.row_parallel_dense",
                       {"input_is_parallel": False},
                       [((3, 16), ()), ((16, 8), (AX, None)), ((8,), ())],
                       ()),
    "embedding": ("tensor_parallel.vocab_parallel_embedding", {},
                  [(("int", 16, (3, 5)), ()), ((16, 8), (AX, None))], ()),
    "all_gather_matmul": ("collective_matmul.all_gather_matmul", {},
                          [((8, 6), (AX,)), ((6, 8), (None, AX))],
                          (None, AX)),
    "matmul_reduce_scatter": ("collective_matmul.matmul_reduce_scatter", {},
                              [((8, 8), (None, AX)), ((8, 6), (AX, None))],
                              (AX,)),
    "gather_seq_matmul": ("tensor_parallel.gather_seq_matmul", {},
                          [((2, 8, 6), (None, AX)), ((6, 8), (None, AX)),
                           ((8,), (AX,))], (None, None, AX)),
    "matmul_scatter_seq": ("tensor_parallel.matmul_scatter_seq", {},
                           [((2, 8, 8), (None, None, AX)),
                            ((8, 6), (AX, None)), ((6,), ())], (None, AX)),
    "tp_mlp_sp": ("tensor_parallel.tp_mlp_sp", {},
                  [((2, 8, 16), (None, AX)),
                   ({"wi": (16, 32), "bi": (32,), "wo": (32, 16),
                     "bo": (16,)}, MLP)], (None, AX)),
}


def _tree(shape, fn):
    if isinstance(shape, dict):
        return {k: _tree(v, fn) for k, v in shape.items()}
    return fn(shape)


def layer_inputs(name):
    """The case's global numpy inputs, from a seed."""
    rng = np.random.RandomState(sorted(LAYER_CASES).index(name))

    def one(shape):
        if shape[0] == "int":
            return rng.randint(0, shape[1], shape[2]).astype(np.int32)
        return rng.randn(*shape).astype(np.float32)

    return [_tree(shape, one) for shape, _ in LAYER_CASES[name][2]]


def layer_out_weights(name, out_shape):
    """The cotangent weights ``R`` of the case's output, from a seed."""
    return np.random.RandomState(100 + sorted(LAYER_CASES).index(name)) \
        .randn(*out_shape).astype(np.float32)


def spec_tree(spec, make):
    """A spec tuple (or a dict of them) → ``make(*axes)`` specs."""
    if isinstance(spec, dict):
        return {k: spec_tree(v, make) for k, v in spec.items()}
    return make(*spec)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def layers_results(world):
    mesh = make_nd_mesh((AX,), (world,))
    out = {}
    for name, (path, kw, args_spec, out_spec) in LAYER_CASES.items():
        mod, fname = path.split(".")
        fn = getattr({"tensor_parallel": tp, "collective_matmul": cm}[mod],
                     fname)
        face = make_global_apply(
            partial(fn, axis_name=AX, **kw), mesh,
            [spec_tree(s, P) for _, s in args_spec], spec_tree(out_spec, P))
        args = [_tree(a, lambda x: torch.tensor(x)) if isinstance(a, dict)
                else torch.tensor(a) for a in layer_inputs(name)]
        floats = [t for a in args for t in _leaves(a)
                  if t.is_floating_point()]
        for t in floats:
            t.requires_grad_(True)
        y = face(*args)
        (y * torch.tensor(layer_out_weights(name, tuple(y.shape)))) \
            .sum().backward()
        out[name] = (y.detach().numpy(), [t.grad.numpy() for t in floats])
    out["mesh"] = mesh_results(world)
    return out


def mesh_results(world):
    """The groups this rank holds on a ``(world/2, 2)`` mesh and a
    multislice mesh of two slices."""
    def groups(mesh):
        return {ax: (list(range(world)) if mesh.axis(ax).group is None
                     else dist.get_process_group_ranks(mesh.axis(ax).group))
                for ax in mesh.axis_names}

    nd = make_nd_mesh(("data", "model"), (world // 2, 2))
    ms = make_multislice_mesh(num_slices=2)
    auto = make_multislice_mesh()
    return {"nd_devices": nd.devices.tolist(), "nd_groups": groups(nd),
            "nd_coords": nd.coords, "ms_devices": ms.devices.tolist(),
            "ms_groups": groups(ms), "auto_devices": auto.devices.tolist()}


# name -> (n_kv_heads, pos_impl, attn_impl, ce_impl)
LM_CASES = {
    "mha_learned_xla": (None, "learned", "xla", "xla"),
    "mha_rope_fused": (None, "rope", "xla", "fused"),
    "gqa_rope_xla": (2, "rope", "xla", "xla"),
    "gqa_learned_flash_fused": (2, "learned", "flash", "fused"),
}
LM = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, seq=16, batch=4,
          lr=1e-4, steps=5)


def lm_tokens(seed):
    return np.random.RandomState(seed).randint(
        0, LM["vocab"], (LM["batch"], LM["seq"] + 1)).astype(np.int64)


def lm_results(world, inputs):
    from chainermn_tpu_torch.convert import gather_to_numpy, shard_from_jax
    from chainermn_tpu_torch.optimizers import gradient_average
    from chainermn_tpu_torch.parallel import (make_hybrid_train_step,
                                              param_leaves,
                                              tp_transformer_lm_loss,
                                              transformer_lm_specs)
    from chainermn_tpu_torch.parallel._factory import local_block

    mesh = make_nd_mesh(("data", "model"), (world // 2, 2))
    head_dim = LM["d_model"] // LM["n_heads"]
    out = {}
    for i, (name, (_, _, attn, ce)) in enumerate(LM_CASES.items()):
        host = inputs["lm"][name]
        specs = transformer_lm_specs(host, AX)
        toks = torch.tensor(lm_tokens(i))
        loss_fn = partial(tp_transformer_lm_loss, head_dim=head_dim,
                          axis_name=AX, attn_impl=attn, ce_impl=ce)
        local = shard_from_jax(host, specs, mesh, device="cpu")
        leaves = param_leaves(local)
        for leaf in leaves:
            leaf.requires_grad_(True)
        with mesh:
            loss = loss_fn(local, (local_block(toks, P("data"), mesh),))
            loss.backward()
        gradient_average(leaves, mesh.axis("data"))
        grads = {k: leaf.grad.numpy() for k, leaf in flatten(local).items()}

        local = shard_from_jax(host, specs, mesh, device="cpu")
        opt = torch.optim.Adam(param_leaves(local), lr=LM["lr"])
        step = make_hybrid_train_step(loss_fn, opt, local, mesh)
        losses = [float(step(local, (toks,))) for _ in range(LM["steps"])]
        out[name] = {"grads": grads, "losses": losses,
                     "params": gather_to_numpy(local, specs, mesh)}
    out["sp"] = sp_results(world, inputs["sp"])
    return out


def sp_results(world, inp):
    """``tp_block_sp`` through the global face on a ``('model',)`` mesh of
    the world: output and the gradients of ``sum(out · R)``."""
    from chainermn_tpu_torch.convert import tree_map
    from chainermn_tpu_torch.parallel import transformer_lm_specs

    mesh = make_nd_mesh((AX,), (world,))
    host = inp["params"]
    blk_spec = transformer_lm_specs(host, AX)["blocks"][0]
    blk = tree_map(host["blocks"][0], lambda a: torch.tensor(a)
                   .requires_grad_(True))
    x = torch.tensor(inp["x"]).requires_grad_(True)
    head_dim = LM["d_model"] // LM["n_heads"]
    face = make_global_apply(
        partial(tr.tp_block_sp, head_dim=head_dim, axis_name=AX,
                positions=torch.arange(x.shape[1])),               # RoPE
        mesh, [P(None, AX), blk_spec], P(None, AX))
    y = face(x, blk)
    (y * torch.tensor(inp["R"])).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dparams": {k: v.grad.numpy() for k, v in flatten(blk).items()}}


def serve_schedule(eng, prompts, max_new, sample):
    """tests/test_torch_serving.py's staggered schedule: four requests, two
    steps, four more, then run to idle.  ``sample[i]``: None (greedy) or
    ``(temperature, key)``."""
    def submit(i):
        kw = {} if sample[i] is None else dict(temperature=sample[i][0],
                                               rng=sample[i][1])
        return eng.submit(prompts[i], max_new[i], **kw)

    handles = [submit(i) for i in range(4)]
    for _ in range(2):
        eng.step()
    handles += [submit(i) for i in range(4, 8)]
    eng.run(steps_budget=200)
    return handles


def decode_results(world, inputs):
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import (make_lm_beam_generator,
                                              make_lm_generator,
                                              transformer_lm_specs)
    from chainermn_tpu_torch.serving import ServingEngine

    mesh = make_nd_mesh((AX,), (world,))
    out = {}
    for name, case in inputs["decode"].items():
        host = case["params"]
        local = shard_from_jax(host, transformer_lm_specs(host, AX), mesh,
                               device="cpu")
        kw = dict(head_dim=case["head_dim"],
                  max_new_tokens=case["max_new"])
        if case["kind"] == "beam":
            gen = make_lm_beam_generator(mesh, AX, beam_size=4,
                                         lazy_reorder=case["lazy"], **kw)
            out[name] = gen(local, case["prompt"]).numpy()
        else:
            gen = make_lm_generator(mesh, AX,
                                    temperature=case["temperature"], **kw)
            out[name] = gen(local, case["prompt"], case["key"]).numpy()
    for name, case in inputs["serving"].items():
        host = case["params"]
        local = shard_from_jax(host, transformer_lm_specs(host, AX), mesh,
                               device="cpu")
        # built as the test builds JAX's engine: no prefix cache, no spill
        eng = ServingEngine(local, mesh=mesh, device="cpu",
                            prefix_cache=False, spill_bytes=0, **case["kw"])
        if not eng.engine.leader:
            eng.follow()
            out[name] = None
            continue
        try:
            hs = serve_schedule(eng, case["prompts"], case["max_new"],
                                case["sample"])
        finally:
            eng.close()
        out[name] = [(h.status, h.tokens) for h in hs]
    out["leader_raises"] = leader_raises(mesh, inputs["serving"])
    return out


def leader_raises(mesh, serving):
    """The leader's driving loop raises between two ticks (a request's
    ``on_token`` fails on its third token) and closes in ``finally``: the
    follower returns from ``follow()``, its own ``close()`` does nothing,
    and both ranks still meet in the next collective."""
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import transformer_lm_specs
    from chainermn_tpu_torch.serving import ServingEngine

    case = next(iter(serving.values()))
    host = case["params"]
    local = shard_from_jax(host, transformer_lm_specs(host, AX), mesh,
                           device="cpu")
    eng = ServingEngine(local, mesh=mesh, device="cpu", **case["kw"])
    if eng.engine.leader:
        seen = []

        def on_token(tok, rid):
            seen.append(tok)
            if len(seen) == 3:
                raise RuntimeError("on_token failed")

        try:
            eng.submit(case["prompts"][0], 8, on_token=on_token)
            eng.run(steps_budget=20)
            res = ("returned", eng.engine.tick_calls)
        except RuntimeError as e:
            res = ("raised", str(e), eng.engine.tick_calls)
        finally:
            eng.close()
    else:
        res = ("followed", eng.follow())
        eng.close()
    res += (float(col.psum(torch.ones(()), mesh.axis(AX))),)
    return res


def prefix_schedule(eng, prompts, max_new):
    """A shared-prefix schedule that spills and restores on a 2-slot pool:
    request 0 alone, 1-2 together (prefix hits on 0's donation), 3-5 one
    at a time (distinct prompts scavenge, and spill, the cached slots),
    then 6 (0's family again: a spill restore) and 7 (a hit on 6's
    donation)."""
    handles = [eng.submit(prompts[0], max_new[0])]
    eng.run(steps_budget=200)
    handles += [eng.submit(prompts[i], max_new[i]) for i in (1, 2)]
    eng.run(steps_budget=200)
    for i in range(3, len(prompts)):
        handles.append(eng.submit(prompts[i], max_new[i]))
        eng.run(steps_budget=200)
    return handles


class _CorruptOnRead(dict):
    """A follower's spilled payloads, each read back with one byte of its
    last K/V row flipped (the CRC stamp left as packed)."""

    def get(self, key, default=None):
        payload = super().get(key, default)
        if payload is None:
            return payload
        data = pickle.loads(payload)
        k, v = data["rows"][-1]
        v = np.array(v, copy=True)
        v.view(np.uint8).flat[-1] ^= 1
        data["rows"][-1] = (k, v)
        return pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)


def prefix_results(world, inputs):
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import transformer_lm_specs
    from chainermn_tpu_torch.serving import ServingEngine

    mesh = make_nd_mesh((AX,), (world,))
    case = inputs["prefix"]
    host = case["params"]
    local = shard_from_jax(host, transformer_lm_specs(host, AX), mesh,
                           device="cpu")
    out = {}
    for corrupt in (False, True):
        eng = ServingEngine(local, mesh=mesh, device="cpu", **case["kw"])
        if corrupt and dist.get_rank() == world - 1:
            eng.engine._spilled = _CorruptOnRead()
        if not eng.engine.leader:
            out[corrupt] = ("followed", eng.follow(),
                            eng.engine.prefix_copies,
                            eng.engine.prefill_calls)
            continue
        try:
            hs = prefix_schedule(eng, case["prompts"], case["max_new"])
        finally:
            eng.close()
        m = eng.metrics()
        out[corrupt] = ([(h.status, h.tokens) for h in hs],
                        {k: v for k, v in m.items()
                         if k.startswith(("serving/prefix/",
                                          "serving/spill/"))},
                        eng.engine.prefix_copies, eng.engine.prefill_calls)
    return out


def cli_results(inputs):
    from chainermn_tpu_torch import generate, serve, train_hybrid
    from chainermn_tpu_torch import train_transformer

    out = {}
    for name, mod in (("train_transformer", train_transformer),
                      ("train_hybrid", train_hybrid),
                      ("generate", generate), ("serve", serve)):
        argv, params = inputs["cli"][name]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.run(["--device", "cpu", *argv], params=params)
        if isinstance(res, dict):
            res.pop("params", None)
        out[name] = (res, buf.getvalue())
    return out


def main(suite, rank, world, store_file, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=120, store=store, rank=rank,
                     world_size=world)
    inputs = None
    if suite != "layers":
        with open(Path(out_dir) / "inputs.pkl", "rb") as fh:
            inputs = pickle.load(fh)
    out = {"layers": lambda: layers_results(world),
           "lm": lambda: lm_results(world, inputs),
           "decode": lambda: decode_results(world, inputs),
           "prefix": lambda: prefix_results(world, inputs),
           "cli": lambda: cli_results(inputs)}[suite]()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
