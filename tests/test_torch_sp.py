"""The port's sequence parallelism vs the JAX package's, on the CPU.

``tests/_torch_sp_worker.py sp`` runs in two and in four gloo processes
(one launch per world that runs every case) on a ``('sp',)`` mesh, and
JAX runs the same cases under ``shard_map`` on as many virtual CPU
devices, from the same numpy inputs:

* ``make_ring_attention`` and ``make_ulysses_attention``, causal and not,
  MHA and GQA, ``attn_impl="xla"``; and the flash path at one tiny shape
  at P = 2 (the port's plain kernel twins, the ring's backward with the
  LSE cotangent, against JAX's Pallas kernels in interpret mode): the
  output and every gradient of ``sum(out · R)``, rtol 1e-5 with an atol
  of 1e-5 of the largest entry;
* ``sp_transformer_lm_loss`` (d 64, 2 layers, S 256; learned positions
  and RoPE, ring and Ulysses, one GQA case; each world a ring and a
  Ulysses case, :data:`LM_PAIRS`): the gradients of the loss's
  mean over the axis on every rank (the same tolerance), then three Adam
  steps (lr 1e-4) of ``make_hybrid_shard_map_step`` against optax's Adam
  on JAX's gradients: losses rtol 1e-5, parameters atol 1e-5 (but the
  key bias, whose exact gradient is zero: ``test_torch_tp_lm._key_bias``);
* ``train_long_context`` at world 2, ``--sp-impl ring`` and ``ulysses``,
  from JAX's initial params against the JAX example's recipe
  (``examples/long_context/train_long_context.py``: Adam 1e-2, the first
  step's loss then three more): every loss rtol 1e-4;
* JAX's ``ValueError`` messages: Ulysses' two head rules, an unknown
  ``sp_impl``, a learned ``pos_embed`` shorter than the global sequence;
* the ring's flash backward: each run block's backward gets a finite LSE
  cotangent, non-zero where blocks merged; the skipped blocks run none.

Every launch has its own timeout, so that a hang fails the test; the JAX
side runs while the gloo ranks do (:func:`run_worlds`).
"""

import os
import pickle
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel import (make_ring_attention,
                                    make_ulysses_attention,
                                    sp_transformer_lm_loss)
from chainermn_tpu_torch.convert import flatten

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_sp_worker import (AX, ATTN_CASES, LC_ARGV, LM,  # noqa: E402
                              LM_CASES, LM_PAIRS, attn_inputs, lm_tokens)
from test_torch_tp import close  # noqa: E402
from test_torch_tp_lm import _key_bias  # noqa: E402

WORLDS = (2, 4)
HEAD_DIM = LM["d_model"] // LM["n_heads"]
LAUNCH_TIMEOUT_S = 240


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), (AX,))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def lm_params(i, name):
    kv, pos, _ = LM_CASES[name]
    return _host(jax_init(jax.random.PRNGKey(i), LM["vocab"], LM["d_model"],
                          LM["n_heads"], LM["n_layers"], max_len=LM["seq"],
                          pos_impl=pos, n_kv_heads=kv))


def lc_params():
    """The long-context example's initial params at ``LC_ARGV``'s size."""
    return _host(jax_init(jax.random.PRNGKey(0), 64, 32, 4, 2, max_len=32))


def start(suite, world, tmp, inputs):
    """``tests/test_torch_functions.py::launch`` of
    ``_torch_sp_worker.py SUITE`` with ``inputs`` pickled in ``tmp``, not
    waited for: returns ``finish() -> every rank's results``, which waits
    at most ``LAUNCH_TIMEOUT_S`` for the ranks, fails on a rank that did
    not exit 0 and leaves none running."""
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_sp_worker.py"), suite,
         str(r), str(world), str(tmp / "store"), str(tmp)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]

    def finish():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        assert [p.returncode for p in procs] == [0] * world, \
            "\n".join(logs)[-4000:]
        outs = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                outs.append(pickle.load(fh))
        return outs

    return finish


def run_worlds(tmp_path_factory, suite, inputs, references):
    """Per world: start the gloo ranks, compute ``references(world)`` (the
    JAX side) while they run, then collect them.  Returns ``({world: every
    rank's results}, {world: references})``."""
    out, want = {}, {}
    for w in WORLDS:
        finish = start(suite, w, tmp_path_factory.mktemp(f"{suite}{w}"),
                       inputs)
        try:
            want[w] = references(w)
        finally:
            out[w] = finish()
    return out, want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    inp = {"lm": {name: lm_params(i, name)
                  for i, name in enumerate(LM_CASES)},
           "long_context": lc_params()}

    def references(world):
        refs = {"attn": {n: jax_attention(n, world)
                         for n, w in ATTN_PAIRS if w == world},
                "lm": {n: jax_lm(n, list(LM_CASES).index(n), inp["lm"][n],
                                 world)
                       for n, w in LM_PAIRS if w == world},
                "errors": jax_errors(world)}
        if world == 2:
            refs["cli"] = jax_long_context()
        return refs

    return run_worlds(tmp_path_factory, "sp", inp, references)


def jax_attention(name, world):
    impl, causal, _, attn_impl = ATTN_CASES[name]
    make = {"ring": make_ring_attention,
            "ulysses": make_ulysses_attention}[impl]
    fn = make(mesh=_mesh(world), axis_name=AX, causal=causal,
              attn_impl=attn_impl)
    q, k, v, r = attn_inputs(name)

    def loss(*a):
        y = fn(*a)
        return jnp.sum(y * r), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    return [np.asarray(y)] + [np.asarray(g) for g in grads]


# the flash path against JAX's interpret-mode kernels at P = 2 only: one
# tiny shape, as the interpreter is slow
ATTN_PAIRS = [(name, w) for name in sorted(ATTN_CASES) for w in WORLDS
              if ATTN_CASES[name][3] == "xla" or w == 2]


@pytest.mark.parametrize("name, world", ATTN_PAIRS)
def test_attention_matches_jax(worlds, name, world):
    want = worlds[1][world]["attn"][name]
    for r, res in enumerate(worlds[0][world]):
        for what, g, w in zip(("out", "dq", "dk", "dv"), res["attn"][name],
                              want):
            close(g, w, f"{name} {what} rank {r}")


def _sp_value_and_grad(loss_fn, world):
    """JAX's loss mean over the axis and its gradient (replicated params,
    the tokens sequence-sharded), one compile."""
    seq = JP(None, AX)

    def body(p, batch):
        return jax.value_and_grad(
            lambda q: jax.lax.pmean(loss_fn(q, batch), AX))(p)

    return jax.jit(shard_map(body, mesh=_mesh(world),
                             in_specs=(JP(), (seq, seq)),
                             out_specs=(JP(), JP())))


def jax_lm(name, i, params, world):
    _, _, sp_impl = LM_CASES[name]
    vg = _sp_value_and_grad(partial(sp_transformer_lm_loss,
                                    head_dim=HEAD_DIM, axis_name=AX,
                                    sp_impl=sp_impl), world)
    batch = tuple(jnp.asarray(t.astype(np.int32)) for t in lm_tokens(i))
    _, grads = vg(params, batch)
    opt = optax.adam(LM["lr"])
    p, st, losses = params, opt.init(params), []
    for _ in range(LM["steps"]):
        loss, g = vg(p, batch)
        updates, st = opt.update(g, st, p)
        p = optax.apply_updates(p, updates)
        losses.append(float(loss))
    return flatten(_host(grads)), losses, flatten(_host(p))


@pytest.mark.parametrize("name, world", LM_PAIRS)
def test_sp_lm_grads_and_adam_steps_match_jax(worlds, name, world):
    out, refs = worlds
    want_g, want_losses, want_p = refs[world]["lm"][name]
    for r, res in enumerate(out[world]):
        got = res["lm"][name]
        assert got["grads"].keys() == want_g.keys()
        for leaf, g in got["grads"].items():
            close(g, want_g[leaf], f"{name} grad {leaf} rank {r}")
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                                   err_msg=f"{name} losses rank {r}")
        for leaf, w in want_p.items():
            t = got["params"][leaf]
            if leaf.endswith(("bqkv", "bkv")):
                keep = ~_key_bias(leaf, t.size)
                t, w = t[keep], w[keep]
            np.testing.assert_allclose(t, w, atol=1e-5, rtol=0,
                                       err_msg=f"{name} {leaf}")


def jax_long_context():
    """The JAX example's recipe at ``LC_ARGV`` on two devices: Adam 1e-2,
    the first step's loss, then three more."""
    opt = optax.adam(1e-2)
    loss_fn = partial(sp_transformer_lm_loss, head_dim=8, axis_name=AX,
                      attn_impl="xla")
    seq = JP(None, AX)

    def spmd(p, st, batch):
        loss, grads = jax.value_and_grad(
            lambda q: jax.lax.pmean(loss_fn(q, batch), AX))(p)
        updates, st = opt.update(grads, st, p)
        return optax.apply_updates(p, updates), st, loss

    mesh = _mesh(2)
    step = jax.jit(shard_map(spmd, mesh=mesh,
                             in_specs=(JP(), JP(), (seq, seq)),
                             out_specs=(JP(), JP(), JP())))
    tokens = np.random.RandomState(0).randint(0, 64, (2, 33)).astype(
        np.int32)
    batch = tuple(jax.device_put(t, NamedSharding(mesh, seq))
                  for t in (tokens[:, :-1], tokens[:, 1:]))
    params = lc_params()
    p, st, losses = params, opt.init(params), []
    for _ in range(1 + int(LC_ARGV[LC_ARGV.index("--steps") + 1])):
        p, st, loss = step(p, st, batch)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_long_context_cli_matches_the_jax_example(worlds, sp_impl):
    out, refs = worlds
    want = refs[2]["cli"]
    losses, printed = out[2][0]["cli"][sp_impl]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    assert f"initial loss {want[0]:.4f}" in printed
    assert "2 ranks, 32 tokens → 16 tokens/rank" in printed
    assert out[2][1]["cli"][sp_impl][1] == ""       # rank 1 prints nothing


def jax_errors(world):
    """JAX's messages for the worker's :func:`sp_errors` cases."""
    mesh = _mesh(world)
    seq = JP(None, AX)
    params = jax_init(jax.random.PRNGKey(0), 32, 16, 2, 1, max_len=8)

    def attn(h, h_kv):
        return lambda: make_ulysses_attention(mesh=mesh, axis_name=AX)(
            jnp.zeros((1, 8 * world, h, 4)),
            jnp.zeros((1, 8 * world, h_kv, 4)),
            jnp.zeros((1, 8 * world, h_kv, 4)))

    def lm(sp_impl, s):
        toks = jnp.zeros((1, s), jnp.int32)
        return lambda: jax.jit(shard_map(
            partial(sp_transformer_lm_loss, head_dim=8, axis_name=AX,
                    sp_impl=sp_impl),
            mesh=mesh, in_specs=(JP(), (seq, seq)), out_specs=JP(),
            check_vma=False))(params, (toks, toks))

    cases = {"ulysses_heads": attn(world + 1, world + 1),
             "ulysses_gqa": attn(2 * world, world // 2),
             "sp_impl": lm("bogus", 8), "pos_embed": lm("ring", 8 * world)}
    out = {}
    for name, fn in cases.items():
        with pytest.raises(ValueError) as e:
            fn()
        out[name] = str(e.value)
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_value_errors_match_jax(worlds, world):
    want = worlds[1][world]["errors"]
    for r, res in enumerate(worlds[0][world]):
        assert res["errors"] == want, f"rank {r}"


@pytest.mark.parametrize("world", WORLDS)
def test_ring_hands_each_block_its_lse_cotangent(worlds, world):
    """Causal, rank ``r`` runs the backward of its ``r`` full blocks and its
    diagonal (the later ranks' blocks are skipped: no call); every
    ``dlse`` is finite, and non-zero wherever two blocks merged."""
    for r, res in enumerate(worlds[0][world]):
        blocks = res["attn"]["ring_causal_gqa_flash_blocks"]
        # reverse ring order: the last block visited first, the diagonal last
        assert [c for c, _, _ in blocks] == [False] * r + [True], r
        assert all(finite for _, _, finite in blocks)
        if r:
            assert all(m > 0 for _, m, _ in blocks), blocks


def test_worker_imports_no_jax():
    """``tests/_torch_sp_worker.py`` runs the port alone, as the other
    workers do."""
    from test_torch_package import _forbidden, _imported_modules

    path = ROOT / "tests" / "_torch_sp_worker.py"
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []
