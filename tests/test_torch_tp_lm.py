"""The port's LM at TP = 2 (and DP x TP = 2 x 2) vs the JAX package's, on the CPU.

Each case of ``tests/_torch_tp_worker.py``'s ``LM_CASES`` (MHA and GQA,
learned positions and RoPE, ``ce_impl`` ``xla`` and ``fused``, one with the
flash path) takes JAX's initial params and tokens through
``tp_transformer_lm_loss`` on a ``(1, 2)`` mesh (two gloo processes) and a
``(2, 2)`` mesh (four), one launch each that runs every case, against
JAX's ``shard_map`` on the same mesh of virtual CPU devices:

* the gradients after the data mean: a replicated leaf's (the norms,
  ``bo``, ``pos_embed``) is the same on every model rank and equals JAX's,
  a sharded leaf's equals its slice of JAX's (rtol 1e-5, atol 1e-5 of the
  leaf's largest entry);
* five Adam steps (lr 1e-4) of ``make_hybrid_train_step`` against JAX's
  ``make_hybrid_shard_map_step``: losses rtol 1e-5, the parameters
  gathered by ``gather_to_numpy`` atol 1e-5 (but the key bias, whose
  exact gradient is zero: :func:`_key_bias`).  Adam normalises each
  update to about ``lr``, so a weight whose small gradient carries a
  relative rounding error ``e`` lands ``~e·lr`` off per step: at lr 1e-3
  one weight of 16,384 of the flash + fused GQA case's ``mlp.wi`` lands
  3e-5 off JAX's after five steps; at 1e-4 the five steps move the
  weights by up to 5e-4, which the 1e-5 bound still reads.

``tp_block_sp`` (RoPE) through the global face at P = 2 and 4 against
JAX's: the output and every gradient, rtol 1e-5 (atol 1e-5 of the largest
entry).
"""

import pickle
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

import chainermn_tpu as mn
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.parallel import (make_hybrid_shard_map_step, shard_pytree,
                                    state_specs_like, tp_block_sp,
                                    tp_transformer_lm_loss,
                                    transformer_lm_specs)
from chainermn_tpu.parallel._factory import make_global_apply
from chainermn_tpu_torch.convert import flatten

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_tp_worker import AX, LM, LM_CASES, lm_tokens  # noqa: E402
from test_torch_functions import launch  # noqa: E402
from test_torch_tp import close  # noqa: E402

WORLDS = (2, 4)
HEAD_DIM = LM["d_model"] // LM["n_heads"]


def lm_params(i, name):
    kv, pos, _, _ = LM_CASES[name]
    jp = jax_init(jax.random.PRNGKey(i), LM["vocab"], LM["d_model"],
                  LM["n_heads"], LM["n_layers"], max_len=LM["seq"],
                  pos_impl=pos, n_kv_heads=kv)
    return jax.tree_util.tree_map(np.asarray, jp)


def sp_inputs():
    rng = np.random.RandomState(7)
    jp = jax_init(jax.random.PRNGKey(9), LM["vocab"], LM["d_model"],
                  LM["n_heads"], 1, max_len=8, pos_impl="rope")
    return {"params": jax.tree_util.tree_map(np.asarray, jp),
            "x": rng.randn(2, 8, LM["d_model"]).astype(np.float32),
            "R": rng.randn(2, 8, LM["d_model"]).astype(np.float32)}


def inputs():
    return {"lm": {name: lm_params(i, name)
                   for i, name in enumerate(LM_CASES)},
            "sp": sp_inputs()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    inp = inputs()
    out = {}
    for w in WORLDS:
        tmp = tmp_path_factory.mktemp(f"tplm{w}")
        with open(tmp / "inputs.pkl", "wb") as fh:
            pickle.dump(inp, fh)
        out[w] = launch("_torch_tp_worker.py", "lm", w, tmp, timeout=240)[0]
    return inp, out


def _mesh(world):
    return mn.make_nd_mesh(("data", "model"), (world // 2, 2),
                           jax.devices()[:world])


def jax_lm(name, i, params, world):
    """JAX's gradients of the data-mean loss, then its five Adam losses
    and final params, on the ``(world/2, 2)`` mesh."""
    _, _, attn, ce = LM_CASES[name]
    mesh = _mesh(world)
    specs = transformer_lm_specs(params, AX)
    loss_fn = partial(tp_transformer_lm_loss, head_dim=HEAD_DIM,
                      axis_name=AX, attn_impl=attn, ce_impl=ce)
    toks = jax.device_put(lm_tokens(i).astype(np.int32),
                          NamedSharding(mesh, JP("data")))

    def body(p, t):
        return jax.grad(lambda q: jax.lax.pmean(loss_fn(q, (t,)), "data"))(p)

    grads = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, JP("data")),
                              out_specs=specs))(params, toks)
    opt = optax.adam(LM["lr"])
    step = make_hybrid_shard_map_step(loss_fn, opt, mesh, params, specs,
                                      donate=False)
    p = shard_pytree(params, mesh, specs)
    st = shard_pytree(opt.init(params), mesh,
                      state_specs_like(opt, params, specs))
    losses = []
    for _ in range(LM["steps"]):
        p, st, loss = step(p, st, (toks,))
        losses.append(float(loss))
    tree = jax.tree_util.tree_map(np.asarray, (grads, p))
    return flatten(tree[0]), losses, flatten(tree[1])


def _key_bias(leaf, size):
    """The key-bias columns of ``bqkv`` / ``bkv``.  The key bias shifts
    every score of a softmax row by the same amount, so its exact gradient
    is zero and both packages hold only rounding noise there; Adam scales
    that noise up to +-lr with an arbitrary sign (tests/test_torch_train.py
    leaves them out of its Adam comparison too)."""
    parts = 3 if leaf.endswith("bqkv") else 2
    cols = np.zeros((size // (parts * HEAD_DIM), parts, HEAD_DIM), bool)
    cols[:, 1 if parts == 3 else 0] = True
    return cols.ravel()


def _local_slice(full, spec_axes, rank, world):
    """This rank's slice of a global leaf: the model coordinate is
    ``rank % 2`` on the ``(world/2, 2)`` mesh."""
    for d, ax in enumerate(spec_axes):
        if ax == AX:
            n = full.shape[d] // 2
            full = np.take(full, range((rank % 2) * n, (rank % 2 + 1) * n),
                           axis=d)
    return full


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_grads_and_adam_steps_match_jax(worlds, name, world):
    inp, out = worlds
    i = list(LM_CASES).index(name)
    params = inp["lm"][name]
    want_g, want_losses, want_p = jax_lm(name, i, params, world)
    specs = flatten(transformer_lm_specs(params, AX))
    for r, res in enumerate(out[world]):
        got = res[name]
        assert got["grads"].keys() == want_g.keys()
        for leaf, g in got["grads"].items():
            close(g, _local_slice(want_g[leaf], specs[leaf], r, world),
                  f"{name} grad {leaf} rank {r}")
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                                   err_msg=f"{name} losses rank {r}")
        gathered = flatten(got["params"])
        for leaf, w in want_p.items():
            t = gathered[leaf]
            if leaf.endswith(("bqkv", "bkv")):
                keep = ~_key_bias(leaf, t.size)
                t, w = t[keep], w[keep]
            np.testing.assert_allclose(t, w, atol=1e-5, rtol=0,
                                       err_msg=f"{name} {leaf}")
    # a replicated leaf's gradient is the same on every model rank
    for leaf, spec in specs.items():
        if AX not in tuple(spec):
            ref = out[world][0][name]["grads"][leaf]
            for res in out[world][1:]:
                np.testing.assert_array_equal(res[name]["grads"][leaf], ref,
                                              err_msg=leaf)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_block_sp_matches_jax(worlds, world):
    inp, out = worlds
    sp = inp["sp"]
    blk = sp["params"]["blocks"][0]
    mesh = Mesh(np.array(jax.devices()[:world]), (AX,))
    blk_spec = transformer_lm_specs(sp["params"], AX)["blocks"][0]
    s = sp["x"].shape[1]
    face = make_global_apply(
        partial(tp_block_sp, head_dim=HEAD_DIM, axis_name=AX,
                positions=jnp.arange(s)),
        mesh, (JP(None, AX), blk_spec), JP(None, AX))
    y = np.asarray(face(sp["x"], blk))
    dx, dp = jax.grad(lambda x, p: jnp.sum(face(x, p) * sp["R"]),
                      argnums=(0, 1))(sp["x"], blk)
    want_dp = flatten(jax.tree_util.tree_map(np.asarray, dp))
    for r, res in enumerate(out[world]):
        got = res["sp"]
        close(got["y"], y, f"tp_block_sp rank {r}")
        close(got["dx"], np.asarray(dx), f"tp_block_sp dx rank {r}")
        assert got["dparams"].keys() == want_dp.keys()
        for leaf, w in want_dp.items():
            close(got["dparams"][leaf], w, f"tp_block_sp d{leaf} rank {r}")
