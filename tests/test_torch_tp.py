"""The port's tensor-parallel layers, collective matmuls and N-D mesh vs the JAX package's, on the CPU.

Each layer case of ``tests/_torch_tp_worker.py`` (``LAYER_CASES``: the TP
MLP, column-parallel with ``gather_output``, row-parallel with a
replicated input, the vocab-parallel embedding, both collective matmuls,
``gather_seq_matmul`` / ``matmul_scatter_seq`` and ``tp_mlp_sp``) runs at
P = 2 and 4 through the port's global face (one gloo process per rank,
one launch per P that runs every case) and through JAX's
``make_global_apply`` on the first P virtual CPU devices: the output and
the gradient of ``sum(out · R)`` for every float input, rtol 1e-5 (atol
1e-5 of the largest entry: see :func:`close`).  The
groups of ``make_nd_mesh`` hold the ranks that JAX's ``Mesh.devices``
places on one row or column, and ``make_multislice_mesh`` lays the ranks
out as JAX's does.
"""

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import chainermn_tpu as mn
from chainermn_tpu.parallel import collective_matmul as jcm
from chainermn_tpu.parallel import tensor_parallel as jtp
from chainermn_tpu.parallel._factory import make_global_apply

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_tp_worker import (AX, LAYER_CASES, layer_inputs,  # noqa: E402
                              layer_out_weights, spec_tree)
from test_torch_functions import launch  # noqa: E402

WORLDS = (2, 4)
# JAX's shard_map refuses a replicated out_spec for an all_gather result
# while it checks varying axes; its gradient is right without the check
NO_VMA = {"column_gather"}


def close(got, want, msg):
    """rtol 1e-5, and an atol of 1e-5 x the largest |entry| of the
    reference (the model-parallel checks' rule): an entry near zero that
    is a sum of terms of that size carries fp32 reassociation error of
    about that much."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=msg)


def jax_layer(name, world):
    """JAX's output and input gradients of the case at P = ``world``."""
    path, kw, args_spec, out_spec = LAYER_CASES[name]
    mod, fname = path.split(".")
    fn = getattr({"tensor_parallel": jtp, "collective_matmul": jcm}[mod],
                 fname)
    mesh = Mesh(np.array(jax.devices()[:world]), (AX,))
    apply = make_global_apply(
        partial(fn, axis_name=AX, **kw), mesh,
        tuple(spec_tree(s, JP) for _, s in args_spec), spec_tree(out_spec, JP),
        check_vma=name not in NO_VMA)
    args = layer_inputs(name)
    y = np.asarray(apply(*args))
    r = layer_out_weights(name, y.shape)
    floats = tuple(i for i, a in enumerate(args)
                   if isinstance(a, dict) or a.dtype.kind == "f")

    def loss(*fl):
        full = list(args)
        for i, v in zip(floats, fl):
            full[i] = v
        return jnp.sum(apply(*full) * r)

    grads = jax.grad(loss, argnums=tuple(range(len(floats))))(
        *[args[i] for i in floats])
    return y, [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: launch("_torch_tp_worker.py", "layers", w,
                      tmp_path_factory.mktemp(f"tp{w}"), timeout=180)[0]
            for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_values_and_gradients_match_jax(worlds, name, world):
    want_y, want_g = jax_layer(name, world)
    for r, out in enumerate(worlds[world]):
        got_y, got_g = out[name]
        close(got_y, want_y, f"{name} rank {r}")
        assert len(got_g) == len(want_g)
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            close(g, w, f"{name} grad {i} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_nd_mesh_groups_are_jax_rows_and_columns(worlds, world):
    devs = mn.make_nd_mesh(("data", "model"), (world // 2, 2),
                           jax.devices()[:world]).devices
    ids = np.vectorize(lambda d: d.id)(devs)
    for r, out in enumerate(worlds[world]):
        m = out["mesh"]
        assert m["nd_devices"] == ids.tolist()
        (row, col), = np.argwhere(ids == r)
        assert m["nd_coords"] == (row, col)
        assert m["nd_groups"]["model"] == ids[row].tolist()
        assert m["nd_groups"]["data"] == ids[:, col].tolist()


@pytest.mark.parametrize("world", WORLDS)
def test_multislice_mesh_matches_jax(worlds, world):
    from chainermn_tpu.topology import make_multislice_mesh, slice_index_of

    devices = jax.devices()[:world]
    cut = make_multislice_mesh(devices, num_slices=2).devices
    auto = make_multislice_mesh(devices).devices
    assert {slice_index_of(d) for d in devices} == {0}   # one host
    ids = np.vectorize(lambda d: d.id)(cut)
    for r, out in enumerate(worlds[world]):
        m = out["mesh"]
        assert m["ms_devices"] == ids.tolist()
        assert m["auto_devices"] == \
            np.vectorize(lambda d: d.id)(auto).tolist()
        (row, col), = np.argwhere(ids == r)
        assert m["ms_groups"] == {"slice": ids[:, col].tolist(),
                                  "chip": ids[row].tolist()}


def test_slice_index_follows_the_host_blocks(monkeypatch):
    """``slice_index_of`` is the host index: ``LOCAL_WORLD_SIZE`` blocks of
    consecutive ranks (JAX: ``process_index`` off a multislice TPU)."""
    import torch.distributed as dist

    from chainermn_tpu_torch.topology import slice_index_of

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    assert [slice_index_of(r) for r in range(8)] == [0] * 4 + [1] * 4


def test_unbound_axis_name_raises():
    import torch

    from chainermn_tpu_torch.parallel import tensor_parallel as tp

    with pytest.raises(NameError, match="unbound axis name 'model'"):
        tp.reduce_from_model(torch.ones(2), "model")
    assert tp.reduce_from_model(torch.ones(2), None).tolist() == [1.0, 1.0]


def test_state_specs_follow_the_parameter_shards():
    """``state_specs_like``: a ``torch.optim`` state of the parameter's
    shape follows its spec, anything else (Adam's step) is replicated."""
    import torch

    from chainermn_tpu_torch.parallel import P, param_leaves, state_specs_like

    params = {"wi": torch.ones(4, 6), "bo": torch.zeros(4)}
    specs = {"wi": P(None, "model"), "bo": P()}
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=0.1)
    sum(leaf.sum() for leaf in leaves).backward()
    opt.step()
    assert state_specs_like(opt, params, specs) == {
        "wi": {"step": P(), "exp_avg": P(None, "model"),
               "exp_avg_sq": P(None, "model")},
        "bo": {"step": P(), "exp_avg": P(), "exp_avg_sq": P()}}
