"""The port's int8 gradient wire and hierarchical mean vs the JAX package's, on the CPU.

``tests/_torch_zero_worker.py quantized`` runs in two and in four gloo
processes (one launch per world) on the world's ``'mn'`` axis, and JAX runs
the same cases under ``shard_map(..., check_vma=True)`` with every output
declared per rank (``out_specs=P(axis)``), from the same numpy inputs:

* ``quantized_ring_pmean`` at the defaults on 1, 5, 64 and 1,000 elements
  and at (block, pipeline) (4, 1), (16, 2), (256, 4) on 173: every rank's
  output equal to JAX's to the bit (``atol=0``), and within the ring's
  bound, ``P/254`` of the largest input, of the exact mean;
* ``compressed_mean`` int8 with and without a residual row: the means and
  the new residual to the bit; a residual of two rows or of the wrong
  size raises;
* ``hierarchical_pmean`` and ``hierarchical_gradient_average`` on the
  ``(2, 2)`` ``('slice', 'chip')`` mesh at world 4 (fp32 to the bit, the
  bf16 slice leg within bf16 rounding), and the gradient average's
  one-axis branches at world 2.

JAX's whole int8 train step does not run on this jax (its ``shard_map``
cannot infer the replication of its outputs), so the steps are held to
their stated semantics, as JAX's tests state them:

* the error-feedback trajectory at world 4 (50 SGD steps on a constant
  gradient, one scale a chunk): int8 + EF within rtol 1e-4 of the fp32
  wire's loss, the no-EF control's gap more than 2x EF's and its drift of
  the small coordinates larger;
* the combined int8 + EF + double-buffered mode at world 2: the first step
  applies nothing, the second the first's quantized mean, within the block
  envelope of the exact SGD step;
* a checkpoint of the residual rows saved at world 2 and resumed at world
  1 in this process: the row is JAX's ``fold_error_feedback`` of the two.

In this process too: the cost model, ``block_quantize`` to the bit (JAX's
compiled operator: XLA turns its division by the constant ``qmax`` into a
product by ``1/qmax``, which the port computes; eager JAX divides, and its
scales differ in the last bit for some blocks), the fold and the state's
layout and specs against JAX's, and the refusals' words.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import chainermn_tpu as mn
from chainermn_tpu.ops import collective as jcol
from chainermn_tpu.optimizers import ErrorFeedbackState as JaxEF
from chainermn_tpu.optimizers import compressed_mean as jax_cm
from chainermn_tpu.optimizers import error_feedback_layout as jax_layout
from chainermn_tpu.optimizers import fold_error_feedback as jax_fold
from chainermn_tpu.optimizers import \
    hierarchical_gradient_average as jax_hga
from chainermn_tpu_torch.ops import collective as col
from chainermn_tpu_torch.optimizers import (ErrorFeedbackState,
                                            create_multi_node_optimizer,
                                            error_feedback_layout,
                                            fold_error_feedback,
                                            gradient_average,
                                            opt_state_partition_specs)
from chainermn_tpu_torch.parallel import P
from chainermn_tpu_torch.topology import Mesh as TorchMesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_zero_worker import (AX, EF, STALE, _Linear, cm_inputs,  # noqa: E402
                                hier_inputs, ring_inputs, stale_inputs)
from test_torch_zero import WORLDS, run_worlds  # noqa: E402


def _mesh(world, names=(AX,)):
    devs = np.array(jax.devices()[:world])
    if len(names) == 2:
        devs = devs.reshape(2, world // 2)
    return Mesh(devs, names)


def _per_rank(fn, mesh, n_in, n_out, spec=JP(AX)):
    """``fn`` under ``shard_map(check_vma=True)``, every input and output
    split by rank on its leading axis."""
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                             out_specs=(spec,) * n_out, check_vma=True))


def jax_ring(world):
    """Every ring case of the world, one compiled program."""
    cases = ring_inputs(world)

    def body(*xs):
        return tuple(jcol.quantized_ring_pmean(
            x[0], AX, *(("int8", *lay) if lay else ()))[None]
            for x, (_, lay) in zip(xs, cases.values()))

    outs = _per_rank(body, _mesh(world), len(cases), len(cases))(
        *(x for x, _ in cases.values()))
    return {name: np.asarray(o) for name, o in zip(cases, outs)}


def jax_cm_refs(world):
    a, b, res = cm_inputs(world)

    def body(a, b, r):
        tree = {"a": a[0], "b": b[0]}
        lead = lambda t: [t["a"][None], t["b"][None]]  # noqa: E731
        plain = jax_cm(tree, AX, "int8")
        ef, new = jax_cm(tree, AX, "int8", residuals=r)
        return (*lead(plain), *lead(ef), new)

    return [np.asarray(v) for v in _per_rank(body, _mesh(world), 3, 5)(
        a, b, res)]


def _hga(v, **kw):
    t = jax_hga(**kw)
    return t.update(v, t.init(v))[0]


def jax_hier(world):
    x = hier_inputs(world)
    if world == 4:
        spec = JP(("slice", "chip"))
        fn = _per_rank(lambda v: (
            jcol.hierarchical_pmean(v[0])[None],
            jcol.hierarchical_pmean(v[0], dcn_dtype="bfloat16")[None],
            _hga(v[0])[None]), _mesh(4, ("slice", "chip")), 1, 3, spec)
        return dict(zip(("pmean", "pmean_bf16", "reduce"),
                        map(np.asarray, fn(x))))
    out = {}
    for axis in ("chip", "slice"):
        fn = _per_rank(lambda v: (_hga(v[0], dcn_dtype="bfloat16")[None],),
                       _mesh(world, (axis,)), 1, 1, JP(axis))
        out[f"reduce_{axis}"] = np.asarray(fn(x)[0])
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    def references(world):
        return {"ring": jax_ring(world), "cm": jax_cm_refs(world),
                "hier": jax_hier(world)}

    return run_worlds(tmp_path_factory, "quantized", {}, references)


RING_CASES = [(w, n) for w in WORLDS for n in ring_inputs(2)]


@pytest.mark.parametrize("world, name", RING_CASES)
def test_ring_matches_jax_to_the_bit(worlds, world, name):
    out, refs, _ = worlds
    want = refs[world]["ring"][name]
    x = ring_inputs(world)[name][0]
    for r, res in enumerate(out[world]):
        np.testing.assert_array_equal(res["ring"][name], want[r],
                                      err_msg=f"{name} rank {r}")
    np.testing.assert_allclose(out[world][0]["ring"][name], x.mean(0),
                               atol=world / 254.0 * np.abs(x).max())
    if x.shape[1] >= 64:                   # the quantizer touched the wire
        assert np.abs(out[world][0]["ring"][name] - x.mean(0)).sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_ring_keeps_each_leaf_dtype(worlds, world):
    for res in worlds[0][world]:
        assert res["ring"]["tree_dtypes"] == {"a": "torch.float32",
                                              "b": "torch.bfloat16"}


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_mean_int8_matches_jax(worlds, world):
    """The bucketed ring with and without a residual row; the new
    residual ``e' = v − Dq(Q(v))`` at the ring's block."""
    out, refs, _ = worlds
    pa, pb, ea, eb, res = refs[world]["cm"]
    for r, got in enumerate(out[world]):
        cm = got["cm"]
        for g, w in zip(cm["plain"] + cm["ef"], (pa[r], pb[r], ea[r],
                                                 eb[r])):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r}")
        np.testing.assert_array_equal(cm["residuals"], res[r:r + 1])
        assert np.abs(cm["residuals"]).max() > 0
        assert "leading dim 2" in cm["errors"]["rows"]
        assert "holds 18 elements but the gradient bucket holds 19" in \
            cm["errors"]["size"]


def test_hierarchical_pmean_matches_jax_on_the_multislice_mesh(worlds):
    out, refs, _ = worlds
    want = refs[4]["hier"]
    x = hier_inputs(4)
    for r, res in enumerate(out[4]):
        h = res["hier"]
        np.testing.assert_array_equal(h["pmean"], want["pmean"][r])
        np.testing.assert_array_equal(h["reduce"], want["reduce"][r])
        np.testing.assert_allclose(h["pmean_bf16"], want["pmean_bf16"][r],
                                   rtol=2 ** -8, atol=0)
        np.testing.assert_allclose(h["pmean"], x.mean(0), rtol=1e-6,
                                   atol=1e-7)


def test_hierarchical_gradient_average_one_axis_branches(worlds):
    """Only ``chip`` bound: the mean over it; only ``slice``: the mean over
    it on the bf16 wire; neither: the gradients unchanged."""
    out, refs, _ = worlds
    want = refs[2]["hier"]
    x = hier_inputs(2)
    for r, res in enumerate(out[2]):
        h = res["hier"]
        np.testing.assert_array_equal(h["reduce_chip"], want["reduce_chip"][r])
        np.testing.assert_allclose(h["reduce_slice"], want["reduce_slice"][r],
                                   rtol=2 ** -8, atol=0)
        np.testing.assert_array_equal(h["reduce_none"], x[r])


def test_error_feedback_tracks_fp32_and_the_control_drifts(worlds):
    """JAX's stated acceptance (``test_quantized_allreduce.py``): the EF
    run's loss within rtol 1e-4 of the fp32 wire's, the no-EF gap more
    than 2x EF's, the small coordinates' drift larger without EF, and a
    non-zero residual on every rank."""
    out = worlds[0][4]
    runs = out[0]["ef"]
    l32, l8, lef = (runs[k]["loss"] for k in ("fp32", "int8", "ef"))
    np.testing.assert_allclose(lef, l32, rtol=1e-4)
    assert abs(l8 - l32) > 2 * abs(lef - l32), (l8, lef, l32)
    small = np.ones(EF["d"], bool)
    small[::33] = False

    def drift(k):
        return float(np.abs(runs[k]["w"] - runs["fp32"]["w"])[small].mean())

    assert drift("int8") > 1.05 * drift("ef"), (drift("int8"), drift("ef"))
    for res in out:
        assert np.abs(res["ef"]["ef"]["residuals"]).sum() > 0
        np.testing.assert_array_equal(res["ef"]["ef"]["w"], runs["ef"]["w"])


def test_combined_mode_is_one_step_stale(worlds):
    """int8 + EF + double buffering: step 1 leaves the params as they
    were, step 2 applies step 1's quantized mean, within ``P/254`` of the
    gradient's largest entry times the learning rate of the exact step."""
    out = worlds[0][2]
    x, y = stale_inputs(2)
    w0, b0 = np.zeros((3, 1), np.float32), np.zeros(1, np.float32)
    err = x @ w0 + b0 - y
    g = {"w": 2 * x.T @ err / len(x), "b": 2 * err.mean(0)}
    for r, res in enumerate(out):
        first, second = res["stale"]["params"]
        assert not any(np.abs(v).sum() for v in first.values()), r
        for k in g:
            tol = 2 / 254.0 * np.abs(g[k]).max() * STALE["lr"] + 1e-6
            np.testing.assert_allclose(second[k], -STALE["lr"] * g[k],
                                       atol=tol, err_msg=f"{k} rank {r}")
        assert np.abs(res["stale"]["residuals"]).sum() > 0


def test_ef_checkpoint_from_world_2_resumes_at_world_1(worlds):
    """The two ranks' rows saved sharded by rank; at world 1 the elastic
    load hands this rank both and ``load_state_dict`` folds them into
    JAX's ``fold_error_feedback(rows, 1)``."""
    import torch.distributed as dist

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.extensions.checkpoint import \
        create_multi_node_checkpointer
    from chainermn_tpu_torch.train import make_train_step

    out, _, dirs = worlds
    saved = [res["ckpt"] for res in out[2]]
    assert saved[0]["layout"] == {"['opt']['ef'].residuals": ["sharded", 0]}
    rows = np.concatenate([s["residuals"] for s in saved])
    assert rows.shape == (2, 4) and np.abs(rows).sum() > 0
    comm = create_communicator("xla", device="cpu")
    try:
        cp = create_multi_node_checkpointer(
            "ef", comm, path=str(dirs[2] / "ckpt"), async_write=False)
        state, it = cp.maybe_load()
        assert it == 2
        np.testing.assert_array_equal(
            np.asarray(state["opt"]["ef"].residuals), rows)
        model = _Linear()
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=STALE["lr"]), comm,
            allreduce_grad_dtype="int8", error_feedback=True, quant_block=2)
        opt.load_state_dict(state["opt"])
        np.testing.assert_array_equal(opt.ef.residuals.numpy(),
                                      jax_fold(rows, 1))
        step = make_train_step(
            lambda m, b: ((b[0] @ m.w + m.b - b[1]) ** 2).mean(), opt,
            comm.mesh, error_feedback=True)
        batch = tuple(torch.tensor(a) for a in stale_inputs(2))
        assert np.isfinite(float(step(model, batch)))
        # at one rank the wire is exact and the residual stays as it was
        np.testing.assert_array_equal(opt.ef.residuals.numpy(),
                                      jax_fold(rows, 1))
    finally:
        dist.destroy_process_group()


# ---- in this process ----

@pytest.mark.parametrize("n", [1, 7, 173, 1000, 25_557_032])
def test_cost_model_matches_jax(n):
    for p in (1, 2, 3, 4, 8):
        for block in (4, 64, 256, 1 << 20):
            for k in (1, 2, 4):
                for wire in ("int8", "int16"):
                    args = (n, p, wire, block, k)
                    assert col.quantized_ring_cost(*args) == \
                        jcol.quantized_ring_cost(*args)
                    assert col._ring_layout(n, p, block, k) == \
                        jcol._ring_layout(n, p, block, k)
                    assert col.quantized_ring_static_groups(
                        n, p, "mn", wire, block, k) == \
                        jcol.quantized_ring_static_groups(
                            n, p, "mn", wire, block, k)
    for b in (0, 1, 1 << 10, 1 << 20, 1 << 24, 1 << 28):
        assert col.choose_pipeline_depth(b) == jcol.choose_pipeline_depth(b)
    assert col.LEDGER_TO_PRIMITIVE == jcol.LEDGER_TO_PRIMITIVE
    assert col.DEFAULT_QUANT_BLOCK == jcol.DEFAULT_QUANT_BLOCK


def test_block_quantize_matches_jax_to_the_bit_and_bound():
    """``test_quantized_allreduce.py``'s cases: q and the scales equal JAX's
    compiled quantizer's, the round trip equal, and within
    ``blockmax/254`` a block."""
    rng = np.random.RandomState(11)
    for n, block in [(777, 64), (64, 256), (5, 2), (1024, 1)]:
        v = (rng.randn(n) * rng.lognormal(0, 2, n)).astype(np.float32)
        jq, js = jax.jit(lambda a: jcol.block_quantize(a, "int8", block))(v)
        q, s = col.block_quantize(torch.tensor(v), "int8", block)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = col.block_dequantize(q, s, (n,)).numpy()
        np.testing.assert_array_equal(back, np.asarray(
            jcol.block_dequantize(jq, js, (n,))))
        eff = max(1, min(block, n))
        pad = (-n) % eff
        vb = np.pad(v, (0, pad)).reshape(-1, eff)
        err = np.abs(vb - np.pad(back, (0, pad)).reshape(-1, eff))
        assert (err <= np.abs(vb).max(1)[:, None] / 254.0 + 1e-7).all()
    for wire in ("bfloat16", torch.float16):
        with pytest.raises(ValueError, match="integer"):
            col.block_quantize(torch.zeros(4), wire)


def test_fold_and_layout_match_jax():
    rng = np.random.RandomState(9)
    res = rng.randn(4, 64).astype(np.float32)
    for new in (1, 2, 4, 8):
        np.testing.assert_array_equal(fold_error_feedback(res, new),
                                      jax_fold(res, new))
    np.testing.assert_allclose(fold_error_feedback(res, 2).sum(0) / 2,
                               res.sum(0) / 4, rtol=1e-6)
    for bad in (3, 0):
        with pytest.raises(ValueError):
            fold_error_feedback(res, bad)
    assert error_feedback_layout(ErrorFeedbackState(res), "['opt']") == \
        jax_layout(JaxEF(residuals=jnp.asarray(res)), "['opt']")


def test_optimizer_state_carries_its_residual_row():
    """The wrapper's state: one ``(1, n_total)`` row, sharded by rank in the
    manifest layout and the only ``P(axis)`` of the spec tree; a
    ``state_dict`` round trip keeps it."""
    params = [torch.nn.Parameter(torch.zeros(3, 2)),
              torch.nn.Parameter(torch.zeros(5))]
    opt = create_multi_node_optimizer(
        torch.optim.SGD(params, lr=0.1, momentum=0.9), TorchMesh(AX, None, 2),
        double_buffering=True, allreduce_grad_dtype="int8",
        error_feedback=True)
    assert opt.ef.residuals.shape == (1, 11)
    state = opt.state_dict()
    assert error_feedback_layout(state) == {"['ef'].residuals":
                                            ["sharded", 0]}
    specs = opt_state_partition_specs(state, AX)
    from chainermn_tpu_torch import _tree
    flat = _tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    assert flat.count(P(AX)) == 1 and specs["ef"].residuals == P(AX)
    state["ef"] = ErrorFeedbackState(torch.ones(1, 11))
    opt.load_state_dict(state)
    assert torch.equal(opt.ef.residuals, torch.ones(1, 11))
    assert opt.state.ef is opt.ef


def test_error_feedback_refusals_say_what_jax_says():
    sgd = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1)
    with pytest.raises(ValueError) as e:
        mn.create_multi_node_optimizer(
            optax.sgd(0.1), mn.create_communicator("xla"),
            allreduce_grad_dtype="bfloat16", error_feedback=True)
    with pytest.raises(ValueError) as got:
        create_multi_node_optimizer(sgd, TorchMesh(AX, None, 2),
                                    allreduce_grad_dtype="bfloat16",
                                    error_feedback=True)
    assert str(got.value) == str(e.value)
    with pytest.raises(ValueError) as e:
        mn.gradient_average("mn", "int8", error_feedback=True)
    with pytest.raises(ValueError) as got:
        gradient_average(sgd.param_groups[0]["params"], "mn", "int8",
                         error_feedback=True)
    assert str(got.value) == str(e.value)
    with pytest.raises(ValueError, match="integer wire"):
        col_mesh = TorchMesh(AX, None, 1)
        from chainermn_tpu_torch.optimizers import compressed_mean
        compressed_mean([torch.zeros(2)], col_mesh, "float16",
                        residuals=torch.zeros(1, 2))
