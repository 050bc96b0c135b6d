"""The port's differentiable communication vs the JAX package's, on the CPU.

Every case of JAX's ``tests/test_functions.py`` (and ``ring_exchange`` back
and forth, ``all_to_all`` untiled and tiled, ``gather``, ``recv`` and the
private differentiable ``psum`` / ``pmean``), forward and backward, at
world 2 and 4: the port runs one gloo process per rank
(``tests/_torch_functions_worker.py``, one launch per world size that
runs every case), each rank's ``backward()`` starting from its local
``out.sum()``; the oracle is the JAX function under ``jax.grad`` of the
same local loss inside ``shard_map`` on the first ``W`` virtual CPU
devices (``tests/test_functions.py :: grad_through``).  Each rank's output
and gradient equal JAX's block at fp32 rtol 1e-6.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from chainermn_tpu import functions as JF
from chainermn_tpu.functions.point_to_point import ring_exchange as j_ring
from chainermn_tpu_torch import functions as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_functions_worker import (FUNCTION_CASES,  # noqa: E402
                                     function_inputs)

WORLDS = (2, 4)


def _w(idx):
    return (idx + 1).astype(jnp.float32)


# the JAX twin of each worker case: fn(block, axis index, world)
JAX_CASES = {
    "send": lambda b, i, W: jnp.where(i == W - 1, JF.send(
        b, dest=W - 1, source=W - 2) * 3.0, 0.0),
    "send_multi": lambda b, i, W: JF.send(
        b, dest=[1, 2 % W], source=[0, W - 1]) * _w(i),
    "recv": lambda b, i, W: JF.recv(b, source=W - 1, dest=0) * _w(i),
    "ring_exchange": lambda b, i, W: j_ring(b, 1) * _w(i),
    "ring_exchange_back": lambda b, i, W: j_ring(b, -1) * _w(i),
    "bcast": lambda b, i, W: JF.bcast(b, root=W - 1) * _w(i),
    "allgather": lambda b, i, W: JF.allgather(b) * _w(i),
    "allgather_tiled": lambda b, i, W: JF.allgather(
        b, axis=1, tiled=True) * _w(i),
    "all_to_all": lambda b, i, W: JF.all_to_all(b) * _w(i),
    "all_to_all_tiled": lambda b, i, W: JF.all_to_all(
        b, split_axis=1, concat_axis=0, tiled=True) * _w(i),
    "scatter": lambda b, i, W: JF.scatter(b, root=0) * _w(i),
    "gather": lambda b, i, W: JF.gather(b, root=W - 2) * _w(i),
    "pseudo_connect": lambda b, i, W: JF.pseudo_connect(
        JF.send(b, dest=1, source=0), b * 2.0),
    "pseudo_connect_multiple": lambda b, i, W: sum(JF.pseudo_connect(
        JF.send(b, dest=1, source=0), b + 1, b + 2)),
    "psum": lambda b, i, W: jax.lax.psum(b, "mn") * _w(i),
    "pmean": lambda b, i, W: jax.lax.pmean(b, "mn") * _w(i),
}


def jax_case(name, world):
    """Per-rank ``(output, gradient)`` of JAX's case at ``world`` ranks."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("mn",))
    fn = JAX_CASES[name]

    def body(blk):
        idx = jax.lax.axis_index("mn")
        out = fn(blk[0], idx, world)
        grad = jax.grad(lambda bb: jnp.sum(fn(bb[0], idx, world)))(blk)
        return out[None], grad

    run = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("mn"),
                                out_specs=(P("mn"), P("mn"))))
    out, grad = run(function_inputs(name, world))
    return np.asarray(out), np.asarray(grad)


def launch(worker, suite, world, tmp, argv=(), timeout=150):
    """Run ``tests/<worker>``'s ``suite`` in ``world`` gloo processes
    (``worker SUITE RANK WORLD STORE OUT_DIR ARGV...``, each writing
    ``OUT_DIR/rank<r>.pkl``): their results and output, rank by rank."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / worker), suite, str(r),
         str(world), str(tmp / "store"), str(tmp), *argv], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, \
        "\n".join(logs)[-4000:]
    outs = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs, logs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: launch("_torch_functions_worker.py", "functions", w,
                      tmp_path_factory.mktemp(f"fn{w}"))[0]
            for w in WORLDS}


def test_every_worker_case_has_a_jax_twin():
    assert set(FUNCTION_CASES) == set(JAX_CASES)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(FUNCTION_CASES))
def test_forward_and_backward_match_jax(worlds, name, world):
    want_out, want_grad = jax_case(name, world)
    for r, out in enumerate(worlds[world]):
        got_out, got_grad = out[name]
        np.testing.assert_allclose(got_out, want_out[r], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(got_grad, want_grad[r], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} grad rank {r}")


def test_transpose_pairings_hold(worlds):
    """The reference's pairings, read off the world-4 results: a send's
    cotangent returns to its source, bcast's sums onto root, allgather's
    is the sum of every rank's weight, pseudo_connect's is the actual
    variable's alone."""
    outs, W = worlds[4], 4
    for r, out in enumerate(outs):
        grad = out["send"][1]
        np.testing.assert_allclose(grad, 3.0 if r == W - 2 else 0.0)
        grad = out["bcast"][1]
        np.testing.assert_allclose(grad, 10.0 if r == W - 1 else 0.0)
        np.testing.assert_allclose(out["allgather"][1], 10.0)
        np.testing.assert_allclose(out["pseudo_connect"][1], 2.0)


def test_pseudo_connect_requires_variables():
    with pytest.raises(ValueError):
        F.pseudo_connect(torch.ones(3))
    with pytest.raises(ValueError):
        JF.pseudo_connect(jnp.ones(3))


def test_pseudo_connect_ties_the_delegate_into_backward():
    """A ``backward()`` from the returned tensor runs the delegate's graph
    (the delegate gets a zero gradient), one tensor or a tuple."""
    ran = []

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            ran.append(g.clone())
            return g

    a = torch.ones(3, requires_grad=True)
    b = torch.arange(3.0, requires_grad=True)
    out = F.pseudo_connect(Mark.apply(a), b * 2.0)
    out.sum().backward()
    assert len(ran) == 1 and not ran[0].any()
    np.testing.assert_array_equal(b.grad.numpy(), [2.0, 2.0, 2.0])
    x, y = F.pseudo_connect(Mark.apply(a), b + 1, b + 2)
    (x + y).sum().backward()
    assert len(ran) == 2


def test_functions_exports_match_jax():
    import chainermn_tpu.functions as jf
    import chainermn_tpu_torch.functions as tf

    public = {n for n in dir(jf) if not n.startswith("_")
              and callable(getattr(jf, n))}
    assert public == set(tf.__all__)
