"""``rolling_upgrade`` over in-process runtimes at TP = 2: the port
against the JAX package's, on the CPU.

JAX's in-process fleet is one controller: its engine worker holds a
2-device mesh, and ``rolling_upgrade`` builds the replacement over the
same mesh and drains the old worker, shedding nothing.  The port runs the
same worker as a group of two gloo processes (``build_local_fleet`` on
model rank 0, ``follow_worker`` on rank 1,
``tests/_torch_upgrade_tp_worker.py``): the replacement would be built on
rank 0 only, and no plan op builds it on the follower, which would go on
running the old worker's calls.  So the port refuses loudly before it
touches the fleet, naming the ROADMAP item (A11 step 3d), and the group
still serves and closes: the follower returns.  The same JAX-initialised
weights and prompt go through both; the port's tokens equal JAX's.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as mn
from chainermn_tpu.parallel import init_tp_transformer_lm as jax_init
from chainermn_tpu.serving import build_local_fleet as jax_local_fleet
from chainermn_tpu.serving import rolling_upgrade as jax_rolling_upgrade

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
VOCAB, D, HEADS, LAYERS = 32, 16, 4, 1
HEAD_DIM = D // HEADS
PROMPT, MAX_NEW = [2, 7, 1, 8, 2], 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch in one thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    jp = jax_init(jax.random.PRNGKey(0), VOCAB, D, HEADS, LAYERS,
                  max_len=32)
    return jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("upgrade_tp")
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump({"params": _params(), "head_dim": HEAD_DIM,
                     "prompt": PROMPT, "max_new": MAX_NEW}, fh)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_upgrade_tp_worker.py"),
         str(r), str(WORLD), str(tmp / "store"), str(tmp)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, \
        "\n".join(logs)[-4000:]
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


@pytest.fixture(scope="module")
def jax_side():
    """JAX's in-process fleet at TP = 2: one engine worker on a 2-device
    mesh, upgraded to generation 2 while it serves."""
    import threading

    params = _params()
    mesh = mn.make_nd_mesh(("model",), (WORLD,), jax.devices()[:WORLD])
    kw = dict(mesh=mesh, n_slots=2, max_total=32)
    router, runtimes = jax_local_fleet(
        params, {"engine": 1}, head_dim=HEAD_DIM, beat_interval_s=0.02,
        miss_beats=16, worker_kwargs=kw)
    threads = [threading.Thread(target=rt.run, daemon=True)
               for rt in runtimes]
    for t in threads:
        t.start()
    router.start()
    try:
        before = router.submit(PROMPT, MAX_NEW)
        assert before.wait(120)
        report = jax_rolling_upgrade(
            router, runtimes, [params],
            jax.tree_util.tree_map(lambda _: None, params), generation=2,
            head_dim=HEAD_DIM, worker_kwargs=kw, timeout_s=120.0)
        after = router.submit(PROMPT, MAX_NEW)
        assert after.wait(120)
        return {"before": before.tokens, "after": after.tokens,
                "report": report}
    finally:
        router.stop()
        for rt in runtimes:
            rt.finished = True
        for t in threads:
            t.join(30)


def test_jax_upgrades_its_tp2_in_process_worker(jax_side):
    report = jax_side["report"]
    assert report["generation"] == 2 and report["drain_shed"] == 0
    assert [u["old"] for u in report["upgraded"]] == ["engine0"]
    assert jax_side["after"] == jax_side["before"]


def test_port_refuses_at_tp2_naming_the_roadmap_item(port):
    leader, follower = port
    assert leader["tp"] == WORLD
    kind, msg = leader["upgrade"]
    assert kind == "refused"
    assert "A11 step 3d" in msg and "ROADMAP.md" in msg
    # refused before it touched the fleet: no replacement was admitted
    assert leader["workers"] == ["engine0"]
    # the group served, and its follower returned when the worker closed
    assert follower["followed"] > 0


def test_port_tokens_before_the_upgrade_equal_jax_s(port, jax_side):
    assert port[0]["tokens"] == jax_side["before"]
