"""One rank of the port's in-process serving fleets at TP > 1, for
tests/test_torch_fleet_tp.py.

Run as ``python tests/_torch_fleet_tp_worker.py fleet RANK WORLD STORE_FILE
OUT_DIR``.  Joins a gloo group through a ``FileStore``, reads
``OUT_DIR/inputs.pkl`` (JAX's global params and the cases' prompts), and on
a ``('model',)`` mesh of the world runs every case of :func:`fleet_results`:
model rank 0 hosts the fleet and drives it, the other ranks build the same
fleet and follow its plan.  Pickles what this rank got to
``OUT_DIR/rank<r>.pkl``.  Imports no JAX.
"""

import pickle
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from chainermn_tpu_torch.ops import collective as col
from chainermn_tpu_torch.topology import init_distributed, make_nd_mesh

AX = "model"


def _local(mesh, host):
    from chainermn_tpu_torch.convert import shard_from_jax
    from chainermn_tpu_torch.parallel import transformer_lm_specs

    return shard_from_jax(host, transformer_lm_specs(host, AX), mesh,
                          device="cpu")


def _drained(fleet):
    """Every allocator of the leader's fleet back to all-free."""
    pools = ([pw.pool for pw in fleet.prefill_workers]
             + [dw.engine.pool for dw in fleet.decode_workers])
    for pool in pools:
        pool.allocator.check_invariants()
    return all(p.allocator.busy_count == 0
               and p.allocator.reserved_count == 0 for p in pools) \
        and not any(dw.inbox for dw in fleet.decode_workers)


def _submit(service, prompt, max_new, sample=None, **kw):
    if sample is not None:
        kw.update(temperature=sample[0], rng=sample[1])
    return service.submit(prompt, max_new, **kw)


def disagg_case(mesh, case, out_dir):
    """One role-split fleet, driven as JAX's test drives it: staggered
    submits (a fleet round after every ``stagger``-th), then ``run``."""
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.communicators.base import (
        set_lane_fault_injector)
    from chainermn_tpu_torch.serving import build_disagg_fleet
    from chainermn_tpu_torch.serving.transfer import LANE_AXIS, LANE_OP

    kw = dict(case["kw"])
    if case.get("chaos"):
        kw["bundle_dir"] = str(Path(out_dir) / f"bundles{dist.get_rank()}")
    fleet = build_disagg_fleet(_local(mesh, case["params"]),
                               case["p"], case["d"], mesh=mesh,
                               device="cpu", **kw)
    if not fleet.leader:
        return ("followed", fleet.follow())
    fired = {"n": 0}
    if case.get("chaos"):
        def injector(lane, attempt):
            if lane.startswith("kv_transfer/put/") and fired["n"] < 1:
                fired["n"] += 1
                raise RuntimeError("injected permanent lane fault (chaos)")
        set_lane_fault_injector(injector)
    if case.get("ledger"):
        obs.reset_all()
        obs.enable()
    try:
        handles = []
        for i, prompt in enumerate(case["prompts"]):
            handles.append(_submit(fleet, prompt, case["max_new"][i],
                                   case["sample"][i]))
            if case["stagger"] and i % case["stagger"] == case["stagger"] - 1:
                fleet.step()
        fleet.run(steps_budget=case["budget"])
        m = fleet.metrics()
        res = {"results": [(h.status, h.finish_reason, h.tokens)
                           for h in handles],
               "transfers": m["disagg/transfers_total"],
               "requeued": m["disagg/requeued_total"],
               "dead": [w.dead for w in fleet.prefill_workers],
               "drained": _drained(fleet),
               "bytes_moved": fleet.plane.bytes_moved,
               "prefill_calls": [pw.engine.prefill_calls
                                 for pw in fleet.prefill_workers],
               "decode_prefills": [dw.engine.engine.prefill_calls
                                   for dw in fleet.decode_workers]}
        if case.get("ledger"):
            row = obs.comm_report()["per_op"][f"{LANE_OP}@{LANE_AXIS}"]
            res["ledger"] = (row["bytes"], row["calls"])
        if case.get("chaos"):
            bdir = Path(kw["bundle_dir"])
            dirs = sorted(p.name for p in bdir.iterdir())
            res["bundles"] = dirs
            res["ring"] = (bdir / dirs[-1] / "flight.jsonl").read_text()
    finally:
        set_lane_fault_injector(None)
        if case.get("ledger"):
            obs.disable()
            obs.reset_all()
        fleet.close()
    return res


def replicas_case(mesh, case):
    """``build_fleet(2)``: four submits, two router rounds, four more,
    then ``run`` to idle (JAX's test drives its router the same way)."""
    from chainermn_tpu_torch.serving import build_fleet

    router = build_fleet(_local(mesh, case["params"]), case["n"], mesh=mesh,
                         device="cpu", **case["kw"])
    if not router.leader:
        return ("followed", router.follow())
    try:
        hs = [_submit(router, case["prompts"][i], case["max_new"][i],
                      case["sample"][i]) for i in range(4)]
        for _ in range(2):
            router.step()
        hs += [_submit(router, case["prompts"][i], case["max_new"][i],
                       case["sample"][i])
               for i in range(4, len(case["prompts"]))]
        router.run(steps_budget=400)
        return {"results": [(h.status, h.finish_reason, h.tokens)
                            for h in hs],
                "dispatched_by": dict(router._dispatched_by)}
    finally:
        router.close()


def threads_case(mesh, case):
    """Both fleets under ``start()``: the role threads (disagg) and the
    replica threads each announce and run their own device calls; the
    plan's lock keeps every rank's collectives in one order."""
    from chainermn_tpu_torch.serving import build_disagg_fleet, build_fleet

    local = _local(mesh, case["params"])
    out = {}
    for kind in ("disagg", "replicas"):
        if kind == "disagg":
            svc = build_disagg_fleet(local, 1, 1, mesh=mesh, device="cpu",
                                     **case["disagg_kw"])
        else:
            svc = build_fleet(local, 2, mesh=mesh, device="cpu",
                              **case["replica_kw"])
        if not svc.leader:
            out[kind] = ("followed", svc.follow())
            continue
        try:
            svc.start()
            hs = [_submit(svc, p, case["max_new"]) for p in case["prompts"]]
            t_end = time.monotonic() + 120
            while time.monotonic() < t_end and any(
                    h.status not in ("done", "evicted") for h in hs):
                time.sleep(0.01)
            svc.stop()
            out[kind] = [(h.status, h.tokens) for h in hs]
        finally:
            svc.close()
    return out


def leader_raises_case(mesh, case):
    """The leader's loop raises between two rounds (a token callback fails
    on its third token) and closes in ``finally``: the follower returns
    from the fleet's ``follow()``, and both ranks meet in the next
    collective."""
    from chainermn_tpu_torch.serving import build_disagg_fleet

    fleet = build_disagg_fleet(_local(mesh, case["params"]), 1, 1,
                               mesh=mesh, device="cpu", **case["disagg_kw"])
    if fleet.leader:
        seen = []

        def on_token(tok, rid):
            seen.append(tok)
            if len(seen) == 3:
                raise RuntimeError("on_token failed")

        try:
            fleet.submit(case["prompts"][0], 8, on_token=on_token)
            fleet.run(steps_budget=50)
            res = ("returned",)
        except RuntimeError as e:
            res = ("raised", str(e))
        finally:
            fleet.close()
    else:
        res = ("followed", fleet.follow())
        fleet.close()            # a follower's close releases nobody
    return res + (float(col.psum(torch.ones(()), mesh.axis(AX))),)


def spill_pull_case(mesh, case):
    """A worker group's spilled prefix served to a pull: the leader's
    engine (prefix cache and spill tier on) serves a prompt, evicts the
    donated prefix into the spill tier (every rank its own columns) and
    packs it with ``pack_spilled``: the rows of the global slab it returns
    (the ranks' columns gathered)."""
    from chainermn_tpu_torch.serving import ServingEngine
    from chainermn_tpu_torch.serving.transfer import KvTransferPlane

    eng = ServingEngine(_local(mesh, case["params"]), mesh=mesh,
                        device="cpu", spill_bytes=1 << 20,
                        **case["replica_kw"])
    if not eng.engine.leader:
        return ("followed", eng.follow())
    try:
        h = eng.submit(case["prompts"][0], case["max_new"])
        eng.run()
        seq = list(eng.prefix_cache.entries()[0].seq)
        eng.prefix_cache.evict_lru()
        payload = eng.engine.pack_spilled(KvTransferPlane(),
                                          eng.spill.covering(seq))
        data = KvTransferPlane.open_payload(
            payload, eng.pool.n_layers, eng.pool.kv_dim * mesh.shape[AX],
            eng.pool.max_total)
    finally:
        eng.close()
    return {"tokens": h.tokens, "seq": seq, "length": int(data["pos"]),
            "rows": [[a.copy() for a in kv] for kv in data["rows"]]}


def fleet_results(world, inputs, out_dir):
    mesh = make_nd_mesh((AX,), (world,))
    out = {}
    for name, case in inputs["disagg"].items():
        out[name] = disagg_case(mesh, case, out_dir)
    for name, case in inputs["replicas"].items():
        out[name] = replicas_case(mesh, case)
    out["threads"] = threads_case(mesh, inputs["threads"])
    out["leader_raises"] = leader_raises_case(mesh, inputs["threads"])
    out["spill_pull"] = spill_pull_case(mesh, inputs["threads"])
    return out


def main(suite, rank, world, store_file, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    init_distributed("cpu", timeout_s=120, store=store, rank=rank,
                     world_size=world)
    with open(Path(out_dir) / "inputs.pkl", "rb") as fh:
        inputs = pickle.load(fh)
    out = {"fleet": lambda: fleet_results(world, inputs, out_dir)}[suite]()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
