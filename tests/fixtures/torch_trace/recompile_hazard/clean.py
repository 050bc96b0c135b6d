"""CLEAN entry point: the varying quantity is a TENSOR input — one program
serves every call (and the static config is hashable)."""
from chainermn_tpu_torch.analysis.trace_engine import EntryPoint


def _build(device="cuda", size="tiny"):
    import torch

    from chainermn_tpu_torch.ops import cache_append

    kc = torch.zeros(1, 8, 4, device=device)
    vc = torch.zeros(1, 8, 4, device=device)
    new = torch.ones(1, 1, 4, device=device)

    def write(at):
        return cache_append(kc, vc, new, new, at)

    def pos(p):
        return torch.tensor([p], dtype=torch.int32, device=device)

    return {"trace": (write, (pos(1),)),
            "bound_axes": set(),
            "variants": (write, [(pos(1),), (pos(2),)]),
            "static_values": [("adam", 0.1)]}   # tuple: hashable


ENTRYPOINT = EntryPoint(name="fixture.recompile.clean", build=_build)
