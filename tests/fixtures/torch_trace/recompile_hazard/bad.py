"""BAD entry point: a per-call-varying static argument at a kernel wrapper
— the cache write position passed as a Python int makes every call a new
program (the hazard the serving tick avoids by passing positions as a
tensor)."""
from chainermn_tpu_torch.analysis.trace_engine import EntryPoint


def _build(device="cuda", size="tiny"):
    import torch

    from chainermn_tpu_torch.ops import cache_append

    kc = torch.zeros(1, 8, 4, device=device)
    vc = torch.zeros(1, 8, 4, device=device)
    new = torch.ones(1, 1, 4, device=device)

    def write(at):
        return cache_append(kc, vc, new, new, at)

    return {"trace": (write, (1,)),
            "bound_axes": set(),
            # the position varies per call -> one program per value
            "variants": (write, [(1,), (2,), (3,)]),
            "static_values": [{"lr": 0.1}]}   # dict: unhashable static


ENTRYPOINT = EntryPoint(name="fixture.recompile.bad", build=_build)
