"""CLEAN entry point: builds, runs and runs its variants without incident."""
from chainermn_tpu_torch.analysis.trace_engine import EntryPoint


def _build(device="cuda", size="tiny"):
    import torch

    x = torch.ones(2, device=device)

    def fn(v):
        return v * 2

    return {"trace": (fn, (x,)), "bound_axes": set(),
            "variants": (fn, [(x,), (x + 1,)])}


ENTRYPOINT = EntryPoint(name="fixture.entrypoint_error.clean", build=_build)
