"""BAD entry point: the build itself raises — the engine must report it
as a finding (exit 1), never crash the lint run (the 0/1/2 contract)."""
from chainermn_tpu_torch.analysis.trace_engine import EntryPoint


def _build(device="cuda", size="tiny"):
    raise RuntimeError("fixture: registered program no longer constructs")


ENTRYPOINT = EntryPoint(name="fixture.entrypoint_error.bad", build=_build)
