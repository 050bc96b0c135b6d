"""BAD entry point: the body reduces over axis 'mn' but the mesh binding
only provides 'model' — the gang would never agree on the collective (the
port's psum on an unbound name falls back to the world; the engine sees
the axis escape the binding)."""
from chainermn_tpu_torch.analysis.trace_engine import EntryPoint


def _build(device="cuda", size="tiny"):
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch.ops import collective as C
    from chainermn_tpu_torch.topology import init_distributed, make_nd_mesh

    created = not dist.is_initialized()
    if created:
        init_distributed(device)
    mesh = make_nd_mesh(("model",), (1,))

    def body(x):
        with mesh:
            return C.psum(x, "mn")       # axis absent from the mesh

    def teardown():
        if created:
            dist.destroy_process_group()

    return {"trace": (body, (torch.ones(2, device=device),)),
            "bound_axes": {"model"}, "teardown": teardown}


ENTRYPOINT = EntryPoint(name="fixture.unbound_axis.bad", build=_build)
