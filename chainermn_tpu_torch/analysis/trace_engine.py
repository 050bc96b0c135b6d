"""Trace engine — run registered entry points, check what the card runs.

Counterpart of ``chainermn_tpu/analysis/jaxpr_engine.py``.  The AST
engine reads source; this engine reads the *program*.  Eager torch has no
jaxpr, so each registered entry point (``entrypoints.py``) is RUN once,
on the card unless the caller passes the CPU, inside two recording
brackets, and yields:

* **the collective sequence:** the ordered ``(primitive, axes)`` of every
  outermost collective the entry runs through the port's accounted face
  (``observability.comm.collective`` / ``accounted_method``: every
  in-step collective of ``ops.collective`` and every communicator
  method), recorded by :func:`~chainermn_tpu_torch.observability.comm.record_collectives`
  whether tracing is on or off.  A booked op is named by the primitive
  JAX's program holds for it (``shift`` → ``ppermute``, ``pmean`` →
  ``psum``, ``reduce_scatter`` → ``reduce_scatter``), so the sequence
  reads as JAX's does.  What the port books is what it runs: a
  collective the port elides (the tensor-parallel layers skip an axis of
  size 1) is not in its sequence, and one it runs where JAX's program
  holds none (JAX drops a ``psum`` of a value already invariant over the
  axis) is;
* **unbound-axis** (error): a collective runs over an axis outside the
  entry point's declared binding, or the port's axis lookup raises
  (``NameError: unbound axis name``, as JAX's tracer does);
* **recompile-hazard** (warning): eager torch compiles nothing per call,
  so a "program" is the ordered tuple of call signatures one call of the
  entry makes at the kernel-dispatch layer (``ops/_dispatch.py``: each
  kernel wrapper's name, input shapes and dtypes, static arguments).
  More than one program across the registered call variants is the
  hazard, unless the entry point registers ``allow_recompile=True`` (the
  per-prompt-length prefill family, whose size the serving engine
  counts as ``prefill_compiles``).  A declared static value that is
  unhashable is a hazard too, as in JAX;
* **entrypoint-error** (error): the entry failed to build, run or
  execute a variant — reported, never a crash of the lint run.

The report also carries the kernel launches the entry made (on the card;
the plain versions launch nothing) and how many times it ran.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding

TRACE_RULES: Dict[str, Tuple[str, str]] = {
    "unbound-axis": (
        "error", "collective names an axis absent from the mesh binding"),
    "recompile-hazard": (
        "warning", "entry point recompiles across registered call variants"),
    "entrypoint-error": (
        "error", "registered entry point failed to build/trace/execute"),
}

#: JAX's name for the catalog.
JAXPR_RULES = TRACE_RULES

#: ledger op -> the primitive JAX's program holds for it, as its jaxpr
#: names it (``psum_scatter``'s primitive is ``reduce_scatter`` there).
_JAXPR_NAMES = {"psum_scatter": "reduce_scatter"}


def _primitive_of(op: str) -> str:
    from ..ops.collective import LEDGER_TO_PRIMITIVE

    prim = LEDGER_TO_PRIMITIVE.get(op)
    if prim is None:
        return op
    return _JAXPR_NAMES.get(prim, prim)


def _axes(axis) -> Tuple[str, ...]:
    if isinstance(axis, (tuple, list)):
        return tuple(str(a) for a in axis)
    return (str(axis),)


@dataclass
class EntryPoint:
    """One program the analyzer owns end to end.

    ``build(device=..., size=...)`` runs lazily and returns a dict with:

    * ``trace``: ``(fn, args)`` — run once under the recording brackets;
    * ``bound_axes``: set of mesh axis names the binding declares;
    * ``variants`` (optional): ``(fn, [args, ...])`` — every args tuple
      is CALLED on ``fn`` and the distinct programs counted;
    * ``static_values`` (optional): values declared static somewhere in
      the program — probed for hashability;
    * ``teardown`` (optional): called once the checks are done (a
      one-rank process group the build created is destroyed there).

    The shard-flow keys (JAX's ``data_axis``, ``arg_labels``,
    ``expected_replication``, ``noted``, ``composite``, and the port's
    ``in_specs`` and ``shardflow_args``) are read by the shard-flow
    analyzer (``shardflow.py``); this engine does not read them.
    """

    name: str
    build: Callable[..., Dict[str, Any]]
    allow_recompile: bool = False
    description: str = ""
    #: False skips the shard-flow pass (for tee variants whose program an
    #: earlier entry already analyzes).
    shardflow: bool = True


@dataclass
class TraceReport:
    """What the engine learned about one entry point (returned alongside
    findings so callers can print the collective surface)."""

    name: str
    collectives: List[Tuple[str, Tuple[str, ...]]] = field(
        default_factory=list)  # (primitive, axis names) in run order
    n_compiles: Optional[int] = None
    error: Optional[str] = None
    #: kernel launches during the checks, {kernel: n} (non-zero only)
    launches: Dict[str, int] = field(default_factory=dict)
    #: calls of the entry's functions: the trace call and the variants
    calls: int = 0
    #: the trace call's result, kept when asked (``keep_outputs``)
    outputs: Any = None


def collective_sequence(fn: Callable, *args
                        ) -> List[Tuple[str, Tuple[str, ...]]]:
    """(primitive name, axis names) of every collective ``fn(*args)``
    runs, in order."""
    return _run_recorded(fn, args)[0]


def _run_recorded(fn, args):
    from ..observability.comm import record_collectives

    with record_collectives() as seq:
        out = fn(*args)
    return [(_primitive_of(op), _axes(ax)) for op, ax in seq], out


def _program(fn, args) -> tuple:
    """The ordered dispatch signatures of one call: the port's program."""
    from ..ops._dispatch import record_signatures

    with record_signatures() as sigs:
        fn(*args)
    return tuple(sigs)


def check_entrypoint(ep: EntryPoint, device="cuda", size: str = "tiny",
                     keep_outputs: bool = False
                     ) -> Tuple[List[Finding], TraceReport]:
    """Build ``ep`` on ``device`` at ``size`` (``"tiny"`` / ``"full"``),
    run it and check it."""
    from .. import ops

    findings: List[Finding] = []
    report = TraceReport(name=ep.name)
    loc = f"entrypoint:{ep.name}"
    before = ops.launch_counts()

    def engine_error(stage: str, e: BaseException):
        # a broken entry point is a REPORTED finding, never a crash of
        # the whole lint run (the 0/1/2 exit contract must hold)
        report.error = f"{stage} failed: {type(e).__name__}: {e}"
        findings.append(Finding(
            rule="entrypoint-error", severity="error", path=loc, line=0,
            message=report.error, context=ep.name,
            snippet=ep.description))

    try:
        spec = ep.build(device=device, size=size)
    except Exception as e:  # noqa: BLE001
        engine_error("build", e)
        return findings, report
    try:
        _check_spec(ep, spec, findings, report, loc, engine_error,
                    keep_outputs)
    finally:
        teardown = spec.get("teardown")
        if teardown is not None:
            teardown()
        after = ops.launch_counts()
        report.launches = {k: after[k] - before.get(k, 0) for k in after
                           if after[k] - before.get(k, 0)}
    return findings, report


def _check_spec(ep, spec, findings, report, loc, engine_error,
                keep_outputs) -> None:
    fn, args = spec["trace"]
    bound: Set[str] = set(spec.get("bound_axes", ()))

    # ---- axis binding: run, then walk the recorded collectives ----
    try:
        report.calls += 1
        report.collectives, out = _run_recorded(fn, args)
    except NameError as e:
        # the port's axis lookup raises NameError("unbound axis name ...")
        findings.append(Finding(
            rule="unbound-axis", severity="error", path=loc, line=0,
            message=(f"running failed: {e} — the body names a mesh axis "
                     f"the enclosing binding ({sorted(bound)}) does not "
                     "provide; the gang would never agree on this "
                     "collective"),
            context=ep.name, snippet=ep.description))
        report.error = str(e)
        return
    except Exception as e:  # noqa: BLE001
        engine_error("trace", e)
        return
    if keep_outputs:
        report.outputs = out
    for prim, axes in report.collectives:
        stray = [a for a in axes if a not in bound]
        if stray:
            findings.append(Finding(
                rule="unbound-axis", severity="error", path=loc, line=0,
                message=(f"collective `{prim}` runs over axis "
                         f"{stray} but the declared mesh binding is "
                         f"{sorted(bound)}"),
                context=ep.name, snippet=ep.description))

    # ---- recompilation: count distinct programs across variants ----
    variants = spec.get("variants")
    if variants is not None:
        vfn, arg_sets = variants
        try:
            programs = set()
            for a in arg_sets:
                report.calls += 1
                programs.add(_program(vfn, a))
        except Exception as e:  # noqa: BLE001
            engine_error("variant execution", e)
            return
        n = len(programs)
        report.n_compiles = n
        if n > 1 and not ep.allow_recompile:
            findings.append(Finding(
                rule="recompile-hazard", severity="warning", path=loc,
                line=0,
                message=(f"{n} compiled programs for {len(arg_sets)} call "
                         "variants that should share one — per-call-"
                         "varying shapes or static args at the kernel "
                         "wrappers; hoist the varying piece into tensor "
                         "inputs, or register allow_recompile=True with a "
                         "reason if the program family is intentional "
                         "(per-prompt-length prefill)"),
                context=ep.name, snippet=ep.description))

    # ---- static-arg hashability ----
    for v in spec.get("static_values", ()):
        try:
            hash(v)
        except TypeError:
            findings.append(Finding(
                rule="recompile-hazard", severity="warning", path=loc,
                line=0,
                message=(f"declared static value of type "
                         f"{type(v).__name__} is unhashable — a program "
                         "keyed by it cannot be reused (or, via "
                         "workarounds like str(), is rebuilt per call); "
                         "use a hashable frozen config"),
                context=ep.name, snippet=ep.description))


def check_entrypoints(eps: Optional[Sequence[EntryPoint]] = None,
                      device="cuda", size: str = "tiny"
                      ) -> Tuple[List[Finding], List[TraceReport]]:
    if eps is None:
        from .entrypoints import ENTRYPOINTS
        eps = ENTRYPOINTS
    findings: List[Finding] = []
    reports: List[TraceReport] = []
    for ep in eps:
        f, r = check_entrypoint(ep, device=device, size=size)
        findings.extend(f)
        reports.append(r)
    return findings, reports
