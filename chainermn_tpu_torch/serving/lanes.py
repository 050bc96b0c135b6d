"""Cross-process object lanes and mailboxes for the serving fleet.

Counterpart of ``chainermn_tpu/serving/lanes.py``.  :class:`FileLaneStore`
is the elastic wire: the ``put(tag, bytes)`` / ``get(tag, timeout_s)`` /
``delete(tag)`` face over a shared directory, usable by unrelated
processes (atomic tmp-then-rename publishes, so a reader sees a payload
completely or not at all).  The self-healing gang polls its leases
through it and :func:`lane_try_get`; the serving fleet's worker processes
speak to their router over it.

On top of any lane store, :class:`MailboxSender` / :class:`MailboxReceiver`
make an ordered, at-most-once message channel.  Every mailbox has exactly
one writer object (the router writes each worker's control inbox, each
worker its own outbox), so a sender-side sequence counter and a
receiver-side cursor give a total order without collectives; the sender
serialises its own threads (router client threads and the supervisor share
one control-mailbox sender) under a lock.  Messages are pickled dicts
stamped with ``MSG_SCHEMA``: a receiver refuses a payload it cannot
interpret.  Every store operation goes through
:func:`~chainermn_tpu_torch.communicators.base.lane_call`, so retries,
back-off and fault injection follow the lanes' discipline, and a permanent
fault raises ``DcnLaneError`` naming ``worker_lane/<mailbox>/<op>``.  With
the causal journal on, each send and receive is journaled and the send's
HLC stamp rides in the message (``observability/journal.py``).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
import time
from typing import Any, Dict, Optional

#: Wire schema of one mailbox message (the JAX package's: both speak it).
MSG_SCHEMA = "chainermn_tpu.worker_lane.v1"


def _safe_tag(tag: str) -> str:
    """Filesystem-safe injective encoding of a lane tag (tags use '/' and
    '.').  ASCII alphanumerics and '-.' pass verbatim; everything else,
    '_' (the escape lead) and non-ASCII included, becomes fixed-width
    per-UTF-8-byte '_XX' escapes, so two distinct tags never share one
    lane file."""
    return "".join(
        c if (c.isascii() and c.isalnum()) or c in "-." else
        "".join(f"_{b:02x}" for b in c.encode("utf-8"))
        for c in str(tag))


def _unsafe_tag(name: str) -> str:
    """Inverse of :func:`_safe_tag`: a lane file name back into its tag.
    A malformed name (a torn tmp file, foreign debris) raises
    ``ValueError``."""
    out = bytearray()
    i, n = 0, len(name)
    while i < n:
        c = name[i]
        if c == "_":
            if i + 3 > n:
                raise ValueError(f"truncated escape in lane name {name!r}")
            out.extend(bytes([int(name[i + 1:i + 3], 16)]))
            i += 3
        else:
            out.extend(c.encode("utf-8"))
            i += 1
    return out.decode("utf-8")


class FileLaneStore:
    """Directory-backed object lane: the cross-process transport for gangs
    or fleets of unrelated processes (no fixed-size group, no
    coordinator).

    ``put`` is atomic (tmp file + ``os.replace`` in one directory), so a
    concurrent ``get`` never reads a torn payload.  ``get`` polls every
    ``poll_s`` until the tag appears or ``timeout_s`` passes; its
    ``TimeoutError`` text matches the lanes' transient fingerprints
    ("deadline exceeded"), so a ``lane_call``-wrapped get retries under
    the standard backoff before dying loudly.
    """

    def __init__(self, root: str, poll_s: float = 0.005):
        self.root = str(root)
        self.poll_s = float(poll_s)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.root, _safe_tag(tag))

    def put(self, tag: str, payload: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(bytes(payload))
            os.replace(tmp, self._path(tag))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, tag: str, timeout_s: float = 10.0) -> bytes:
        deadline = time.monotonic() + float(timeout_s)
        path = self._path(tag)
        while True:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                pass
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"lane tag {tag!r} not published within {timeout_s}s "
                    f"(deadline exceeded)")
            time.sleep(self.poll_s)

    def delete(self, tag: str) -> None:
        try:
            os.unlink(self._path(tag))
        except FileNotFoundError:
            pass

    def tags(self):
        """Every tag published now (tmp files and undecodable debris
        skipped)."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if name.startswith(".tmp-"):
                continue
            try:
                out.append(_unsafe_tag(name))
            except (ValueError, UnicodeDecodeError):
                continue
        return out


def lane_try_get(store, lane: str, tag: str,
                 config=None) -> Optional[bytes]:
    """Non-blocking lane read under the hardened discipline: the payload,
    or None when the tag is absent (an empty lane is not a fault).  Real
    store faults still classify, retry and raise through
    :func:`~chainermn_tpu_torch.communicators.base.lane_call` with the
    lane named."""
    from ..communicators.base import lane_call

    def _try():
        try:
            return store.get(tag, timeout_s=0.0)
        except (TimeoutError, KeyError):
            return None

    return lane_call(lane, _try, config)


def _msg_journal_fields(msg: Dict[str, Any]) -> Dict[str, Any]:
    """The identity fields a journaled mailbox event carries: enough to
    thread one request's causal story across processes (trace id, the
    worker and epoch the protocol stamps) without copying payloads."""
    out: Dict[str, Any] = {}
    trace_id = msg.get("trace_id")
    if trace_id is None and isinstance(msg.get("req"), dict):
        trace_id = msg["req"].get("trace_id")
    if trace_id is not None:
        out["trace_id"] = trace_id
    for k in ("worker", "epoch"):
        if msg.get(k) is not None:
            out[k] = msg[k]
    return out


class MailboxSender:
    """The single writer of one named mailbox (ordered, at-most-once).

    ``seq`` persists only in this sender — the single-writer contract
    makes it the mailbox's total order.  "Single writer" means one
    SENDER OBJECT, not one thread: the router's control mailboxes are
    written from client threads (submit) and the supervisor thread
    (failover, drain) through the same sender, so :meth:`send` holds a
    lock across the seq read, the put, and the increment — two
    concurrent sends minting the same seq would have the second put
    silently overwrite the first message.  A re-created sender for a
    live mailbox (e.g. a restarted router) must pass the old cursor via
    ``start_seq`` or use a fresh mailbox name (a new worker epoch gets
    a new mailbox in the fleet wiring, which is what fencing wants
    anyway: a zombie's stale mailbox is simply never read again).
    """

    def __init__(self, store, name: str, config=None, start_seq: int = 0):
        self.store = store
        self.name = str(name)
        self.config = config
        self.seq = int(start_seq)
        self._lock = threading.Lock()

    def send(self, msg: Dict[str, Any]) -> int:
        """Publish one message; returns its sequence number.
        Thread-safe: concurrent sends serialize and get distinct seqs."""
        from ..communicators.base import lane_call
        from ..observability import journal as _journal

        with self._lock:
            seq = self.seq
            wire = dict(msg, schema=MSG_SCHEMA, seq=seq)
            if _journal.enabled():
                # the HLC rides as one extra field in the worker_lane.v1
                # dict: the stamp is the journaled send event's own, so
                # the receiver's merge orders the receive strictly after
                # this line in the fleet timeline
                wire["hlc"] = _journal.wire_emit(
                    "mbx_send", mailbox=self.name, mseq=seq,
                    msg_kind=msg.get("kind"),
                    **_msg_journal_fields(msg))
            payload = pickle.dumps(wire,
                                   protocol=pickle.HIGHEST_PROTOCOL)
            tag = f"mbx/{self.name}/{seq}"
            lane_call(f"worker_lane/{self.name}/send",
                      lambda: self.store.put(tag, payload), self.config)
            self.seq = seq + 1
        return seq


class MailboxReceiver:
    """The single reader of one named mailbox: consumes messages in
    sequence order, deleting each behind the cursor (at-most-once)."""

    def __init__(self, store, name: str, config=None):
        self.store = store
        self.name = str(name)
        self.config = config
        self.next_seq = 0

    def recv(self) -> Optional[Dict[str, Any]]:
        """Next message, or None when the mailbox is empty."""
        tag = f"mbx/{self.name}/{self.next_seq}"
        payload = lane_try_get(self.store,
                               f"worker_lane/{self.name}/recv", tag,
                               self.config)
        if payload is None:
            return None
        msg = pickle.loads(payload)
        if msg.get("schema") != MSG_SCHEMA:
            raise ValueError(
                f"refusing worker-lane message with schema "
                f"{msg.get('schema')!r} on mailbox {self.name!r} "
                f"(this receiver speaks {MSG_SCHEMA})")
        from ..observability import journal as _journal
        if _journal.enabled():
            # merge the sender's HLC so cross-process causality is
            # captured on the existing wire (send happens-before recv)
            _journal.recv_emit(
                msg.get("hlc"), "mbx_recv", mailbox=self.name,
                mseq=self.next_seq, msg_kind=msg.get("kind"),
                **_msg_journal_fields(msg))
        from ..communicators.base import lane_call
        lane_call(f"worker_lane/{self.name}/gc",
                  lambda: self.store.delete(tag), self.config)
        self.next_seq += 1
        return msg

    def drain(self, limit: int = 256):
        """Every pending message up to ``limit`` (bounded so a flooding
        peer cannot wedge the caller's loop)."""
        out = []
        for _ in range(int(limit)):
            msg = self.recv()
            if msg is None:
                break
            out.append(msg)
        return out
