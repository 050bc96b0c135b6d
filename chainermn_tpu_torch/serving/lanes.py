"""The directory-backed object lane and the non-blocking lane read.

Counterpart of the part of ``chainermn_tpu/serving/lanes.py`` that
training robustness needs: :class:`FileLaneStore` (the ``put(tag, bytes)``
/ ``get(tag, timeout_s)`` / ``delete(tag)`` face over a shared
directory, usable by unrelated processes: atomic tmp-then-rename
publishes, so a reader sees a payload completely or not at all) and
:func:`lane_try_get`.  The self-healing gang polls its leases through
them.  The mailboxes above the store, and the fleet that uses them, are
ROADMAP.md's A11.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional


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
