"""The train CLIs' console, mirrored into ``save_path/out.log`` (port of
``utils/logging_utils.py``).

:class:`TeeLog` swaps ``sys.stdout`` and ``sys.stderr`` for mirrors that
write through to the console and into one log file, opened for appending (a
resumed run extends the transcript). The progress lines repaint themselves
with ``\\r`` many times a step: the console keeps that, the file keeps each
line's final state only. Library logging is not touched; only the process's
console streams are mirrored.
"""
from __future__ import annotations

import sys
from typing import Optional, TextIO


class _MirrorStream:
    """Writes go to the console stream and to the TeeLog's file."""

    def __init__(self, primary: TextIO, sink: "TeeLog"):
        self._primary = primary
        self._sink = sink

    def write(self, data: str) -> int:
        n = self._primary.write(data)
        self._sink._absorb(data)
        return n

    def flush(self) -> None:
        self._primary.flush()
        self._sink._flush_file()

    def isatty(self) -> bool:
        return self._primary.isatty()  # the progress lines repaint on the console

    @property
    def encoding(self):
        return getattr(self._primary, "encoding", "utf-8")


class TeeLog:
    """Mirror ``sys.stdout`` / ``sys.stderr`` into the file ``path``.

    ``install()`` swaps both streams and returns self (a second call does
    nothing); ``uninstall()`` puts them back and closes the file; as a
    context manager it does both. A line repainted with ``\\r`` reaches the
    file in its final state."""

    def __init__(self, path: str):
        self.path = path
        self._file: Optional[TextIO] = None
        self._pending = ""
        self._saved = None

    def _absorb(self, data: str) -> None:
        if self._file is None:
            return
        lines = data.split("\n")
        for i, part in enumerate(lines):
            if "\r" in part:  # the line was repainted: keep what follows the last \r
                self._pending = part.rsplit("\r", 1)[1]
            else:
                self._pending += part
            if i < len(lines) - 1:
                self._file.write(self._pending + "\n")
                self._pending = ""

    def _flush_file(self) -> None:
        if self._file is not None:
            self._file.flush()

    def install(self) -> "TeeLog":
        if self._saved is not None:
            return self
        self._file = open(self.path, "a", buffering=1)
        self._saved = (sys.stdout, sys.stderr)
        sys.stdout = _MirrorStream(self._saved[0], self)
        sys.stderr = _MirrorStream(self._saved[1], self)
        return self

    def uninstall(self) -> None:
        if self._saved is None:
            return
        sys.stdout, sys.stderr = self._saved
        self._saved = None
        if self._pending:
            self._file.write(self._pending + "\n")
            self._pending = ""
        self._file.close()
        self._file = None

    def __enter__(self) -> "TeeLog":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
