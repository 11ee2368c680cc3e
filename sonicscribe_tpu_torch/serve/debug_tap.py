"""Debug audio tap: archives raw inbound WS audio for offline debugging.

The port's copy of the JAX package's ``serve/debug_tap.py`` (the
reference's DebugAudioManager, backend/debug.py:14-71): when enabled, each session's raw PCM is
written to `{base_dir}/{session_time}/{client_id}.wav` (16 kHz / 16-bit /
mono); empty files and empty session dirs are removed on cleanup.

Implementation difference: writes append to an in-memory spool and flush on a
size threshold so the asyncio ingest path never blocks on disk I/O.
"""

from __future__ import annotations

import logging
import os
import struct
import time
from typing import Optional

logger = logging.getLogger(__name__)

_FLUSH_BYTES = 256 * 1024


class DebugAudioTap:
    def __init__(self, base_dir: str, client_id: str, sample_rate: int = 16000):
        self.sample_rate = sample_rate
        session_dir = os.path.join(
            base_dir, time.strftime("%Y%m%d_%H%M%S", time.localtime())
        )
        os.makedirs(session_dir, exist_ok=True)
        self.path = os.path.join(session_dir, f"{client_id}.wav")
        self._spool = bytearray()
        self._file: Optional[object] = None
        self._data_bytes = 0

    def _open(self):
        self._file = open(self.path, "wb")
        self._write_header(0)

    def _write_header(self, data_len: int) -> None:
        f = self._file
        f.seek(0)
        f.write(b"RIFF" + struct.pack("<I", 36 + data_len) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, self.sample_rate,
                                      self.sample_rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", data_len))

    def write(self, pcm: bytes) -> None:
        self._spool.extend(pcm)
        if len(self._spool) >= _FLUSH_BYTES:
            self.flush()

    def flush(self) -> None:
        if not self._spool:
            return
        try:
            if self._file is None:
                self._open()
            self._file.seek(44 + self._data_bytes)
            self._file.write(self._spool)
            self._data_bytes += len(self._spool)
            self._write_header(self._data_bytes)
            self._spool.clear()
        except OSError:
            logger.exception("debug tap write failed: %s", self.path)

    def close(self) -> None:
        """Flush; delete the file if empty, and the session dir if empty
        (reference backend/debug.py:56-71)."""
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None
        try:
            if self._data_bytes == 0 and os.path.exists(self.path):
                os.remove(self.path)
            parent = os.path.dirname(self.path)
            if os.path.isdir(parent) and not os.listdir(parent):
                os.rmdir(parent)
        except OSError:
            pass
