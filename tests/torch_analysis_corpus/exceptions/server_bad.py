# corpus-rules: exceptions
"""Seeded SIGTERM fault: the signal handler starts a thread whose
target is shutdown() itself, so an exception in the drain kills the
thread silently with the listener half down.  Negative: the wrapper
that logs, as the port's server now routes it."""

import logging
import signal
import threading

_log = logging.getLogger("corpus")


class CaptionServer:
    def serve_forever(self):
        signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
            target=self.shutdown, daemon=True).start())

    def serve_forever_wrapped(self):
        signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
            target=self._signal_shutdown, daemon=True).start())

    def _signal_shutdown(self):
        try:
            self.shutdown()
        except Exception:
            _log.exception("SIGTERM shutdown failed")

    def shutdown(self):  # expect: CST-EXC-002
        self._closed = True
        self._drain()

    def _drain(self):
        return None
