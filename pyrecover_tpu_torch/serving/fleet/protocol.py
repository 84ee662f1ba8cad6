"""Newline-delimited-JSON socket framing for the serving fleet (the JAX
package's ``serving/fleet/protocol.py``, pure stdlib; the two packages'
ends speak to each other).

The front door and each replica exchange one JSON object per line over a
plain TCP socket, with no collective in the way, so a replica death is an
EOF: an ordinary, observable event. One :class:`Connection` wraps one
socket end:

  * **sends** are whole-line atomic under a per-connection lock, so
    concurrent senders (the router's dispatch path and its RPC path) never
    interleave bytes;
  * **receives** run on a dedicated reader thread that parses each line and
    hands the dict to the caller's handler; a torn or non-JSON line is
    skipped (the peer died mid-write; the message it carried is recovered
    by the router's redrive, never by re-parsing);
  * **EOF / socket errors** fire ``on_eof`` exactly once unless the close
    was local: the router's replica-death signal.

Message schema (informal; values are JSON scalars/arrays):

  router -> replica
    {"type": "submit", "rid", "prompt", "max_new_tokens" [, "trace"]}
    {"type": "probe", "seed"}
    {"type": "swap", "manifest"}
    {"type": "status"}
    {"type": "shutdown"}
  replica -> router
    {"type": "done", "rid", "tokens" [, "trace"]}
    {"type": "probe_result", "tokens", "e2e_s"}
    {"type": "swap_result", "ok", "step", "reason"}
    {"type": "status_result", "pending", "completed", "loaded_step",
     "rejected"}

A peer ignores fields it does not know: the port's replica adds ``seed``
to ``probe_result`` (the probe it served) and ``peak_mem_bytes`` to
``status_result``.

The optional ``trace`` field is the distributed-trace context envelope
(:mod:`pyrecover_tpu_torch.telemetry.tracing`): ``{"trace": <16-hex id>,
"span": <attempt span id>, "attempt": <1-based dispatch attempt>}``. The
router stamps it onto ``submit`` at dispatch, the replica installs it around
the engine submission and echoes it on ``done``; absent or malformed
context decodes to None. Both ends also emit ``fleet_send`` /
``fleet_recv`` markers at the socket edge: the anchor pairs trace assembly
aligns different process clocks with.
"""

import json
import socket
import threading


class ProtocolError(RuntimeError):
    """A frame violated the fleet wire schema."""


class Connection:
    """One NDJSON peer link: locked whole-line sends, a reader thread
    dispatching inbound messages, bounded close."""

    def __init__(self, sock, handler, *, name="peer", on_eof=None):
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._send_lock = threading.Lock()
        self._handler = handler
        self._on_eof = on_eof
        self._name = name
        self._closing = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, name=f"fleet-conn-{name}",
                                        daemon=True)
        self._reader.start()

    def send(self, msg):
        """Send one message as a single line. Raises OSError when the peer
        is gone; callers treat that as a disconnect."""
        data = (json.dumps(msg) + "\n").encode()
        with self._send_lock:
            self._sock.sendall(data)

    def _read_loop(self):
        try:
            for line in self._rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue  # torn tail from a peer killed mid-write
                if not isinstance(msg, dict):
                    continue
                self._handler(msg, self)
        except (OSError, ValueError):
            pass  # socket torn down under the reader: same as EOF
        finally:
            # a locally-initiated close is not a peer death
            if not self._closing.is_set() and self._on_eof is not None:
                self._on_eof(self)

    def close(self, timeout=10.0):
        """Tear down the socket and join the reader (bounded). Safe to call
        from the reader thread itself (disconnect callbacks)."""
        self._closing.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._rfile.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._reader is not threading.current_thread():
            self._reader.join(timeout)
            if self._reader.is_alive():
                raise TimeoutError(
                    f"fleet connection reader {self._name!r} did not exit within {timeout}s")


def connect(host, port, *, timeout_s=10.0):
    """Dial a replica's fleet port; returns the connected socket, blocking.
    ``timeout_s`` bounds the dial only: the JAX package's ``connect`` leaves
    it on the socket, where it becomes a read timeout, so a link idle for
    ``timeout_s`` reads as a dead replica (``ROADMAP.md``, Queue 3)."""
    sock = socket.create_connection((host, port), timeout=timeout_s)
    sock.settimeout(None)
    return sock
