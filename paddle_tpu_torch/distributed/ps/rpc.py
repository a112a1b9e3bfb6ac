"""Length-prefixed RPC of the parameter-server stack (port of
``paddle_tpu/distributed/ps/rpc.py``, the same wire format byte for byte,
so either package's client talks to either's server).

Reference analogue: the brpc transport under
paddle/fluid/distributed/ps/service/ (brpc_ps_server.cc /
brpc_ps_client.cc).  Here: one TCP socket a client; each message is an
8-byte big-endian length, a JSON header, then each array's 8-byte length
and raw bytes in the order of their ``__arr{i}__`` keys.  No pickle: a
peer cannot run code through the decoder.
"""

from __future__ import annotations

import json
import socket
import struct
import threading

import numpy as np

_LEN = struct.Struct("!Q")


def _encode(obj):
    """obj: dict with str/int/float/list leaves; np.ndarray values are
    pulled out into a binary section."""
    arrays = {}

    def strip(o):
        if isinstance(o, np.ndarray):
            key = f"__arr{len(arrays)}__"
            arrays[key] = np.ascontiguousarray(o)
            return {"__array__": key, "dtype": str(o.dtype),
                    "shape": list(o.shape)}
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [strip(v) for v in o]
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        return o

    head = json.dumps(strip(obj)).encode()
    parts = [_LEN.pack(len(head)), head]
    # numeric order — must match _decode's __arr{i}__ read order (lexicographic
    # sort would scramble messages with >10 arrays: '__arr10__' < '__arr1__')
    for i in range(len(arrays)):
        buf = arrays[f"__arr{i}__"].tobytes()
        parts.append(_LEN.pack(len(buf)))
        parts.append(buf)
    return b"".join(parts)


def _read_exact(sock, n):
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("PS peer closed the connection")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _decode(sock):
    head_len = _LEN.unpack(_read_exact(sock, _LEN.size))[0]
    head = json.loads(_read_exact(sock, head_len))

    def count(o):
        if isinstance(o, dict):
            if "__array__" in o:
                return 1
            return sum(count(v) for v in o.values())
        if isinstance(o, list):
            return sum(count(v) for v in o)
        return 0

    n_arrays = count(head)
    bufs = {}
    for i in range(n_arrays):
        blen = _LEN.unpack(_read_exact(sock, _LEN.size))[0]
        bufs[f"__arr{i}__"] = _read_exact(sock, blen)

    def restore(o):
        if isinstance(o, dict):
            if "__array__" in o:
                arr = np.frombuffer(bufs[o["__array__"]],
                                    dtype=np.dtype(o["dtype"]))
                return arr.reshape(o["shape"]).copy()
            return {k: restore(v) for k, v in o.items()}
        if isinstance(o, list):
            return [restore(v) for v in o]
        return o

    return restore(head)


def send_msg(sock, obj):
    sock.sendall(_encode(obj))


def recv_msg(sock):
    return _decode(sock)


class RpcServer:
    """Threaded request/reply loop: handler(dict) -> dict."""

    def __init__(self, host, port, handler):
        self._handler = handler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)

    def start(self):
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn):
        try:
            while not self._stop.is_set():
                try:
                    req = recv_msg(conn)
                except (ConnectionError, OSError):
                    return
                try:
                    resp = self._handler(req)
                except Exception as e:  # surfaced client-side as RuntimeError
                    resp = {"error": f"{type(e).__name__}: {e}"}
                send_msg(conn, resp or {"ok": True})
                if req.get("op") == "stop":
                    self._stop.set()
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def join(self, timeout=None):
        self._accept_thread.join(timeout)


class RpcClient:
    def __init__(self, host, port, timeout=30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._lock = threading.Lock()

    def call(self, **req):
        with self._lock:
            send_msg(self._sock, req)
            resp = recv_msg(self._sock)
        if isinstance(resp, dict) and resp.get("error"):
            raise RuntimeError(f"PS server error: {resp['error']}")
        return resp

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


__all__ = ["RpcClient", "RpcServer", "recv_msg", "send_msg"]
