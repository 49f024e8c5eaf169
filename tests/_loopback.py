"""An in-process object store and WebHDFS namenode on 127.0.0.1.

One ``ThreadingHTTPServer`` with two faces over one dict of files:

- an object store (the shape of a GCS/S3 HTTP gateway): ranged GET with
  ``Content-Range``, HEAD and PUT at ``/<path>``;
- a WebHDFS namenode at ``/webhdfs/v1/<path>`` (``GETFILESTATUS``,
  ``LISTSTATUS``, ``OPEN`` with offset/length, the two-step ``CREATE``,
  ``DELETE``) that 307-redirects ``OPEN``/``CREATE`` to a datanode face
  on the same authority under ``/dn`` — the client must follow the
  ``Location`` as it would to another host.

Failure knobs on :class:`Store` drive the clients' retry and resume
machinery: ``fail_next`` (answer 500 to that many requests),
``fail_every`` (answer 500 to every n-th request), ``truncate_next``
(send half of that many data bodies, then drop the connection),
``ignore_range``, ``unknown_total`` (``Content-Range: bytes x-y/*``),
``no_head`` (405 on HEAD) and ``no_redirect`` (an HttpFS-style gateway
that answers OPEN/CREATE directly). Used by the port's CPU tests, its
card tests and ``chip_smoke.py``; test scaffolding, not part of either
package.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

WEBHDFS = "/webhdfs/v1"


class Store:
    """Files and failure knobs shared by the test and the handler threads."""

    def __init__(self):
        self.files = {}
        self.fail_next = 0
        self.fail_every = 0
        self.truncate_next = 0
        self.ignore_range = False
        self.unknown_total = False
        self.no_head = False
        self.no_redirect = False
        #: (method, raw request path) of every request, in arrival order
        self.requests = []
        self.bytes_sent = 0
        self._lock = threading.Lock()

    def add_tree(self, directory: str, prefix: str) -> None:
        """Put every file under ``directory`` at ``prefix/<relative path>``."""
        for root, _dirs, names in os.walk(directory):
            for name in names:
                path = os.path.join(root, name)
                rel = os.path.relpath(path, directory).replace(os.sep, "/")
                with open(path, "rb") as f:
                    self.files[f"{prefix.rstrip('/')}/{rel}"] = f.read()

    def _fail(self) -> bool:
        with self._lock:
            n = len(self.requests)
            if self.fail_next > 0:
                self.fail_next -= 1
                return True
            return bool(self.fail_every) and n % self.fail_every == 0

    def _truncate(self) -> bool:
        with self._lock:
            if self.truncate_next > 0:
                self.truncate_next -= 1
                return True
            return False


class Handler(BaseHTTPRequestHandler):
    store: Store
    protocol_version = "HTTP/1.1"  # keep-alive: exercises connection reuse

    def setup(self):
        super().setup()
        # headers and body go out in separate writes: without NODELAY the
        # body waits for the client's delayed ACK of the headers
        self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def log_message(self, *args):
        pass

    def _log(self, method: str) -> None:
        with self.store._lock:
            self.store.requests.append((method, self.path))

    def _send(self, status, body=b"", headers=(), data=False):
        """One response; a data body (``data``) may be cut in half and
        the connection dropped (``truncate_next``)."""
        self.send_response(status)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if not body:
            return
        if data and len(body) > 1 and self.store._truncate():
            self.wfile.write(body[: len(body) // 2])
            self.wfile.flush()
            self.close_connection = True
            self.connection.close()
            return
        self.wfile.write(body)
        with self.store._lock:
            self.store.bytes_sent += len(body)

    def _webhdfs(self):
        """(is datanode, hdfs path, query) of a WebHDFS request, or None
        for an object-store request."""
        parts = urllib.parse.urlsplit(self.path)
        path = parts.path
        is_dn = path.startswith("/dn" + WEBHDFS)
        if is_dn:
            path = path[len("/dn"):]
        if not path.startswith(WEBHDFS):
            return None
        hpath = urllib.parse.unquote(path[len(WEBHDFS):])
        return is_dn, hpath, dict(urllib.parse.parse_qsl(parts.query))

    def _redirect(self):
        self._send(307, headers=[("Location", f"http://{self.headers['Host']}/dn{self.path}")])

    # -- GET ------------------------------------------------------------

    def do_GET(self):
        self._log("GET")
        if self.store._fail():
            self._send(500)
            return
        hdfs = self._webhdfs()
        if hdfs is None:
            self._object_get()
        else:
            self._webhdfs_get(*hdfs)

    def _object_get(self):
        data = self.store.files.get(urllib.parse.unquote(self.path))
        if data is None:
            self._send(404)
            return
        rng = self.headers.get("Range")
        if rng and not self.store.ignore_range:
            start_s, end_s = rng.split("=")[1].split("-")
            start = int(start_s)
            end = min(int(end_s), len(data) - 1) if end_s else len(data) - 1
            if start >= len(data):
                self._send(416, headers=[("Content-Range", f"bytes */{len(data)}")])
                return
            total = "*" if self.store.unknown_total else str(len(data))
            self._send(206, data[start:end + 1],
                       headers=[("Content-Range", f"bytes {start}-{end}/{total}")], data=True)
        else:
            self._send(200, data, data=True)

    def _not_found(self):
        self._send(404, json.dumps(
            {"RemoteException": {"exception": "FileNotFoundException"}}).encode())

    def _webhdfs_get(self, is_dn, hpath, q):
        op = q.get("op")
        data = self.store.files.get(hpath)
        if op == "GETFILESTATUS":
            if data is None:
                self._not_found()
                return
            self._send(200, json.dumps(
                {"FileStatus": {"length": len(data), "type": "FILE"}}).encode())
        elif op == "LISTSTATUS":
            prefix = hpath.rstrip("/") + "/"
            children = sorted({k[len(prefix):].split("/", 1)[0]
                               for k in self.store.files if k.startswith(prefix)})
            if not children and data is None:
                self._not_found()
                return
            self._send(200, json.dumps({"FileStatuses": {"FileStatus": [
                {"pathSuffix": c, "type": "FILE"} for c in children]}}).encode())
        elif op == "OPEN":
            if data is None:
                self._send(404)
            elif not is_dn and not self.store.no_redirect:
                self._redirect()
            else:
                off = int(q.get("offset", 0))
                ln = int(q.get("length", len(data) - off))
                self._send(200, data[off:off + ln], data=True)
        else:
            self._send(400)

    # -- HEAD, PUT, DELETE ------------------------------------------------

    def do_HEAD(self):
        self._log("HEAD")
        if self.store.no_head:
            self._send(405)
            return
        if self.store._fail():
            self._send(500)
            return
        data = self.store.files.get(urllib.parse.unquote(self.path))
        if data is None:
            self._send(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()

    def do_PUT(self):
        self._log("PUT")
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if self.store._fail():
            self._send(503)
            return
        hdfs = self._webhdfs()
        if hdfs is None:
            self.store.files[urllib.parse.unquote(self.path)] = body
            self._send(200)
            return
        is_dn, hpath, q = hdfs
        if q.get("op") != "CREATE":
            self._send(400)
        elif self.store.no_redirect:
            # HttpFS style: the body-less first PUT is accepted, the
            # second carries data=true and the bytes
            if q.get("data") == "true":
                self.store.files[hpath] = body
            self._send(201)
        elif not is_dn:
            self._redirect()
        else:
            self.store.files[hpath] = body
            self._send(201)

    def do_DELETE(self):
        self._log("DELETE")
        if self.store._fail():
            self._send(500)
            return
        hdfs = self._webhdfs()
        if hdfs is None or hdfs[2].get("op") != "DELETE":
            self._send(400)
            return
        prefix = hdfs[1].rstrip("/")
        doomed = [k for k in self.store.files if k == prefix or k.startswith(prefix + "/")]
        for k in doomed:
            del self.store.files[k]
        self._send(200, json.dumps({"boolean": bool(doomed)}).encode())


class Server:
    """A running loopback server: ``base`` (``http://127.0.0.1:<port>``),
    ``authority`` (``127.0.0.1:<port>``) and its :class:`Store`.
    :meth:`reset` gives it a fresh store; :meth:`close` stops it."""

    def __init__(self, handler: type = Handler):
        self.store = Store()
        self._handler = type("LoopbackHandler", (handler,), {"store": self.store})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), self._handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        self.authority = f"127.0.0.1:{self._httpd.server_address[1]}"
        self.base = f"http://{self.authority}"

    def reset(self) -> Store:
        self.store = Store()
        self._handler.store = self.store
        return self.store

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_remote_session(directory: str, n_files: int = 2, n_markers: int = 120) -> str:
    """An ``n_files``-recording synthetic session under ``directory/DoD``
    with an info.txt at ``directory/infoTrain.txt`` that names the
    recordings by relative path (the reference fixture's layout);
    returns the info.txt path."""
    import _synthetic

    sub = os.path.join(directory, "DoD")
    os.makedirs(sub, exist_ok=True)
    lines = []
    for i in range(n_files):
        name = f"synth_{i + 1:02d}"
        guessed = 2 + i % 3
        _synthetic.write_recording(sub, name=name, n_markers=n_markers, guessed=guessed,
                                   seed=i)
        lines.append(f"DoD/{name}.eeg {guessed}")
    info = os.path.join(directory, "infoTrain.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info
