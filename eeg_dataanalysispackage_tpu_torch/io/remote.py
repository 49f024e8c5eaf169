"""Remote filesystems: HTTP(S), GCS-style object stores and HDFS.

Port of the JAX package's ``io/remote.py``. The reference's I/O runs
over a remote filesystem — a hard-coded HDFS endpoint
(``Utils/Const.java:38-42``) dialed by every data path
(``OffLineDataProvider.java:90``). Here an object-store client speaks
HTTP with the semantics the Hadoop ``FileSystem``/``DFSInputStream``
stack gives the reference: ranged chunked reads, bounded retries with
exponential backoff, per-request timeouts and resume after a body dies
mid-transfer. ``hdfs://`` goes over WebHDFS (the namenode's REST face)
or, with ``HDFS_DRIVER=native``, over libhdfs through ``pyarrow``.

Everything but the native driver is stdlib (``http.client``), and the
endpoint is injectable, so tests drive the retry and resume machinery
against an in-process server. :func:`filesystem_for` maps
``http(s)://``, ``gs://``, ``hdfs://``, ``file://`` and plain paths onto
an ``io.sources.FileSystem``; ``io/provider.py`` and
``io/modelfiles.py`` route every location through it.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import os
import random
import re
import threading
import time
import urllib.parse
from typing import Optional, Tuple

from ..obs import chaos, events
from . import circuit
from . import deadline as deadline_mod
from . import sources

logger = logging.getLogger(__name__)

_URI_SCHEME = re.compile(r"([A-Za-z][A-Za-z0-9+.-]*)://")


def uri_scheme(location) -> Optional[str]:
    """The URI scheme of ``location`` (``scheme://...``), or None for a
    plain path."""
    match = _URI_SCHEME.match(str(location))
    return match.group(1) if match else None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry contract for one logical read or write.

    ``max_attempts`` counts tries of each request (a chunk fetch, a
    HEAD, a PUT); ``backoff_s`` doubles after every failure up to
    ``max_backoff_s``. ``timeout_s`` is the per-request socket timeout,
    so a hung endpoint costs at most ``max_attempts * timeout_s`` plus
    the backoff per request.

    ``jitter="full"`` opts into full-jitter backoff (uniform over
    ``[0, deterministic wait]``), so many workers retrying one
    recovering endpoint spread out; the default stays deterministic so
    tests and chaos runs replay exactly.

    The ladder is also deadline-aware: under an ambient
    :class:`io.deadline.Deadline` (``deadline_scope``) it stops, raising
    with the attempt history, as soon as the remaining budget cannot
    cover the next backoff sleep.
    """

    max_attempts: int = 4
    timeout_s: float = 20.0
    backoff_s: float = 0.25
    max_backoff_s: float = 4.0
    jitter: str = "none"  # "none" | "full"

    def __post_init__(self):
        if self.jitter not in ("none", "full"):
            raise ValueError(f"jitter must be 'none' or 'full', got {self.jitter!r}")

    def sleep_for(self, attempt: int) -> float:
        wait = min(self.backoff_s * (2.0 ** attempt), self.max_backoff_s)
        if self.jitter == "full":
            return random.uniform(0.0, wait)
        return wait


class RemoteIOError(IOError):
    """A remote request failed after exhausting its retry budget."""


#: statuses worth retrying: transient server or gateway conditions
_RETRYABLE_STATUSES = (429, 500, 502, 503, 504)

#: redirect statuses followed by the WebHDFS namenode->datanode hops
_REDIRECT_STATUSES = (301, 302, 303, 307, 308)


class HttpFileSystem:
    """``io.sources.FileSystem`` over HTTP(S) with object-store semantics.

    Reads stream in ``chunk_size`` ranged GETs; each chunk retries on
    its own, and a connection dying mid-body resumes from the bytes
    already received (``Range: bytes=<got>-``). Servers that ignore
    ``Range`` (status 200) are read in one body. 404/410 map to
    ``FileNotFoundError``, so the provider's skip-on-missing behaviour
    (``OffLineDataProvider.java:154-161``) holds over remote inputs.
    """

    def __init__(
        self,
        base_url: str = "",
        retry: Optional[RetryPolicy] = None,
        chunk_size: int = 4 * 1024 * 1024,
        headers: Optional[dict] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.retry = retry or RetryPolicy()
        self.chunk_size = int(chunk_size)
        self.headers = dict(headers or {})
        # one keep-alive connection per (scheme, netloc) and thread,
        # reused across the chunked read loop and dropped on any error or
        # server close: one instance serves the provider's parse pool,
        # each thread on connections of its own
        self._local = threading.local()

    def _split(self, path: str) -> Tuple[str, str, str]:
        """path -> (scheme, netloc, request path)."""
        url = path if "://" in path else f"{self.base_url}/{path.lstrip('/')}"
        parts = urllib.parse.urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"HttpFileSystem cannot handle {url!r}")
        req_path = parts.path or "/"
        if parts.query:
            req_path += "?" + parts.query
        return parts.scheme, parts.netloc, req_path

    @property
    def _conns(self) -> dict:
        """The calling thread's connections, by (scheme, netloc)."""
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        return conns

    def _connect(self, scheme: str, netloc: str) -> http.client.HTTPConnection:
        conns = self._conns
        conn = conns.get((scheme, netloc))
        if conn is not None:
            return conn
        cls = http.client.HTTPSConnection if scheme == "https" else http.client.HTTPConnection
        conn = cls(netloc, timeout=self.retry.timeout_s)
        conns[(scheme, netloc)] = conn
        return conn

    def _drop(self, scheme: str, netloc: str) -> None:
        conn = self._conns.pop((scheme, netloc), None)
        if conn is not None:
            conn.close()

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        extra_headers: Optional[dict] = None,
    ):
        """One request with the retry budget; returns (status, headers,
        body bytes, or b'' for HEAD). Retries connection errors,
        timeouts and transient statuses; a GET body dying mid-transfer
        is resumed by the caller, which owns the resume state.

        The endpoint's circuit breaker (``io/circuit.py``) wraps the
        whole budget. Under an ambient deadline the ladder stops the
        moment the remaining budget cannot cover the next backoff, and
        still records a breaker failure: the attempts that ran all
        failed, and a dead endpoint must not stay invisible to the
        circuit because its callers are in a hurry.
        """
        scheme, netloc, req_path = self._split(path)
        breaker = circuit.breaker_for(f"{scheme}://{netloc}")
        dl = deadline_mod.active_deadline()
        if dl is not None and dl.expired:
            # before breaker.allow(): a spent budget must not claim (and
            # then leak) the breaker's one half-open probe slot
            raise RemoteIOError(
                f"{method} {scheme}://{netloc}{req_path} not attempted: "
                f"deadline budget ({dl.budget_s:.3f}s) already spent"
            )
        breaker.allow()
        last_err: Optional[Exception] = None
        attempt_history: list = []
        for attempt in range(self.retry.max_attempts):
            conn = self._connect(scheme, netloc)
            try:
                # chaos: one request attempt dropped, inside this loop's
                # own retry contract like a real transient
                chaos.maybe_fire("remote.request", RemoteIOError)
                headers = {**self.headers, **(extra_headers or {})}
                conn.request(method, req_path, body=body, headers=headers)
                resp = conn.getresponse()
                status = resp.status
                if status in _RETRYABLE_STATUSES:
                    resp.read()
                    raise RemoteIOError(f"HTTP {status} from {netloc}{req_path}")
                # b"" for HEAD; reading closes the response, which is what
                # lets the kept-alive connection take the next request (an
                # unread HEAD response fails the next one on it)
                data = resp.read()
                resp_headers = {k.lower(): v for k, v in resp.getheaders()}
                if resp.will_close:
                    self._drop(scheme, netloc)
                breaker.record_success()
                return status, resp_headers, data
            except (OSError, http.client.HTTPException, RemoteIOError) as e:
                last_err = e
                attempt_history.append(f"attempt {attempt + 1}: {type(e).__name__}: {e}")
                self._drop(scheme, netloc)
                logger.warning("%s %s attempt %d/%d failed: %s", method, req_path,
                               attempt + 1, self.retry.max_attempts, e)
                events.event("remote.retry", method=method, path=req_path,
                             attempt=attempt + 1, max_attempts=self.retry.max_attempts,
                             error=f"{type(e).__name__}: {e}")
                if attempt + 1 < self.retry.max_attempts:
                    wait = self.retry.sleep_for(attempt)
                    if dl is not None and not dl.can_cover(wait):
                        aborted = RemoteIOError(
                            f"{method} {scheme}://{netloc}{req_path} "
                            f"aborted after {attempt + 1}/{self.retry.max_attempts} "
                            f"attempts: deadline budget ({dl.remaining():.3f}s "
                            f"remaining) cannot cover the {wait:.3f}s backoff; "
                            f"attempts: {attempt_history}"
                        )
                        events.event("remote.deadline_abort", method=method, path=req_path,
                                     attempts=attempt + 1,
                                     remaining_s=round(dl.remaining(), 4),
                                     next_backoff_s=round(wait, 4))
                        breaker.record_failure(aborted)
                        raise aborted
                    time.sleep(wait)
        exhausted = RemoteIOError(
            f"{method} {scheme}://{netloc}{req_path} failed after "
            f"{self.retry.max_attempts} attempts: {last_err}"
        )
        breaker.record_failure(exhausted)
        raise exhausted

    # -- FileSystem protocol -------------------------------------------

    def exists(self, path: str) -> bool:
        status, _, _ = self._request("HEAD", path)
        if status in (404, 410):
            return False
        if status == 405:  # HEAD not allowed: probe with a 1-byte range
            status, _, _ = self._request("GET", path, extra_headers={"Range": "bytes=0-0"})
            # 416 = the object exists but is empty (range unsatisfiable)
            return status in (200, 206, 416)
        return 200 <= status < 300

    def read_bytes(self, path: str) -> bytes:
        got = bytearray()
        total: Optional[int] = None
        while total is None or len(got) < total:
            start = len(got)
            end = start + self.chunk_size - 1
            status, headers, data = self._request(
                "GET", path, extra_headers={"Range": f"bytes={start}-{end}"})
            if status in (404, 410):
                raise FileNotFoundError(path)
            if status == 200:
                # the server ignored Range: the body is the whole object
                if start:
                    raise RemoteIOError(f"{path}: server stopped honoring Range mid-read")
                return data
            if status == 416:
                # no range is satisfiable at this offset: an empty object
                # (start 0) or EOF under an unknown total
                # ("Content-Range: bytes 0-N/*", RFC 7233)
                break
            if status != 206:
                raise RemoteIOError(f"GET {path}: unexpected HTTP {status}")
            if total is None:
                total = _total_from_content_range(headers.get("content-range", ""))
            got.extend(data)
            if not data:
                raise RemoteIOError(f"GET {path}: empty 206 body at {start}")
            if total is None and len(data) < self.chunk_size:
                break  # a short chunk under an unknown total: EOF
        return bytes(got)

    def read_range(self, path: str, start: int, length: int) -> bytes:
        """Read ``length`` bytes at ``start`` (an object-store block read)."""
        status, _, data = self._request(
            "GET", path, extra_headers={"Range": f"bytes={start}-{start + length - 1}"})
        if status in (404, 410):
            raise FileNotFoundError(path)
        if status == 200:
            return data[start:start + length]
        if status != 206:
            raise RemoteIOError(f"GET {path}: unexpected HTTP {status}")
        return data

    def read_text(self, path: str) -> str:
        return self.read_bytes(path).decode("utf-8", errors="replace")

    def write_bytes(self, path: str, data: bytes) -> None:
        status, _, _ = self._request("PUT", path, body=data)
        if not 200 <= status < 300:
            raise RemoteIOError(f"PUT {path}: HTTP {status}")


class GcsFileSystem(HttpFileSystem):
    """``gs://bucket/object`` over the GCS XML API.

    Maps bucket and object onto ``{endpoint}/{bucket}/{object}`` (the
    storage.googleapis.com path style). ``endpoint`` is injectable for
    tests and private gateways; ``token`` adds a bearer header. Transfer
    semantics come from :class:`HttpFileSystem`.
    """

    def __init__(
        self,
        endpoint: str = "https://storage.googleapis.com",
        token: Optional[str] = None,
        **kwargs,
    ):
        headers = dict(kwargs.pop("headers", {}))
        if token:
            headers["Authorization"] = f"Bearer {token}"
        super().__init__(base_url=endpoint, headers=headers, **kwargs)

    def _split(self, path: str) -> Tuple[str, str, str]:
        if path.startswith("gs://"):
            path = path[len("gs://"):]
        return super()._split(path)


class WebHdfsFileSystem(HttpFileSystem):
    """``hdfs://host:port/path`` over the WebHDFS REST API.

    - ``GETFILESTATUS`` answers ``exists`` and gives the length that
      drives the chunked read loop;
    - ``OPEN`` with ``offset``/``length`` is the ranged read;
    - ``CREATE`` is the namenode/datanode two-step: a body-less PUT that
      307-redirects to the datanode which takes the bytes.

    Redirects (absolute or relative ``Location``) are followed, and
    gateways that answer without one (HttpFS style) work too. Retry,
    backoff and timeouts come per request from :class:`HttpFileSystem`.

    ``endpoint`` overrides the URI's authority: real clusters serve
    WebHDFS on the HTTP port (9870), not the RPC port an ``hdfs://`` URI
    carries (8020). Without it the authority is dialed verbatim. ``user``
    adds ``user.name=`` pseudo-authentication. Both default from
    ``WEBHDFS_ENDPOINT`` / ``WEBHDFS_USER``, so scheme-routed instances
    (``filesystem_for``, which takes no arguments from a query) can
    reach a gateway whose HTTP authority differs from the URI's.
    """

    def __init__(
        self,
        endpoint: Optional[str] = None,
        user: Optional[str] = None,
        api_prefix: str = "/webhdfs/v1",
        **kwargs,
    ):
        super().__init__(base_url="", **kwargs)
        endpoint = endpoint or os.environ.get("WEBHDFS_ENDPOINT")
        self.endpoint = endpoint.rstrip("/") if endpoint else None
        self.user = user or os.environ.get("WEBHDFS_USER")
        self.api_prefix = api_prefix

    def _rest_url(self, path: str, op: str, **params) -> str:
        """hdfs path -> the full http REST URL of one operation."""
        if path.startswith("hdfs://"):
            authority, _, hpath = path[len("hdfs://"):].partition("/")
            hpath = "/" + hpath
            if not authority and self.endpoint is None:
                # hdfs:///path (Hadoop's default-FS form) has no
                # authority: fail fast rather than let http.client
                # resolve an empty netloc to localhost:80
                raise ValueError(
                    f"{path!r} has no authority; set endpoint= or "
                    f"WEBHDFS_ENDPOINT for default-FS hdfs:/// URIs"
                )
            base = self.endpoint or f"http://{authority}"
        else:
            if self.endpoint is None:
                raise ValueError(
                    f"WebHdfsFileSystem needs an hdfs:// URI or an endpoint=, got {path!r}"
                )
            base = self.endpoint
            hpath = path if path.startswith("/") else "/" + path
        query = {"op": op, **params}
        if self.user:
            query["user.name"] = self.user
        return (f"{base}{self.api_prefix}"
                f"{urllib.parse.quote(hpath)}?{urllib.parse.urlencode(query)}")

    def _follow(self, method: str, url: str, body: Optional[bytes] = None):
        """A request plus the namenode->datanode redirect hops (each hop
        has the full retry budget); a relative ``Location`` resolves
        against the current hop's URL."""
        for _ in range(4):
            status, headers, data = self._request(method, url, body=body)
            if status in _REDIRECT_STATUSES and "location" in headers:
                url = urllib.parse.urljoin(url, headers["location"])
                continue
            return status, headers, data
        raise RemoteIOError(f"{method} {url}: too many redirects")

    def _file_status(self, path: str) -> Optional[dict]:
        status, _, data = self._follow("GET", self._rest_url(path, "GETFILESTATUS"))
        if status in (404, 410):
            return None
        if status != 200:
            raise RemoteIOError(f"GETFILESTATUS {path}: HTTP {status}")
        try:
            return json.loads(data)["FileStatus"]
        except (ValueError, KeyError, TypeError) as e:
            # a 200 from something that is not WebHDFS (a captive portal,
            # a misrouted gateway) stays inside the IOError contract
            raise RemoteIOError(
                f"GETFILESTATUS {path}: unparseable response ({data[:80]!r})"
            ) from e

    def exists(self, path: str) -> bool:
        return self._file_status(path) is not None

    def list_dir(self, path: str) -> list:
        """Child entry names of a directory (WebHDFS ``LISTSTATUS``)."""
        status, _, data = self._follow("GET", self._rest_url(path, "LISTSTATUS"))
        if status in (404, 410):
            raise FileNotFoundError(path)
        if status != 200:
            raise RemoteIOError(f"LISTSTATUS {path}: HTTP {status}")
        try:
            entries = json.loads(data)["FileStatuses"]["FileStatus"]
            return [e["pathSuffix"] for e in entries]
        except (ValueError, KeyError, TypeError) as e:
            raise RemoteIOError(
                f"LISTSTATUS {path}: unparseable response ({data[:80]!r})"
            ) from e

    def delete_dir(self, path: str) -> None:
        """Recursive delete (WebHDFS ``DELETE``); a missing target is fine."""
        status, _, _ = self._request("DELETE", self._rest_url(path, "DELETE", recursive="true"))
        if status not in (200, 404, 410):
            raise RemoteIOError(f"DELETE {path}: HTTP {status}")

    def read_range(self, path: str, start: int, length: int) -> bytes:
        url = self._rest_url(path, "OPEN", offset=start, length=length)
        status, _, data = self._follow("GET", url)
        if status in (404, 410):
            raise FileNotFoundError(path)
        if status != 200:
            raise RemoteIOError(f"OPEN {path} @{start}: HTTP {status}")
        return data

    def read_bytes(self, path: str) -> bytes:
        st = self._file_status(path)
        if st is None:
            raise FileNotFoundError(path)
        if st.get("type") == "DIRECTORY":
            # as LocalFileSystem raises; a DIRECTORY status has length 0
            # and would otherwise read as b""
            raise IsADirectoryError(path)
        try:
            total = int(st["length"])
        except (KeyError, ValueError, TypeError) as e:
            raise RemoteIOError(f"GETFILESTATUS {path}: malformed FileStatus ({st!r})") from e
        got = bytearray()
        while len(got) < total:
            chunk = self.read_range(path, len(got), min(self.chunk_size, total - len(got)))
            if not chunk:
                raise RemoteIOError(f"OPEN {path}: empty body at offset {len(got)}/{total}")
            got.extend(chunk)
        return bytes(got)

    def write_bytes(self, path: str, data: bytes) -> None:
        url = self._rest_url(path, "CREATE", overwrite="true")
        # step 1: a body-less PUT to the namenode, which answers 307 with
        # the datanode that takes the bytes; HttpFS-style gateways skip
        # the redirect and take the body on a second PUT to the same URL
        status, headers, _ = self._request("PUT", url)
        if status in _REDIRECT_STATUSES and "location" in headers:
            status2, _, _ = self._follow(
                "PUT", urllib.parse.urljoin(url, headers["location"]), body=data)
            if not 200 <= status2 < 300:
                raise RemoteIOError(f"CREATE {path} (data): HTTP {status2}")
        elif 200 <= status < 300:
            status2, _, _ = self._request(
                "PUT", self._rest_url(path, "CREATE", overwrite="true", data="true"),
                body=data, extra_headers={"Content-Type": "application/octet-stream"},
            )
            if not 200 <= status2 < 300:
                # the gateway accepted the body-less step 1 (which
                # carries overwrite=true), so the target may be truncated
                raise RemoteIOError(
                    f"CREATE {path} (direct): HTTP {status2}; target may be left "
                    f"truncated by the accepted step-1 CREATE"
                )
        else:
            raise RemoteIOError(f"CREATE {path}: HTTP {status}")


def _hadoop_connect(host: str, port: int, user: Optional[str]):
    """Open a pyarrow libhdfs connection (a module-level seam, so tests
    can fake the native layer without a Hadoop install)."""
    try:
        from pyarrow import fs as pafs
    except ImportError as e:
        raise RemoteIOError(
            "HDFS_DRIVER=native needs pyarrow; unset it to use the "
            "zero-dependency WebHDFS driver"
        ) from e
    try:
        return pafs.HadoopFileSystem(host, port=port, user=user)
    except (OSError, RuntimeError) as e:
        raise RemoteIOError(
            f"native HDFS connect to {host}:{port} failed ({e}); the "
            f"libhdfs runtime (libhdfs.so + CLASSPATH from a Hadoop "
            f"install) must be present — or unset HDFS_DRIVER to use "
            f"WebHDFS"
        ) from e


class NativeHdfsFileSystem:
    """``hdfs://host:port/path`` over the native Hadoop RPC protocol.

    The reference dials this wire protocol (``Const.java:38-42``, the
    RPC port 8020). Clusters with WebHDFS disabled are reached through
    pyarrow's libhdfs binding, selected with ``HDFS_DRIVER=native``.
    A missing ``pyarrow`` or libhdfs runtime raises a
    :class:`RemoteIOError` naming the fix. ``hdfs:///path`` dials the
    ``fs.defaultFS`` of the node's Hadoop configuration. Connections are
    cached per authority and shared by the parse pool's threads.
    """

    def __init__(self, user: Optional[str] = None):
        self.user = user or os.environ.get("HDFS_USER")
        self._conns: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def _split(path: str) -> tuple:
        if not path.startswith("hdfs://"):
            raise ValueError(f"NativeHdfsFileSystem needs an hdfs:// URI, got {path!r}")
        authority, _, hpath = path[len("hdfs://"):].partition("/")
        return authority, "/" + hpath

    def _fs(self, authority: str):
        with self._lock:
            if authority not in self._conns:
                if authority:
                    host, _, port = authority.partition(":")
                    port_n = int(port) if port else 8020
                else:
                    # hdfs:/// -> libhdfs "default": fs.defaultFS from the
                    # local Hadoop configuration
                    host, port_n = "default", 0
                self._conns[authority] = _hadoop_connect(host, port_n, self.user)
            return self._conns[authority]

    def exists(self, path: str) -> bool:
        from pyarrow import fs as pafs

        authority, hpath = self._split(path)
        return self._fs(authority).get_file_info([hpath])[0].type != pafs.FileType.NotFound

    def read_bytes(self, path: str) -> bytes:
        from pyarrow import fs as pafs

        authority, hpath = self._split(path)
        fs = self._fs(authority)
        info = fs.get_file_info([hpath])[0]
        if info.type == pafs.FileType.NotFound:
            raise FileNotFoundError(path)
        if info.type == pafs.FileType.Directory:
            raise IsADirectoryError(path)
        with fs.open_input_stream(hpath) as f:
            return f.read()

    def read_text(self, path: str) -> str:
        return self.read_bytes(path).decode("utf-8", errors="replace")

    def list_dir(self, path: str) -> list:
        """Child entry names (the contract of ``WebHdfsFileSystem.list_dir``)."""
        from pyarrow import fs as pafs

        authority, hpath = self._split(path)
        infos = self._fs(authority).get_file_info(pafs.FileSelector(hpath, recursive=False))
        return [os.path.basename(i.path) for i in infos]

    def delete_dir(self, path: str) -> None:
        """Recursive delete; a missing target is fine."""
        authority, hpath = self._split(path)
        try:
            self._fs(authority).delete_dir(hpath)
        except FileNotFoundError:
            pass

    def write_bytes(self, path: str, data: bytes) -> None:
        authority, hpath = self._split(path)
        with self._fs(authority).open_output_stream(hpath) as f:
            f.write(data)


def _total_from_content_range(value: str) -> Optional[int]:
    # "bytes 0-1048575/31719424" -> 31719424
    if "/" in value:
        tail = value.rsplit("/", 1)[1]
        if tail.isdigit():
            return int(tail)
    return None


def filesystem_for(path: str, **kwargs):
    """URI scheme -> FileSystem instance (the reference's fixed
    ``Const.java`` endpoint, made pluggable).

    ``http(s)://`` -> :class:`HttpFileSystem`; ``gs://`` ->
    :class:`GcsFileSystem`; ``hdfs://`` -> :class:`WebHdfsFileSystem`,
    or :class:`NativeHdfsFileSystem` when ``HDFS_DRIVER=native``;
    ``file://`` and plain paths -> local POSIX. The filesystem takes the
    original URI in every call, so callers thread one (fs, path) pair.
    """
    if path.startswith(("http://", "https://")):
        return HttpFileSystem(**kwargs)
    if path.startswith("gs://"):
        return GcsFileSystem(**kwargs)
    if path.startswith("hdfs://"):
        driver = os.environ.get("HDFS_DRIVER", "webhdfs").strip().lower()
        if driver == "native":
            return NativeHdfsFileSystem(**{k: v for k, v in kwargs.items() if k == "user"})
        if driver != "webhdfs":
            raise ValueError(f"HDFS_DRIVER must be 'webhdfs' or 'native', got {driver!r}")
        return WebHdfsFileSystem(**kwargs)
    return sources.LocalFileSystem()
