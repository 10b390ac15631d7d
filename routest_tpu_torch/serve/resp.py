"""A RESP2 client: the port's own connection to a Redis server.

The JAX package reaches Redis through the ``redis`` package
(``routest_tpu/serve/bus.py``: ``redis.Redis.from_url(url,
socket_timeout=2, socket_connect_timeout=2)``). The port speaks the wire
protocol itself, with the standard library only, and only the part the
SSE bus uses: ``PING``, ``AUTH``, ``SELECT``, ``PUBLISH``, ``SUBSCRIBE``
and ``UNSUBSCRIBE``.

- :func:`parse_url` reads ``redis://[[user]:password@]host[:port][/db]``
  and ``rediss://…`` as redis-py's ``from_url`` does: port 6379 by
  default, user and password percent-decoded, the database from the path
  (0 by default).
- :class:`Connection` connects with redis-py's timeouts (2 s to connect,
  2 s per reply), speaks TLS for ``rediss://`` with the system's default
  context (the certificate chain and the host name verified, SNI set to
  the host; never plain text), and sends ``AUTH`` (``AUTH user password``
  when the URL names a user, as Upstash's ``default``) and ``SELECT``
  (db ≠ 0) on every connect.
- Commands go out as RESP arrays of bulk strings; every RESP2 reply is
  decoded: ``+`` → ``str``, ``-`` → :class:`RedisError`, ``:`` → ``int``,
  ``$`` → ``bytes`` (``$-1`` → ``None``), ``*`` → ``list`` (``*-1`` →
  ``None``).

No error or log line names a password: :func:`redact_url` writes a URL's
``user:password@`` as ``user:<redacted>@``, and a server's words are
scrubbed of the password before they are raised.
"""

from __future__ import annotations

import socket
import ssl
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union
from urllib.parse import unquote, urlsplit

DEFAULT_PORT = 6379
SOCKET_TIMEOUT_S = 2.0
CONNECT_TIMEOUT_S = 2.0

Reply = Union[str, int, bytes, None, list, "RedisError"]


class RedisError(Exception):
    """The server's error reply (``-ERR …``, ``-NOAUTH …``,
    ``-WRONGPASS …``), in the server's words."""


class ProtocolError(ConnectionError):
    """A reply that is not RESP2: the connection cannot be trusted."""


def redact_url(url: str) -> str:
    """``url`` with the password of its ``user:password@`` written as
    ``<redacted>`` (a URL without one is returned as it is). The
    credentials end at the URL's last ``@``, so a password with an
    unescaped ``@``, ``/`` or ``:`` is hidden whole."""
    head, sep, rest = url.partition("://")
    at = rest.rfind("@")
    if not sep or at < 0 or ":" not in rest[:at]:
        return url
    user = rest[:at].split(":", 1)[0]
    return f"{head}://{user}:<redacted>{rest[at:]}"


@dataclass(frozen=True)
class RedisURL:
    host: str
    port: int = DEFAULT_PORT
    username: Optional[str] = None
    password: Optional[str] = None
    db: int = 0
    tls: bool = False

    def __repr__(self) -> str:  # never the password
        return (f"RedisURL(host={self.host!r}, port={self.port}, "
                f"username={self.username!r}, password="
                f"{'<redacted>' if self.password else None}, db={self.db}, "
                f"tls={self.tls})")


def parse_url(url: str) -> RedisURL:
    """``redis://`` or ``rediss://`` URL → :class:`RedisURL`, as
    redis-py's ``from_url`` reads these forms. Raises ``ValueError``
    (naming the URL redacted) on another scheme, a missing host or a
    database that is not a number."""
    shown = redact_url(url)
    try:
        parts = urlsplit(url)
        port = parts.port
    except ValueError as e:
        raise ValueError(f"bad Redis URL {shown!r}: {e}") from None
    if parts.scheme not in ("redis", "rediss"):
        raise ValueError(f"bad Redis URL {shown!r}: the scheme must be "
                         f"redis:// or rediss://")
    if not parts.hostname:
        raise ValueError(f"bad Redis URL {shown!r}: no host")
    path = parts.path.replace("/", "")
    try:
        db = int(path) if path else 0
    except ValueError:
        raise ValueError(f"bad Redis URL {shown!r}: the database "
                         f"{path!r} is not a number") from None
    return RedisURL(host=unquote(parts.hostname), port=port or DEFAULT_PORT,
                    username=unquote(parts.username) if parts.username
                    else None,
                    password=unquote(parts.password) if parts.password
                    else None,
                    db=db, tls=parts.scheme == "rediss")


def encode_command(*args) -> bytes:
    """A command as a RESP array of bulk strings (``str`` is UTF-8,
    ``int``/``float`` their decimal text, ``bytes`` as they are)."""
    out = [b"*%d\r\n" % len(args)]
    for arg in args:
        if isinstance(arg, (bytes, bytearray, memoryview)):
            b = bytes(arg)
        elif isinstance(arg, str):
            b = arg.encode()
        elif isinstance(arg, (int, float)) and not isinstance(arg, bool):
            b = repr(arg).encode()
        else:
            raise TypeError(f"a Redis argument must be bytes, str or a "
                            f"number, not {type(arg).__name__}")
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


class _Incomplete(Exception):
    """The buffer ends inside a reply: read more."""


def _line(buf, pos: int) -> Tuple[bytes, int]:
    end = buf.find(b"\r\n", pos)
    if end < 0:
        raise _Incomplete
    return bytes(buf[pos:end]), end + 2


def decode_reply(buf, pos: int = 0) -> Tuple[Reply, int]:
    """One RESP2 reply from ``buf[pos:]`` → (reply, position after it).
    Raises :class:`_Incomplete` when the buffer ends inside the reply,
    :class:`ProtocolError` on bytes that are not RESP2."""
    if pos >= len(buf):
        raise _Incomplete
    kind = buf[pos:pos + 1]
    head, pos = _line(buf, pos + 1)
    if kind == b"+":
        return head.decode("utf-8", "replace"), pos
    if kind == b"-":
        return RedisError(head.decode("utf-8", "replace")), pos
    try:
        n = int(head)
    except ValueError:
        raise ProtocolError(f"bad RESP2 header {kind + head!r}") from None
    if kind == b":":
        return n, pos
    if kind == b"$":
        if n < 0:
            return None, pos
        if len(buf) < pos + n + 2:
            raise _Incomplete
        if buf[pos + n:pos + n + 2] != b"\r\n":
            raise ProtocolError("a bulk string not ended by CRLF")
        return bytes(buf[pos:pos + n]), pos + n + 2
    if kind == b"*":
        if n < 0:
            return None, pos
        items: List[Reply] = []
        for _ in range(n):
            item, pos = decode_reply(buf, pos)
            items.append(item)
        return items, pos
    raise ProtocolError(f"unknown RESP2 reply type {kind!r}")


class Connection:
    """One socket to the server, handshaken (TLS, ``AUTH``, ``SELECT``)
    when :meth:`connect` returns. Not thread-safe: the bus serializes
    its command connection under a lock, and a subscription owns its
    own."""

    def __init__(self, url: RedisURL) -> None:
        self.url = url
        self._sock: Optional[socket.socket] = None
        self._buf = bytearray()

    def connect(self) -> None:
        """Connect and handshake; raises ``OSError`` (``ssl.SSLError``
        included) when the server cannot be reached or verified, and
        :class:`RedisError` when it refuses the ``AUTH`` or ``SELECT``."""
        self.close()
        u = self.url
        sock = socket.create_connection((u.host, u.port),
                                        timeout=CONNECT_TIMEOUT_S)
        try:
            if u.tls:
                ctx = ssl.create_default_context()
                sock = ctx.wrap_socket(sock, server_hostname=u.host)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(SOCKET_TIMEOUT_S)
        except BaseException:
            sock.close()
            raise
        self._sock = sock
        try:
            if u.password:
                auth = ((u.username, u.password) if u.username
                        else (u.password,))
                self.command("AUTH", *auth)
            if u.db:
                self.command("SELECT", u.db)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        sock, self._sock = self._sock, None
        self._buf.clear()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def send(self, *args) -> None:
        if self._sock is None:
            raise ConnectionError("not connected")
        self._sock.sendall(encode_command(*args))

    def read_reply(self, timeout: Optional[float] = None) -> Reply:
        """The next reply. With ``timeout`` (s; 0 reads only what has
        arrived), a reply that has not come by then raises
        :class:`TimeoutError`, and the connection stays good. Without
        one, running out of the socket timeout, like a closed
        connection, raises ``ConnectionError``."""
        if self._sock is None:
            raise ConnectionError("not connected")
        deadline = None if timeout is None else time.monotonic() + timeout
        tried = False
        while True:
            try:
                reply, used = decode_reply(self._buf)
            except _Incomplete:
                pass
            else:
                del self._buf[:used]
                return reply
            if deadline is None:
                wait = SOCKET_TIMEOUT_S
            else:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    if tried:
                        raise TimeoutError("no reply yet")
                    wait = 0.0  # one read of what has arrived
            tried = True
            self._sock.settimeout(wait)
            try:
                chunk = self._sock.recv(65536)
            except (socket.timeout, BlockingIOError, ssl.SSLWantReadError):
                if deadline is None:
                    raise ConnectionError(
                        f"no reply in {SOCKET_TIMEOUT_S} s") from None
                continue
            finally:
                if self._sock is not None:
                    self._sock.settimeout(SOCKET_TIMEOUT_S)
            if not chunk:
                raise ConnectionError("the server closed the connection")
            self._buf += chunk

    def command(self, *args) -> Reply:
        """Send one command and read its reply; an error reply raises
        :class:`RedisError` (with the password scrubbed)."""
        self.send(*args)
        reply = self.read_reply()
        if isinstance(reply, RedisError):
            words = str(reply)
            if self.url.password:
                words = words.replace(self.url.password, "<redacted>")
            raise RedisError(f"{args[0]} refused: {words}")
        return reply
