"""A minimal Redis server speaking RESP2, for tests of the port's bus.

It implements what a Redis server answers to the commands the port's
client (``routest_tpu_torch/serve/resp.py``) sends: ``PING`` (in normal
and in subscribed mode), ``AUTH`` in both forms (``AUTH password``,
``AUTH user password``) with an optional required password, ``SELECT``,
``PUBLISH``, ``SUBSCRIBE``, ``UNSUBSCRIBE`` and ``QUIT``, and ``-ERR
unknown command`` for the rest; the error words are Redis 7's. It has
its own RESP2 reader and writer (none shared with the client under
test), an optional TLS listener, hooks to drop every connection and to
stop and restart on the same ports, and a log of the raw ``PUBLISH``
payloads and of every command it received, and a ``mute`` switch that
leaves commands unanswered (a hung server). In-memory, threaded,
stdlib only, the Redis counterpart of ``tests/fake_postgrest.py``.

    fake = FakeRedis(password="pw", tls=True).start()
    url = fake.url()           # redis://default:pw@127.0.0.1:<port>/0
    ...
    fake.stop(); fake.start()  # the same ports again
    fake.stop()
"""

from __future__ import annotations

import os
import socket
import socketserver
import ssl
import threading
import time
from typing import Dict, List, Optional, Set, Tuple
from urllib.parse import quote

HERE = os.path.dirname(os.path.abspath(__file__))
# A CA and a certificate for localhost and 127.0.0.1 signed by it, made
# once with openssl (valid until 2126); tests point OpenSSL's
# SSL_CERT_FILE at the CA.
TLS_CA = os.path.join(HERE, "redis_tls", "ca.pem")
TLS_CERT = os.path.join(HERE, "redis_tls", "server.pem")
TLS_KEY = os.path.join(HERE, "redis_tls", "server.key")


def reply(value) -> bytes:
    """A RESP2 reply: ``str`` → simple string, ``Err`` → error,
    ``int`` → integer, ``bytes`` → bulk string, ``None`` → null bulk,
    ``list``/``tuple`` → array (``NullArray`` → ``*-1``)."""
    if isinstance(value, Err):
        return b"-" + str(value).encode() + b"\r\n"
    if value is NullArray:
        return b"*-1\r\n"
    if isinstance(value, bool):
        raise TypeError("no RESP2 boolean")
    if isinstance(value, str):
        return b"+" + value.encode() + b"\r\n"
    if isinstance(value, int):
        return b":%d\r\n" % value
    if isinstance(value, (bytes, bytearray)):
        return b"$%d\r\n" % len(value) + bytes(value) + b"\r\n"
    if value is None:
        return b"$-1\r\n"
    if isinstance(value, (list, tuple)):
        return b"*%d\r\n" % len(value) + b"".join(reply(v) for v in value)
    raise TypeError(f"no RESP2 form for {type(value).__name__}")


class Err(str):
    """An error reply's words (``ERR …``, ``NOAUTH …``)."""


NullArray = object()


class _Short(Exception):
    pass


def read_command(buf: bytearray) -> Optional[List[bytes]]:
    """One command (a RESP array of bulk strings) off the front of
    ``buf`` → its arguments, or None until it has all arrived."""
    try:
        args, used = _parse_array(buf)
    except _Short:
        return None
    del buf[:used]
    return args


def _parse_array(buf) -> Tuple[List[bytes], int]:
    end = buf.find(b"\r\n")
    if end < 0:
        raise _Short
    if buf[:1] != b"*":
        raise ValueError(f"not a RESP array: {bytes(buf[:20])!r}")
    n, pos = int(buf[1:end]), end + 2
    args = []
    for _ in range(n):
        end = buf.find(b"\r\n", pos)
        if end < 0:
            raise _Short
        if buf[pos:pos + 1] != b"$":
            raise ValueError("not a bulk string")
        size, pos = int(buf[pos + 1:end]), end + 2
        if len(buf) < pos + size + 2:
            raise _Short
        args.append(bytes(buf[pos:pos + size]))
        pos += size + 2
    return args, pos


_SUBSCRIBED_OK = {b"SUBSCRIBE", b"UNSUBSCRIBE", b"PSUBSCRIBE",
                  b"PUNSUBSCRIBE", b"PING", b"QUIT", b"RESET"}


class _Client:
    """One connection's state: authenticated, database, channels."""

    def __init__(self, fake: "FakeRedis", sock: socket.socket,
                 tls: bool) -> None:
        self.fake = fake
        self.sock = sock
        self.tls = tls
        self.authed = fake.password is None
        self.db = 0
        self.channels: Set[bytes] = set()
        self.wlock = threading.Lock()

    def send(self, data: bytes) -> bool:
        try:
            with self.wlock:
                self.sock.sendall(data)
            return True
        except OSError:
            return False

    def serve(self) -> None:
        buf = bytearray()
        try:
            while True:
                args = read_command(buf)
                if args is None:
                    chunk = self.sock.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                    continue
                if not args:
                    continue
                if not self.handle(args):
                    return
        except (OSError, ValueError):
            return
        finally:
            self.fake._forget(self)

    def handle(self, args: List[bytes]) -> bool:
        """One command → False when the connection is to close."""
        fake = self.fake
        name = args[0].upper()
        with fake.lock:
            fake.commands.append((self.tls, [a.decode("utf-8", "replace")
                                             for a in args]))
        if fake.mute:
            return True
        if name == b"QUIT":
            self.send(reply("OK"))
            return False
        if name == b"AUTH":
            return self.send(reply(self._auth(args[1:])))
        if not self.authed:
            return self.send(reply(Err("NOAUTH Authentication required.")))
        if self.channels and name not in _SUBSCRIBED_OK:
            return self.send(reply(Err(
                f"ERR Can't execute '{name.decode().lower()}': only (P|S)"
                f"SUBSCRIBE / (P|S)UNSUBSCRIBE / PING / QUIT / RESET are "
                f"allowed in this context")))
        if name == b"PING":
            if self.channels:  # subscribed mode answers with an array
                msg = args[1] if len(args) > 1 else b""
                return self.send(reply([b"pong", msg]))
            return self.send(reply(args[1] if len(args) > 1 else "PONG"))
        if name == b"SELECT":
            try:
                db = int(args[1])
            except (IndexError, ValueError):
                return self.send(reply(Err(
                    "ERR value is not an integer or out of range")))
            if not 0 <= db < 16:
                return self.send(reply(Err("ERR DB index is out of range")))
            self.db = db
            return self.send(reply("OK"))
        if name == b"PUBLISH" and len(args) == 3:
            return self.send(reply(fake.publish(args[1], args[2])))
        if name == b"SUBSCRIBE" and len(args) > 1:
            # the confirmation goes out before any message of the
            # channel can, as from a single-threaded Redis
            try:
                with self.wlock:
                    for ch in args[1:]:
                        fake._join(self, ch)
                        self.sock.sendall(reply(
                            [b"subscribe", ch, len(self.channels)]))
                return True
            except OSError:
                return False
        if name == b"UNSUBSCRIBE":
            chans = args[1:] or sorted(self.channels)
            out = []
            for ch in chans:
                fake._leave(self, ch)
                out.append(reply([b"unsubscribe", ch, len(self.channels)]))
            if not chans:
                out.append(reply([b"unsubscribe", None, 0]))
            return self.send(b"".join(out))
        shown = " ".join(f"'{a.decode('utf-8', 'replace')}'"
                         for a in args[1:3])
        return self.send(reply(Err(
            f"ERR unknown command '{args[0].decode('utf-8', 'replace')}', "
            f"with args beginning with: {shown}")))

    def _auth(self, args: List[bytes]):
        fake = self.fake
        if len(args) == 1:
            user, password = b"default", args[0]
            if fake.password is None:
                return Err("ERR AUTH <password> called without any password "
                           "configured for the default user. Are you sure "
                           "your configuration is correct?")
        elif len(args) == 2:
            user, password = args
        else:
            return Err("ERR wrong number of arguments for 'auth' command")
        if fake.password is None and user == b"default":
            self.authed = True  # the default user is nopass
            return "OK"
        if (user.decode("utf-8", "replace") == fake.username
                and password.decode("utf-8", "replace") == fake.password):
            self.authed = True
            return "OK"
        return Err("WRONGPASS invalid username-password pair or user is "
                   "disabled.")


class _Listener(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FakeRedis:
    """The server: a plain listener and, with ``tls=True``, a TLS one.
    ``password`` (for user ``username``) makes every command but
    ``AUTH`` answer ``NOAUTH`` until one succeeds."""

    def __init__(self, password: Optional[str] = None,
                 username: str = "default", tls: bool = False,
                 host: str = "127.0.0.1") -> None:
        self.password = password
        self.username = username
        self.host = host
        self.lock = threading.Lock()
        self.published: List[Tuple[str, bytes]] = []  # raw PUBLISH payloads
        self.published_at: List[float] = []  # time.monotonic() of each
        self.commands: List[Tuple[bool, List[str]]] = []  # (tls, args)
        self._subs: Dict[bytes, Set[_Client]] = {}
        self._clients: Set[_Client] = set()
        self._want_tls = tls
        self.mute = False  # True: read commands, answer none (a hung server)
        self.port = 0
        self.tls_port = 0
        self._servers: List[Tuple[_Listener, threading.Thread]] = []

    def url(self, tls: bool = False, password: Optional[str] = None,
            db: int = 0, host: Optional[str] = None) -> str:
        """A URL for this server (``password`` overrides the right one)."""
        pw = self.password if password is None else password
        auth = f"{self.username}:{quote(pw, safe='')}@" if pw else ""
        scheme, port = ("rediss", self.tls_port) if tls \
            else ("redis", self.port)
        return f"{scheme}://{auth}{host or self.host}:{port}/{db}"

    def start(self) -> "FakeRedis":
        """Listen (on the ports of the last run after a :meth:`stop`)."""
        self._servers.append(self._listen(self.port, tls=False))
        self.port = self._servers[-1][0].server_address[1]
        if self._want_tls:
            self._servers.append(self._listen(self.tls_port, tls=True))
            self.tls_port = self._servers[-1][0].server_address[1]
        return self

    def _listen(self, port: int, tls: bool):
        fake = self
        ctx = None
        if tls:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(TLS_CERT, TLS_KEY)

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if ctx is not None:
                    try:
                        sock.settimeout(5.0)
                        sock = ctx.wrap_socket(sock, server_side=True)
                        sock.settimeout(None)
                    except (OSError, ssl.SSLError):
                        return  # a client that does not verify us
                client = _Client(fake, sock, tls)
                with fake.lock:
                    fake._clients.add(client)
                client.serve()

        server = _Listener((self.host, port), Handler)
        t = threading.Thread(target=server.serve_forever, args=(0.05,),
                             daemon=True,
                             name=f"fake-redis-{'tls' if tls else 'tcp'}")
        t.start()
        return server, t

    def publish(self, channel: bytes, payload: bytes) -> int:
        with self.lock:
            self.published.append((channel.decode("utf-8", "replace"),
                                    payload))
            self.published_at.append(time.monotonic())
            targets = list(self._subs.get(channel, ()))
        frame = reply([b"message", channel, payload])
        return sum(1 for c in targets if c.send(frame))

    def payloads(self, channel: str) -> List[bytes]:
        return [p for _, p in self.publish_log(channel)]

    def publish_log(self, channel: str) -> List[Tuple[float, bytes]]:
        """(arrival instant, raw payload) of each ``PUBLISH`` to
        ``channel``, oldest first."""
        with self.lock:
            return [(t, p) for t, (ch, p)
                    in zip(self.published_at, self.published)
                    if ch == channel]

    def subscribers(self, channel: str) -> int:
        with self.lock:
            return len(self._subs.get(channel.encode(), ()))

    def _join(self, client: _Client, channel: bytes) -> None:
        with self.lock:
            client.channels.add(channel)
            self._subs.setdefault(channel, set()).add(client)

    def _leave(self, client: _Client, channel: bytes) -> None:
        with self.lock:
            client.channels.discard(channel)
            subs = self._subs.get(channel)
            if subs is not None:
                subs.discard(client)
                if not subs:
                    del self._subs[channel]

    def _forget(self, client: _Client) -> None:
        for ch in list(client.channels):
            self._leave(client, ch)
        with self.lock:
            self._clients.discard(client)
        try:
            client.sock.close()
        except OSError:
            pass

    def drop_connections(self) -> int:
        """Close every client connection (the listeners stay) → how many."""
        with self.lock:
            clients = list(self._clients)
        for c in clients:
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.sock.close()
            except OSError:
                pass
        return len(clients)

    def stop(self) -> None:
        """Stop listening and drop every connection; :meth:`start` comes
        back on the same ports."""
        servers, self._servers = self._servers, []
        for server, t in servers:
            server.shutdown()
            server.server_close()
            t.join(timeout=5)
        self.drop_connections()
