"""Auth: the Laravel Breeze capability, token-based and hermetic.

The counterpart of ``routest_tpu/serve/auth.py``, on the port's WSGI
layer (``serve/wsgi.py``'s ``Request.cookies`` and
``Response.set_cookie``). The reference ships Laravel's stock Breeze
API scaffold (``routes/auth.php:11-36`` +
``app/Http/Controllers/Auth/*`` — register,
login, logout, forgot/reset password, email verification) guarding
``GET /api/user`` via Sanctum (``routes/api.php:11-14``). At runtime the
reference bypasses it entirely (SURVEY.md §1: Flask talks to Supabase
directly), but the capability is part of the component inventory, so it
exists here as a first-class serving module:

- personal-access-token auth (Sanctum's API mode): ``Authorization:
  Bearer <token>`` issued at register/login, revoked at logout;
- PBKDF2-HMAC-SHA256 password hashing (Laravel uses bcrypt; same
  contract, stdlib-only);
- password reset and email verification flows are hermetic BY DEFAULT:
  where Breeze emails a link, these endpoints RETURN the token/link
  payload directly — no SMTP dependency, same state machine. The
  verify-email URL carries Laravel's two path ingredients (user id +
  sha1(email)) AND is signed like Laravel's ``signed`` middleware: an
  ``expires`` timestamp plus an HMAC-SHA256 ``signature`` over a server
  secret (``ROUTEST_APP_KEY``, else a per-process random key), so a
  link cannot be forged from a known email or replayed after expiry.
  Exception: under ``ROUTEST_AUTH=require`` the reset
  token is written to the server log instead of the response, so the
  bearer gate cannot be bypassed by an anonymous forgot-password call.
  With a mail transport configured (``serve/mail.py``,
  ``ROUTEST_MAIL_FILE``), both flows instead deliver the secret by
  mail only — the reference's mail-driver behavior.

Status-code parity with Breeze: validation failures are 422 (including
bad credentials — Laravel's ValidationException), missing/invalid
bearer tokens are 401, logout and verification success are 204/200.

Auth stays OFF the data-plane endpoints by default (the reference's
runtime behavior). ``ROUTEST_AUTH=require`` turns on bearer enforcement
for the destructive route (``DELETE /api/history/<id>``), the gate the
reference never built.
"""

from __future__ import annotations

import datetime as dt
import hashlib
import hmac
import os
import secrets
import threading
import time
import uuid
from typing import Dict, Optional, Tuple

from routest_tpu_torch.utils.logging import get_logger

_PBKDF2_ITERS = 60_000
_RESET_TTL_S = 3600.0
_MAX_TOKENS_PER_USER = 16  # oldest sessions evicted beyond this


def _hash_password(password: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password.encode(), salt, _PBKDF2_ITERS)


def verify_email_hash(email: str) -> str:
    """Laravel's verification-URL hash ingredient: sha1 of the email."""
    return hashlib.sha1(email.encode()).hexdigest()


class AuthService:
    """In-memory user/token store with the Breeze state machine.

    Thread-safe (the dev server is threaded); hermetic by design, like
    ``InMemoryStore`` — a PostgREST-backed variant would slot in behind
    the same interface the way ``store.py`` does it.
    """

    # Signed verify-email links stay valid this long (Laravel's default
    # is 60 minutes — ``Auth/VerifyEmail::verificationUrl``).
    VERIFY_TTL_S = 3600.0

    def __init__(self, required: bool = False,
                 secret: Optional[str] = None) -> None:
        self.required = required
        # Signing key for verification URLs. A per-process random key is
        # the hermetic default (links survive as long as the process, like
        # every other in-memory credential here); set ROUTEST_APP_KEY for
        # links that survive restarts / multi-replica fleets.
        self._secret = (secret or os.environ.get("ROUTEST_APP_KEY")
                        or secrets.token_hex(32)).encode()
        self._lock = threading.Lock()
        self._users: Dict[str, dict] = {}          # email -> user row
        self._tokens: Dict[str, str] = {}          # bearer token -> email
        self._resets: Dict[str, Tuple[str, float]] = {}  # token -> (email, expiry)
        self._attempts: Dict[str, Tuple[int, float]] = {}  # throttle key -> (count, window expiry)

    # ── registration / login ───────────────────────────────────────────

    def register(self, name: str, email: str, password: str) -> Tuple[dict, str]:
        """Create a user and issue a token. Raises ValueError on invalid
        input or duplicate email (both 422 in Breeze)."""
        if not name or not email or "@" not in email:
            raise ValueError("name and a valid email are required")
        if not password or len(password) < 8:
            raise ValueError("password must be at least 8 characters")
        # Hash outside the lock: PBKDF2 is tens of ms and must not
        # serialize every concurrent auth operation behind it.
        salt = secrets.token_bytes(16)
        password_hash = _hash_password(password, salt)
        with self._lock:
            if email in self._users:
                raise ValueError("email already registered")
            user = {
                "id": str(uuid.uuid4()),
                "name": name,
                "email": email,
                "salt": salt,
                "password_hash": password_hash,
                "email_verified_at": None,
                "created_at": dt.datetime.now(dt.timezone.utc).isoformat(),
            }
            self._users[email] = user
            token = self._issue_token_locked(email)
        return self._public(user), token

    # Breeze login throttling (reference
    # ``app/Http/Requests/Auth/LoginRequest.php:45-70``): 5 attempts per
    # email+source key, 60 s decay window, lockout surfaces the seconds
    # remaining; a successful login clears the key.
    THROTTLE_ATTEMPTS = 5
    THROTTLE_DECAY_S = 60.0

    def _throttle_check(self, key: str, now: float) -> None:
        count, expires = self._attempts.get(key, (0, 0.0))
        if expires <= now:
            return
        if count >= self.THROTTLE_ATTEMPTS:
            seconds = max(1, int(expires - now))
            raise ValueError(
                f"too many login attempts. please try again in "
                f"{seconds} seconds")

    def _throttle_hit(self, key: str, now: float) -> None:
        if len(self._attempts) > 10_000:
            # Unauthenticated attackers control the key space (junk
            # emails): purge lapsed windows, and if a live flood keeps
            # the table over the cap anyway, HARD-evict the soonest-to-
            # expire half. The cost is forgetting some attackers'
            # counters early — bounded memory wins; the O(n log n)
            # amortizes to O(log n) per hit (one sort per ~5k inserts).
            self._attempts = {k: v for k, v in self._attempts.items()
                              if v[1] > now}
            if len(self._attempts) > 10_000:
                keep = sorted(self._attempts.items(),
                              key=lambda kv: kv[1][1], reverse=True)[:5_000]
                self._attempts = dict(keep)
        count, expires = self._attempts.get(key, (0, 0.0))
        if expires <= now:  # window lapsed: start a fresh one
            count, expires = 0, now + self.THROTTLE_DECAY_S
        self._attempts[key] = (count + 1, expires)

    def login(self, email: str, password: str,
              source: str = "", now: Optional[float] = None) -> Tuple[dict, str]:
        """Raises ValueError on bad credentials (Breeze: 422 auth.failed)
        or on lockout (Breeze throttle, ``LoginRequest.php:62-70``).
        ``source`` is the caller's network identity (Breeze keys the
        limiter by email|ip so one address can't lock out a victim's
        account globally)."""
        now = time.time() if now is None else now
        key = f"{(email or '').lower()}|{source}"
        with self._lock:
            self._throttle_check(key, now)
            user = self._users.get(email or "")
            # Snapshot the credentials; hash outside the lock (see register).
            salt = user["salt"] if user else b"\0" * 16
            want = user["password_hash"] if user else b""
        got = _hash_password(password or "", salt)
        if user is None or not hmac.compare_digest(want, got):
            with self._lock:
                self._throttle_hit(key, now)
            raise ValueError("these credentials do not match our records")
        with self._lock:
            # Password may have rotated between hash and issue; re-check.
            current = self._users.get(email)
            if current is None or current["password_hash"] != want:
                self._throttle_hit(key, now)
                raise ValueError("these credentials do not match our records")
            token = self._issue_token_locked(email)
            self._attempts.pop(key, None)  # success clears the limiter
        return self._public(user), token

    def logout(self, token: str) -> bool:
        with self._lock:
            return self._tokens.pop(token, None) is not None

    def user_for_token(self, token: Optional[str]) -> Optional[dict]:
        with self._lock:
            email = self._tokens.get(token or "")
            user = self._users.get(email) if email else None
            return self._public(user) if user else None

    def user_from_request(self, request) -> Optional[dict]:
        """Resolve the request's identity: bearer token first (Sanctum
        API mode), else the session cookie (Sanctum stateful SPA mode,
        ``laravel/bootstrap/app.php:14-21``). Cookie-sourced identity
        on an UNSAFE method additionally requires the double-submit
        CSRF proof — the ``X-XSRF-TOKEN`` header must equal the
        ``XSRF-TOKEN`` cookie the SPA read (Sanctum's
        ``EnsureFrontendRequestsAreStateful`` behavior)."""
        user = self.user_for_token(bearer_token(request))
        if user is not None:
            return user
        token = request.cookies.get(SESSION_COOKIE)
        if not token:
            return None
        user = self.user_for_token(token)
        if user is None:
            return None
        if request.method not in ("GET", "HEAD", "OPTIONS") \
                and not _csrf_ok(request):
            return None
        return user

    # ── password reset ─────────────────────────────────────────────────

    def forgot_password(self, email: str, *, now: Optional[float] = None) -> Optional[str]:
        """Issue a reset token; None for unknown emails (Breeze responds
        identically either way, to avoid account enumeration)."""
        t = now or time.time()
        with self._lock:
            # Prune expired entries and invalidate the user's previous
            # token (Laravel keeps at most one live reset per user) —
            # keeps _resets bounded on a long-running server.
            self._resets = {k: v for k, v in self._resets.items()
                            if v[1] > t and v[0] != email}
            if email not in self._users:
                return None
            token = secrets.token_urlsafe(32)
            self._resets[token] = (email, t + _RESET_TTL_S)
            return token

    def reset_password(self, token: str, email: str, password: str,
                       *, now: Optional[float] = None) -> None:
        """Raises ValueError on invalid/expired/mismatched token."""
        if not password or len(password) < 8:
            raise ValueError("password must be at least 8 characters")
        salt = secrets.token_bytes(16)
        password_hash = _hash_password(password, salt)  # outside the lock
        with self._lock:
            entry = self._resets.get(token or "")
            if entry is None or entry[0] != email or (now or time.time()) > entry[1]:
                raise ValueError("this password reset token is invalid")
            del self._resets[token]
            user = self._users[email]
            user["salt"] = salt
            user["password_hash"] = password_hash
            # Laravel revokes existing sessions on reset.
            for t in [t for t, e in self._tokens.items() if e == email]:
                del self._tokens[t]

    # ── email verification ─────────────────────────────────────────────

    def _verify_signature(self, user_id: str, email_hash: str,
                          expires: int) -> str:
        msg = f"{user_id}|{email_hash}|{expires}".encode()
        return hmac.new(self._secret, msg, hashlib.sha256).hexdigest()

    def signed_verify_url(self, user_id: str, email: str,
                          *, now: Optional[float] = None) -> str:
        """Laravel-style signed verification URL: the two path
        ingredients (id + sha1(email)) plus ``expires`` and an
        HMAC-SHA256 ``signature`` over the server secret covering all
        three — tampering with any component invalidates the link."""
        expires = int((time.time() if now is None else now)
                      + self.VERIFY_TTL_S)
        email_hash = verify_email_hash(email)
        sig = self._verify_signature(user_id, email_hash, expires)
        return (f"/api/auth/verify-email/{user_id}/{email_hash}"
                f"?expires={expires}&signature={sig}")

    def verify_email(self, token: str, user_id: str, email_hash: str,
                     expires: Optional[str] = None,
                     signature: Optional[str] = None,
                     *, now: Optional[float] = None) -> bool:
        """Mark the bearer's email verified. The link must carry a
        valid, unexpired HMAC signature (Laravel's signed-URL check) on
        top of the id+hash match — ``sha1(email)`` alone is forgeable
        by anyone who knows the address."""
        try:
            exp = int(expires or "")
        except ValueError:
            raise ValueError("invalid verification link")
        # Signature check BEFORE expiry: a tampered link reads as
        # invalid, not expired, regardless of its claimed timestamp.
        want = self._verify_signature(user_id, email_hash, exp)
        if not hmac.compare_digest(want, signature or ""):
            raise ValueError("invalid verification link")
        if (time.time() if now is None else now) > exp:
            raise ValueError("verification link expired")
        with self._lock:
            email = self._tokens.get(token or "")
            user = self._users.get(email) if email else None
            if user is None:
                raise PermissionError("unauthenticated")
            if user["id"] != user_id or \
                    not hmac.compare_digest(verify_email_hash(email), email_hash):
                raise ValueError("invalid verification link")
            user["email_verified_at"] = dt.datetime.now(dt.timezone.utc).isoformat()
            return True

    # ── helpers ────────────────────────────────────────────────────────

    def _issue_token_locked(self, email: str) -> str:
        # Cap live sessions per user (dicts iterate in insertion order,
        # so the first matches are the oldest): bounds _tokens on a
        # long-running server instead of growing one entry per login.
        mine = [t for t, e in self._tokens.items() if e == email]
        for stale in mine[: max(0, len(mine) + 1 - _MAX_TOKENS_PER_USER)]:
            del self._tokens[stale]
        token = secrets.token_urlsafe(40)
        self._tokens[token] = email
        return token

    @staticmethod
    def _public(user: dict) -> dict:
        return {k: user[k] for k in
                ("id", "name", "email", "email_verified_at", "created_at")}


# Sanctum SPA-mode cookie names: the XSRF token is readable (the SPA
# echoes it in a header — double submit); the session id is HttpOnly.
XSRF_COOKIE = "XSRF-TOKEN"
SESSION_COOKIE = "routest_session"


def _csrf_ok(request) -> bool:
    """Double-submit proof: X-XSRF-TOKEN header equals the XSRF-TOKEN
    cookie. Compared as bytes — ``hmac.compare_digest`` raises on
    non-ASCII str, and both values are attacker-controlled, so a weird
    byte must mean 401, never a 500."""
    cookie = request.cookies.get(XSRF_COOKIE, "")
    header = request.header("X-XSRF-TOKEN")
    return bool(cookie) and hmac.compare_digest(
        cookie.encode("utf-8", "surrogateescape"),
        header.encode("utf-8", "surrogateescape"))


def secure_cookies(request) -> bool:
    """Whether session/XSRF cookies should carry ``Secure`` (a session
    cookie without it leaks over any plain-HTTP subresource).
    True when the request arrived over HTTPS — directly or behind a
    TLS-terminating proxy (``X-Forwarded-Proto``) — or when
    ``ROUTEST_SECURE_COOKIES`` forces it for deploys whose proxy strips
    forwarding headers."""
    if os.environ.get("ROUTEST_SECURE_COOKIES"):
        return True
    return (request.scheme == "https"
            or request.header("X-Forwarded-Proto") == "https")


def bearer_token(request) -> Optional[str]:
    header = request.header("Authorization")
    return header[7:] if header.startswith("Bearer ") else None


UNAUTHENTICATED = ({"message": "unauthenticated"}, 401)


def validation_error(e: Exception):
    """Breeze-shaped 422 with the message keyed under the field it names."""
    msg = str(e)
    field = "password" if "password" in msg else "email"
    return {"message": msg, "errors": {field: [msg]}}, 422


def mount_auth(app, auth: AuthService, mailer=None) -> None:
    """Register the Breeze-parity endpoints on the serving app.

    ``mailer`` (serve/mail.py) is the reference's mail-driver seam:
    when configured, reset tokens and verification links travel by
    mail only — the responses match Breeze's (status strings, no
    secrets), like PasswordResetLinkController / EmailVerification-
    NotificationController behind a real MAIL_MAILER. When None
    (hermetic default), the flows keep their in-band token behavior
    (module docstring)."""
    from routest_tpu_torch.serve.wsgi import Response, get_json, json_response

    @app.route("/sanctum/csrf-cookie", methods=("GET",))
    def csrf_cookie(request):
        # Sanctum's stateful-SPA handshake: the SPA fetches this first;
        # the readable XSRF-TOKEN cookie is echoed back as the
        # X-XSRF-TOKEN header on subsequent unsafe requests.
        resp = Response("", 204)
        resp.set_cookie(XSRF_COOKIE, secrets.token_urlsafe(24),
                        samesite="Lax", path="/",
                        secure=secure_cookies(request))
        return resp

    def _session_login_wanted(request) -> bool:
        """SPA-mode signature on a credential request: the CSRF pair
        (cookie + matching header) is present — bearer-only clients
        never send it, so they keep getting plain token responses."""
        return _csrf_ok(request)

    def _credential_response(request, user, token, status):
        payload = {"user": user, "token": token}
        if not _session_login_wanted(request):
            return payload, status
        # SPA mode: the session ALSO rides an HttpOnly cookie, so the
        # frontend needs no token storage (Sanctum stateful behavior);
        # the body keeps the token for wire-shape compatibility.
        resp = json_response(payload, status)
        resp.set_cookie(SESSION_COOKIE, token, httponly=True,
                        samesite="Lax", path="/",
                        secure=secure_cookies(request))
        return resp

    @app.route("/api/auth/register", methods=("POST",))
    def register(request):
        body = get_json(request) or {}
        try:
            user, token = auth.register(
                str(body.get("name") or ""), str(body.get("email") or ""),
                str(body.get("password") or ""))
        except ValueError as e:
            return validation_error(e)
        return _credential_response(request, user, token, 201)

    @app.route("/api/auth/login", methods=("POST",))
    def login(request):
        body = get_json(request) or {}
        try:
            user, token = auth.login(str(body.get("email") or ""),
                                     str(body.get("password") or ""),
                                     source=request.remote_addr or "")
        except ValueError as e:
            return validation_error(e)
        return _credential_response(request, user, token, 200)

    @app.route("/api/auth/logout", methods=("POST",))
    def logout(request):
        token = bearer_token(request)
        if token is None:
            # cookie-sourced logout is an unsafe method like any other:
            # it needs the double-submit proof (the docstring invariant)
            if not _csrf_ok(request):
                return UNAUTHENTICATED
            token = request.cookies.get(SESSION_COOKIE) or ""
        if not auth.logout(token):
            return UNAUTHENTICATED
        resp = Response("", 204)
        resp.delete_cookie(SESSION_COOKIE, path="/")
        return resp

    @app.route("/api/user", methods=("GET",))
    def current_user(request):
        user = auth.user_from_request(request)
        if user is None:
            return UNAUTHENTICATED
        return user, 200

    @app.route("/api/auth/forgot-password", methods=("POST",))
    def forgot_password(request):
        body = get_json(request) or {}
        token = auth.forgot_password(str(body.get("email") or ""))
        # Hermetic stand-in for the reset email: identical anti-enumeration
        # response either way. The token itself is returned ONLY when auth
        # is not enforced (dev/test convenience); under ROUTEST_AUTH=require
        # handing it to an anonymous caller would let anyone take over any
        # account whose email they know — there it goes to the server log
        # (the "mailbox"), never the HTTP response.
        payload = {"status": "We have emailed your password reset link."}
        if token is not None:
            if mailer is not None:
                # Reference behavior: the token travels by mail only.
                email = str(body.get("email") or "")
                mailer.send(
                    email, "Reset Password Notification",
                    "Use this token with POST /api/auth/reset-password: "
                    + token)
            elif auth.required:
                # JsonLogger json-escapes fields, so an attacker-chosen
                # email cannot inject forged lines into the token stream.
                get_logger("routest.auth").info(
                    "password_reset_token_issued",
                    email=str(body.get("email") or ""), token=token)
            else:
                payload["reset_token"] = token
        return payload, 200

    @app.route("/api/auth/reset-password", methods=("POST",))
    def reset_password(request):
        body = get_json(request) or {}
        try:
            auth.reset_password(str(body.get("token") or ""),
                                str(body.get("email") or ""),
                                str(body.get("password") or ""))
        except ValueError as e:
            return validation_error(e)
        return {"status": "Your password has been reset."}, 200

    @app.route("/api/auth/email/verification-notification", methods=("POST",))
    def send_verification(request):
        user = auth.user_from_request(request)
        if user is None:
            return UNAUTHENTICATED
        verify_url = auth.signed_verify_url(user["id"], user["email"])
        if mailer is not None:
            # Reference behavior: link travels by mail; the response is
            # just the Breeze status string.
            mailer.send(user["email"], "Verify Email Address",
                        "Open this link while authenticated: "
                        + verify_url)
            return {"status": "verification-link-sent"}, 200
        # Hermetic stand-in for the verification email.
        return {"status": "verification-link-sent",
                "verify_url": verify_url}, 200

    @app.route("/api/auth/verify-email/<user_id>/<email_hash>", methods=("GET",))
    def verify_email(request, user_id, email_hash):
        # resolve the token like user_from_request: bearer first, then
        # the SPA session cookie (a GET is safe — no CSRF proof needed),
        # so cookie-mode users can open the link they were mailed
        token = bearer_token(request) \
            or request.cookies.get(SESSION_COOKIE) or ""
        try:
            auth.verify_email(token, user_id, email_hash,
                              expires=request.args.get("expires"),
                              signature=request.args.get("signature"))
        except PermissionError:
            return UNAUTHENTICATED
        except ValueError as e:
            return {"message": str(e)}, 403
        return {"verified": True}, 200
