"""Auth: the port's ``serve/auth.py``, ``serve/mail.py`` and the cookie
half of ``serve/wsgi.py`` against the JAX package's.

Every flow of ``tests/test_auth.py`` runs on the port's app with that
test's assertions, and the same request sequence runs on the JAX app;
the two transcripts must agree request by request: status, JSON with
random values (tokens, ids, timestamps, links) reduced to their type and
the throttle's seconds masked, and each ``Set-Cookie`` line parsed into
its name, the shape of its value and its attributes. On the default
config the port answers the auth routes the JAX app answers (they were
404 before auth was ported). The ``AuthService`` and mailer unit cases
of ``tests/test_auth.py`` run against the port's classes, and the
port's cookies are held to werkzeug's ``dump_cookie``."""

import json
import os
import re
import stat
from urllib.parse import parse_qs, urlsplit

import jax
import pytest
from werkzeug.http import dump_cookie
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.core.dtypes import F32_POLICY
from routest_tpu.models.eta_mlp import EtaMLP
from routest_tpu.serve import auth as jauth
from routest_tpu.serve import mail as jmail
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu.train.checkpoint import save_model
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.serve import auth as tauth
from routest_tpu_torch.serve import mail as tmail
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService
from routest_tpu_torch.serve.wsgi import App, Response

BUCKETS = (8,)


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("model") / "eta.msgpack")
    model = EtaMLP(hidden=(8,), policy=F32_POLICY)
    save_model(path, model, model.init(jax.random.PRNGKey(0)))
    return (JEtaService(JServeConfig(batch_buckets=BUCKETS), model_path=path),
            EtaService(ServeConfig(batch_buckets=BUCKETS), model_path=path,
                       device="cpu"))


class _Pkg:
    def __init__(self, name, auth_mod, mail_mod):
        self.name, self.auth, self.mail = name, auth_mod, mail_mod


JAX, PORT = _Pkg("jax", jauth, jmail), _Pkg("port", tauth, tmail)

# JSON values that are random per run: compared by type only.
_RANDOM_KEYS = {"token", "id", "created_at", "email_verified_at",
                "reset_token", "verify_url", "request_id"}


def _shape(value, key=None):
    if isinstance(value, dict):
        return {k: _shape(v, k) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(v) for v in value]
    if key in _RANDOM_KEYS:
        return ("random", type(value).__name__)
    if isinstance(value, str):
        return re.sub(r"\d+ seconds", "N seconds", value)
    return value


_TOKEN_RE = re.compile(r"[A-Za-z0-9_-]+")


def _cookie(line):
    """``Set-Cookie`` → (name, value shape, attributes)."""
    first, *attrs = line.split("; ")
    name, value = first.split("=", 1)
    if value:
        assert _TOKEN_RE.fullmatch(value), line
        value = "token"
    return name, value, attrs


class _Recorder:
    """A test client that keeps one transcript entry per response."""

    def __init__(self, app):
        self.client = Client(app)
        self.transcript = []

    def _record(self, method, path, r):
        body = r.get_data()
        ctype = r.headers.get("Content-Type", "")
        payload = (_shape(json.loads(body))
                   if body and ctype.startswith("application/json")
                   else body.decode("latin-1"))
        if path == "/api/optimize_route":
            # the route itself is the optimize tests' business
            payload = sorted(payload)
        self.transcript.append((
            method, re.sub(r"/[0-9a-f-]{36}", "/<id>", path.split("?")[0]),
            r.status_code, payload,
            [_cookie(c) for c in r.headers.getlist("Set-Cookie")]))
        return r

    def get(self, path, **kw):
        return self._record("GET", path, self.client.get(path, **kw))

    def post(self, path, **kw):
        return self._record("POST", path, self.client.post(path, **kw))

    def delete(self, path, **kw):
        return self._record("DELETE", path, self.client.delete(path, **kw))

    def cookie(self, name):
        return self.client.get_cookie(name)


def _apps(services, pkg_kw=lambda pkg: {}):
    jsvc, tsvc = services
    japp = jax_create_app(JConfig(), eta_service=jsvc, **pkg_kw(JAX))
    tapp = create_app(Config(serve=ServeConfig(device="cpu")),
                      eta_service=tsvc, **pkg_kw(PORT))
    return japp, tapp


def _run(services, flow, pkg_kw=lambda pkg: {}):
    """The flow on both apps → the two transcripts, which must agree."""
    japp, tapp = _apps(services, pkg_kw)
    try:
        transcripts = []
        for pkg, app in ((JAX, japp), (PORT, tapp)):
            rec = _Recorder(app)
            flow(rec, pkg)
            transcripts.append(rec.transcript)
    finally:
        for app in (japp, tapp):
            if app.dispatch.reopt is not None:
                app.dispatch.reopt.stop()
    jt, tt = transcripts
    assert len(tt) == len(jt)
    for got, want in zip(tt, jt):
        assert got == want


def _register(c, email="ana@example.com", password="s3cretpass"):
    return c.post("/api/auth/register", json={
        "name": "Ana", "email": email, "password": password})


def _csrf_pair(c):
    r = c.get("/sanctum/csrf-cookie")
    assert r.status_code == 204
    cookie = c.cookie("XSRF-TOKEN")
    assert cookie is not None
    return cookie.value


def _bearer(token):
    return {"Authorization": f"Bearer {token}"}


# ── the flows of tests/test_auth.py ──────────────────────────────────


def flow_register_login_user_logout(c, pkg):
    r = _register(c)
    assert r.status_code == 201
    token = r.get_json()["token"]
    assert r.get_json()["user"]["email"] == "ana@example.com"
    assert "password_hash" not in r.get_json()["user"]
    r = c.get("/api/user", headers=_bearer(token))
    assert r.status_code == 200 and r.get_json()["name"] == "Ana"
    r = c.post("/api/auth/login", json={
        "email": "ana@example.com", "password": "s3cretpass"})
    assert r.status_code == 200
    token2 = r.get_json()["token"]
    assert token2 != token
    assert c.post("/api/auth/logout",
                  headers=_bearer(token)).status_code == 204
    assert c.get("/api/user", headers=_bearer(token)).status_code == 401
    assert c.get("/api/user", headers=_bearer(token2)).status_code == 200


def flow_register_validation_and_duplicates(c, pkg):
    assert _register(c, email="bad-email").status_code == 422
    assert _register(c, password="short").status_code == 422
    assert _register(c).status_code == 201
    r = _register(c)
    assert r.status_code == 422 and "errors" in r.get_json()


def flow_login_bad_credentials(c, pkg):
    _register(c)
    for email, password in (("ana@example.com", "wrongpass1"),
                            ("nobody@example.com", "whatever12")):
        assert c.post("/api/auth/login", json={
            "email": email, "password": password}).status_code == 422


def flow_unauthenticated_user_and_logout(c, pkg):
    assert c.get("/api/user").status_code == 401
    assert c.post("/api/auth/logout").status_code == 401
    assert c.get("/api/user", headers=_bearer("bogus")).status_code == 401


def flow_password_reset(c, pkg):
    _register(c)
    r = c.post("/api/auth/forgot-password",
               json={"email": "ana@example.com"})
    assert r.status_code == 200
    token = r.get_json()["reset_token"]
    r = c.post("/api/auth/forgot-password",
               json={"email": "nobody@example.com"})
    assert r.status_code == 200 and "reset_token" not in r.get_json()
    r = c.post("/api/auth/reset-password", json={
        "token": token, "email": "ana@example.com",
        "password": "newpass123"})
    assert r.status_code == 200
    assert c.post("/api/auth/login", json={
        "email": "ana@example.com",
        "password": "s3cretpass"}).status_code == 422
    assert c.post("/api/auth/login", json={
        "email": "ana@example.com",
        "password": "newpass123"}).status_code == 200
    assert c.post("/api/auth/reset-password", json={
        "token": token, "email": "ana@example.com",
        "password": "again12345"}).status_code == 422


def flow_reset_revokes_existing_sessions(c, pkg):
    token = _register(c).get_json()["token"]
    reset = c.post("/api/auth/forgot-password", json={
        "email": "ana@example.com"}).get_json()["reset_token"]
    c.post("/api/auth/reset-password", json={
        "token": reset, "email": "ana@example.com",
        "password": "newpass123"})
    assert c.get("/api/user", headers=_bearer(token)).status_code == 401


def flow_email_verification(c, pkg):
    r = _register(c)
    token = r.get_json()["token"]
    user = r.get_json()["user"]
    assert user["email_verified_at"] is None
    r = c.post("/api/auth/email/verification-notification",
               headers=_bearer(token))
    assert r.status_code == 200
    url = r.get_json()["verify_url"]
    assert pkg.auth.verify_email_hash("ana@example.com") in url
    assert "expires=" in url and "signature=" in url
    assert c.get(url).status_code == 401
    r = c.get(url, headers=_bearer(token))
    assert r.status_code == 200 and r.get_json()["verified"] is True
    r = c.get("/api/user", headers=_bearer(token))
    assert r.get_json()["email_verified_at"] is not None
    bad = f"/api/auth/verify-email/{user['id']}/deadbeef"
    assert c.get(bad, headers=_bearer(token)).status_code == 403


def flow_verify_link_signature_tampering(c, pkg):
    token = _register(c, email="sig@example.com").get_json()["token"]
    hdr = _bearer(token)
    url = c.post("/api/auth/email/verification-notification",
                 headers=hdr).get_json()["verify_url"]
    assert c.get(url.replace("signature=", "signature=0"),
                 headers=hdr).status_code == 403
    stretched = re.sub(r"expires=(\d+)",
                       lambda m: f"expires={int(m.group(1)) + 99999}", url)
    assert c.get(stretched, headers=hdr).status_code == 403
    assert c.get(url.split("?")[0], headers=hdr).status_code == 403
    r = c.get(url, headers=hdr)
    assert r.status_code == 200 and r.get_json()["verified"] is True


def flow_cookies_secure_on_https_or_env(c, pkg):
    r = c.get("/sanctum/csrf-cookie")
    assert "Secure" not in r.headers["Set-Cookie"]
    r = c.get("/sanctum/csrf-cookie", base_url="https://localhost/")
    assert "Secure" in r.headers["Set-Cookie"]
    os.environ["ROUTEST_SECURE_COOKIES"] = "1"
    try:
        r = c.get("/sanctum/csrf-cookie")
        assert "Secure" in r.headers["Set-Cookie"]
    finally:
        del os.environ["ROUTEST_SECURE_COOKIES"]
    xsrf = _csrf_pair(c)
    r = c.post("/api/auth/register",
               json={"name": "S", "email": "sec@example.com",
                     "password": "s3cretpass"},
               headers={"X-XSRF-TOKEN": xsrf, "X-Forwarded-Proto": "https"})
    cookies = r.headers.getlist("Set-Cookie")
    assert any("routest_session" in x and "Secure" in x for x in cookies)


def flow_required_gates_history_delete(c, pkg):
    assert c.delete("/api/history/some-id").status_code == 401
    token = _register(c).get_json()["token"]
    r = c.delete("/api/history/some-id", headers=_bearer(token))
    assert r.status_code == 404


def flow_required_never_returns_reset_token(c, pkg):
    _register(c)
    r = c.post("/api/auth/forgot-password",
               json={"email": "ana@example.com"})
    assert r.status_code == 200 and "reset_token" not in r.get_json()
    r2 = c.post("/api/auth/forgot-password",
                json={"email": "nobody@example.com"})
    assert r.get_json() == r2.get_json()


def flow_second_forgot_invalidates_first(c, pkg):
    _register(c)
    t1, t2 = (c.post("/api/auth/forgot-password", json={
        "email": "ana@example.com"}).get_json()["reset_token"]
        for _ in range(2))
    assert c.post("/api/auth/reset-password", json={
        "token": t1, "email": "ana@example.com",
        "password": "newpass123"}).status_code == 422
    assert c.post("/api/auth/reset-password", json={
        "token": t2, "email": "ana@example.com",
        "password": "newpass123"}).status_code == 200


def flow_auth_off_by_default(c, pkg):
    assert c.delete("/api/history/missing").status_code == 404


def flow_login_throttling_over_http(c, pkg):
    for _ in range(6):
        r = c.post("/api/auth/login", json={
            "email": "nobody@x.com", "password": "wrong"})
        assert r.status_code == 422
    msg = r.get_json()["message"]
    assert "too many login attempts" in msg and "seconds" in msg


def flow_sanctum_cookie_spa(c, pkg):
    xsrf = _csrf_pair(c)
    r = c.post("/api/auth/register",
               json={"name": "Spa", "email": "spa@example.com",
                     "password": "s3cretpass"},
               headers={"X-XSRF-TOKEN": xsrf})
    assert r.status_code == 201
    session = c.cookie("routest_session")
    assert session is not None and session.http_only
    r = c.get("/api/user")
    assert r.status_code == 200
    assert r.get_json()["email"] == "spa@example.com"
    assert c.post("/api/auth/logout",
                  headers={"X-XSRF-TOKEN": xsrf}).status_code == 204
    assert c.get("/api/user").status_code == 401


def flow_unsafe_methods_require_csrf_header(c, pkg):
    xsrf = _csrf_pair(c)
    r = c.post("/api/auth/register",
               json={"name": "C", "email": "csrf@example.com",
                     "password": "s3cretpass"},
               headers={"X-XSRF-TOKEN": xsrf})
    assert r.status_code == 201 and c.cookie("routest_session")
    r = c.post("/api/optimize_route", json={
        "source_point": {"lat": 14.5836, "lon": 121.0409},
        "destination_points": [{"lat": 14.5355, "lon": 121.0621,
                                "payload": 1}],
        "driver_details": {"driver_name": "C", "vehicle_type": "car",
                           "vehicle_capacity": 9999,
                           "maximum_distance": 100000}})
    req_id = r.get_json()["properties"]["request_id"]
    assert c.delete(f"/api/history/{req_id}").status_code == 401
    assert c.delete(f"/api/history/{req_id}",
                    headers={"X-XSRF-TOKEN": "forged"}).status_code == 401
    assert c.delete(f"/api/history/{req_id}",
                    headers={"X-XSRF-TOKEN": xsrf}).status_code == 204


def flow_bearer_clients_get_no_cookies(c, pkg):
    _register(c, email="api@example.com")
    r = c.post("/api/auth/login", json={
        "email": "api@example.com", "password": "s3cretpass"})
    assert r.status_code == 200
    assert "routest_session" not in (r.headers.get("Set-Cookie") or "")
    token = r.get_json()["token"]
    assert c.get("/api/user", headers=_bearer(token)).status_code == 200


def flow_cookie_logout_requires_csrf_proof(c, pkg):
    xsrf = _csrf_pair(c)
    c.post("/api/auth/register", json={
        "name": "L", "email": "lo@example.com", "password": "s3cretpass"},
        headers={"X-XSRF-TOKEN": xsrf})
    assert c.post("/api/auth/logout").status_code == 401
    assert c.post("/api/auth/logout",
                  headers={"X-XSRF-TOKEN": "forged"}).status_code == 401
    assert c.get("/api/user").status_code == 200
    assert c.post("/api/auth/logout",
                  headers={"X-XSRF-TOKEN": xsrf}).status_code == 204


def flow_cookie_session_can_use_verification_link(c, pkg):
    xsrf = _csrf_pair(c)
    c.post("/api/auth/register", json={
        "name": "V", "email": "vc@example.com", "password": "s3cretpass"},
        headers={"X-XSRF-TOKEN": xsrf})
    r = c.post("/api/auth/email/verification-notification",
               headers={"X-XSRF-TOKEN": xsrf})
    assert r.status_code == 200
    r = c.get(r.get_json()["verify_url"])
    assert r.status_code == 200 and r.get_json()["verified"] is True


def flow_non_ascii_csrf_values_yield_401(c, pkg):
    xsrf = _csrf_pair(c)
    c.post("/api/auth/register", json={
        "name": "N", "email": "na@example.com", "password": "s3cretpass"},
        headers={"X-XSRF-TOKEN": xsrf})
    assert c.post("/api/auth/logout",
                  headers={"X-XSRF-TOKEN": "café"}).status_code == 401


_MAILBOX = {}


def _mailer_kw(pkg):
    _MAILBOX[pkg.name] = pkg.mail.MemoryMailer()
    return {"mailer": _MAILBOX[pkg.name]}


def flow_mailer_carries_reset_token(c, pkg):
    mailer = _MAILBOX[pkg.name]
    _register(c, email="mail@example.com")
    r = c.post("/api/auth/forgot-password",
               json={"email": "mail@example.com"})
    assert r.status_code == 200 and "reset_token" not in r.get_json()
    assert len(mailer.messages) == 1
    assert mailer.messages[0]["to"] == "mail@example.com"
    token = mailer.messages[0]["body"].rsplit(" ", 1)[-1]
    assert c.post("/api/auth/reset-password", json={
        "token": token, "email": "mail@example.com",
        "password": "brand-new-pass"}).status_code == 200
    assert c.post("/api/auth/login", json={
        "email": "mail@example.com",
        "password": "brand-new-pass"}).status_code == 200


def flow_mailer_carries_verification_link(c, pkg):
    mailer = _MAILBOX[pkg.name]
    token = _register(c, email="v@example.com").get_json()["token"]
    r = c.post("/api/auth/email/verification-notification",
               headers=_bearer(token))
    assert r.status_code == 200 and "verify_url" not in r.get_json()
    assert mailer.messages[-1]["to"] == "v@example.com"
    url = mailer.messages[-1]["body"].rsplit(" ", 1)[-1]
    r = c.get(url, headers=_bearer(token))
    assert r.status_code == 200 and r.get_json()["verified"] is True


def _required(pkg):
    return {"auth": pkg.auth.AuthService(required=True)}


FLOWS = [
    (flow_register_login_user_logout, None),
    (flow_register_validation_and_duplicates, None),
    (flow_login_bad_credentials, None),
    (flow_unauthenticated_user_and_logout, None),
    (flow_password_reset, None),
    (flow_reset_revokes_existing_sessions, None),
    (flow_email_verification, None),
    (flow_verify_link_signature_tampering, None),
    (flow_cookies_secure_on_https_or_env, None),
    (flow_required_gates_history_delete, _required),
    (flow_required_never_returns_reset_token, _required),
    (flow_second_forgot_invalidates_first, None),
    (flow_auth_off_by_default, None),
    (flow_login_throttling_over_http, None),
    (flow_sanctum_cookie_spa, None),
    (flow_unsafe_methods_require_csrf_header, "env"),
    (flow_bearer_clients_get_no_cookies, None),
    (flow_cookie_logout_requires_csrf_proof, None),
    (flow_cookie_session_can_use_verification_link, None),
    (flow_non_ascii_csrf_values_yield_401, None),
    (flow_mailer_carries_reset_token, _mailer_kw),
    (flow_mailer_carries_verification_link, _mailer_kw),
]


@pytest.mark.parametrize("flow,kw", FLOWS,
                         ids=[f.__name__[5:] for f, _ in FLOWS])
def test_flow_matches_jax(services, monkeypatch, flow, kw):
    monkeypatch.delenv("ROUTEST_SECURE_COOKIES", raising=False)
    monkeypatch.delenv("ROUTEST_MAIL_FILE", raising=False)
    if kw == "env":
        monkeypatch.setenv("ROUTEST_AUTH", "require")
        kw = None
    else:
        monkeypatch.delenv("ROUTEST_AUTH", raising=False)
    _run(services, flow, kw or (lambda pkg: {}))


def test_default_config_answers_the_auth_routes(services, monkeypatch):
    """The default-config repair: every auth route answers in the port
    as in the JAX app (all were 404 before auth was ported)."""
    monkeypatch.delenv("ROUTEST_AUTH", raising=False)

    def flow(c, pkg):
        assert _register(c).status_code == 201
        assert c.get("/sanctum/csrf-cookie").status_code == 204
        assert c.get("/api/user").status_code == 401
        for path in ("/api/auth/login", "/api/auth/logout",
                     "/api/auth/forgot-password",
                     "/api/auth/reset-password",
                     "/api/auth/email/verification-notification"):
            assert c.post(path, json={}).status_code != 404, path
        # an unsigned link is refused before the caller is looked up
        assert c.get("/api/auth/verify-email/u/h").status_code == 403

    _run(services, flow)


# ── the service and mailer on their own (port) ───────────────────────


def test_verify_link_expires_and_secret_scoped():
    auth = tauth.AuthService(secret="server-key")
    user, token = auth.register("E", "e@example.com", "s3cretpass")
    url = auth.signed_verify_url(user["id"], "e@example.com", now=1000.0)
    q = parse_qs(urlsplit(url).query)
    email_hash = tauth.verify_email_hash("e@example.com")
    args = (token, user["id"], email_hash, q["expires"][0],
            q["signature"][0])
    with pytest.raises(ValueError, match="expired"):
        auth.verify_email(*args,
                          now=1000.0 + tauth.AuthService.VERIFY_TTL_S + 1)
    other = tauth.AuthService(secret="attacker-key")
    forged = other.signed_verify_url(user["id"], "e@example.com", now=1000.0)
    fq = parse_qs(urlsplit(forged).query)
    with pytest.raises(ValueError, match="invalid"):
        auth.verify_email(token, user["id"], email_hash,
                          fq["expires"][0], fq["signature"][0], now=1001.0)
    assert auth.verify_email(*args, now=1000.0 + 60) is True
    # the same secret signs the same link in both packages
    jurl = jauth.AuthService(secret="server-key").signed_verify_url(
        user["id"], "e@example.com", now=1000.0)
    assert jurl == url


def test_session_cap_evicts_oldest_token():
    svc = tauth.AuthService()
    _, first = svc.register("Ana", "ana@example.com", "s3cretpass")
    tokens = [svc.login("ana@example.com", "s3cretpass")[1]
              for _ in range(tauth._MAX_TOKENS_PER_USER)]
    assert svc.user_for_token(first) is None
    assert svc.user_for_token(tokens[-1]) is not None
    live = [t for t in [first] + tokens if svc.user_for_token(t)]
    assert len(live) == tauth._MAX_TOKENS_PER_USER


def test_login_throttling_breeze_semantics():
    auth = tauth.AuthService()
    auth.register("n", "t@x.com", "right-password")
    t = 1000.0
    for _ in range(5):
        with pytest.raises(ValueError, match="credentials"):
            auth.login("t@x.com", "wrong", source="1.2.3.4", now=t)
    with pytest.raises(ValueError, match="too many login attempts"):
        auth.login("t@x.com", "right-password", source="1.2.3.4", now=t + 1)
    assert auth.login("t@x.com", "right-password", source="5.6.7.8",
                      now=t + 1)[1]
    assert auth.login("t@x.com", "right-password", source="1.2.3.4",
                      now=t + 61)[1]
    for _ in range(4):
        with pytest.raises(ValueError, match="credentials"):
            auth.login("t@x.com", "wrong", source="1.2.3.4", now=t + 62)
    assert auth.login("t@x.com", "right-password", source="1.2.3.4",
                      now=t + 63)[1]


def test_file_mailer_appends_parseable_lines(tmp_path):
    mbox = str(tmp_path / "mbox.jsonl")
    tmail.FileMailer(mbox).send("a@x.com", "Subject", "Body text")
    tmail.FileMailer(mbox).send("b@x.com", "S2", "B2")
    with open(mbox) as f:
        rows = [json.loads(line) for line in f]
    assert [r["to"] for r in rows] == ["a@x.com", "b@x.com"]
    assert rows[0]["subject"] == "Subject"
    assert stat.S_IMODE(os.stat(mbox).st_mode) == 0o600
    assert tmail.make_mailer({"ROUTEST_MAIL_FILE": mbox}).path == mbox
    assert tmail.make_mailer({}) is None


def test_cors_admits_spa_cookie_mode():
    app = App()

    @app.route("/x", methods=("GET",))
    def x(request):
        return {"ok": True}, 200

    r = Client(app).get("/x", headers={"Origin": "http://localhost:3000"})
    assert r.headers["Access-Control-Allow-Credentials"] == "true"
    assert "X-XSRF-TOKEN" in r.headers["Access-Control-Allow-Headers"]


# ── the WSGI layer's cookies against werkzeug ────────────────────────


@pytest.mark.parametrize("value,kw", [
    ("tok-_123", dict(samesite="Lax", path="/")),
    ("tok", dict(httponly=True, samesite="Lax", path="/", secure=True)),
    ("x y;z\"é", dict(path="/api")),
    ("v", dict(samesite="strict")),
], ids=["xsrf", "session", "quoted", "strict"])
def test_set_cookie_lines_are_werkzeugs(value, kw):
    r = Response("", 204)
    r.set_cookie("c", value, **kw)
    assert r.cookies == [dump_cookie("c", value, **kw)]


def test_delete_cookie_and_repeated_set_cookie_headers():
    app = App()

    @app.route("/two", methods=("GET",))
    def two(request):
        resp = Response("", 204)
        resp.set_cookie("a", "1")
        resp.delete_cookie("routest_session", path="/")
        return resp

    r = Client(app).get("/two")
    assert r.headers.getlist("Set-Cookie") == [
        "a=1; Path=/",
        "routest_session=; Expires=Thu, 01 Jan 1970 00:00:00 GMT; "
        "Max-Age=0; Path=/"]


def test_request_cookies_remote_addr_and_content_type():
    seen = {}
    app = App()

    @app.route("/echo", methods=("POST",))
    def echo(request):
        seen.update(cookies=request.cookies, addr=request.remote_addr,
                    ctype=request.content_type, scheme=request.scheme)
        return {}, 200

    c = Client(app)
    c.set_cookie("XSRF-TOKEN", "abc")
    c.set_cookie("routest_session", "s1")
    c.post("/echo", data=b"x", content_type="application/x-rtpu-wire",
           environ_base={"REMOTE_ADDR": "10.0.0.7"})
    assert seen["cookies"] == {"XSRF-TOKEN": "abc", "routest_session": "s1"}
    assert seen["addr"] == "10.0.0.7"
    assert seen["ctype"] == "application/x-rtpu-wire"
    assert seen["scheme"] == "http"
