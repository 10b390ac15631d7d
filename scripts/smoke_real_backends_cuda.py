"""Opt-in smoke test of the port against REAL SaaS backends.

The port's counterpart of ``scripts/smoke_real_backends.py``. Every
PostgREST and Redis code path of the port is proven against in-repo
fakes (``tests/fake_postgrest.py``, ``tests/fake_redis.py``); the
reference runs against live Supabase and Upstash
(``Flaskr/routes.py:15-23``, ``Flaskr/__init__.py:25``). This script is
the integration rung for operators who have credentials: it drives the
client classes the port's server uses (``serve/store.py``'s
``PostgRESTStore``, ``serve/bus.py``'s ``RedisBus`` over the port's own
RESP2 client), verifies read after write, and cleans up after itself.
It imports neither JAX nor the JAX package, and needs no card.

Usage (each section runs only when its variables are set; otherwise it
reports SKIP, and a run with every section skipped exits 0):

    SUPABASE_URL=https://<proj>.supabase.co \\
    SUPABASE_SERVICE_ROLE_KEY=<service-role-key> \\
    REDIS_URL=rediss://default:<password>@<host>:6379 \\
    python scripts/smoke_real_backends_cuda.py

Exit status: 0 = every attempted section passed (or all skipped),
1 = any attempted section failed.
"""

from __future__ import annotations

import json
import os
import sys
import time
import uuid

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def smoke_postgrest(url: str, key: str) -> dict:
    """insert → get → list(+engine filter) → delete → verify gone, via
    the port's PostgRESTStore."""
    from routest_tpu_torch.serve.store import PostgRESTStore

    store = PostgRESTStore(url, key)
    if not store.ping():
        return {"status": "fail", "error": "ping failed (url/key/table?)"}
    # origin_id is a NOT NULL FK onto locations: prefer a row that
    # exists in the target database, falling back to the deterministic
    # seed ids (schema.sql and data/locations.py mirror the reference's
    # seeder, so a seeded Supabase has them).
    try:
        _, rows = store._send("GET", "locations", store._timeout,
                              params={"select": "id", "limit": "1"})
        origin_id = (rows or [{}])[0].get("id")
    except (OSError, ValueError, AttributeError, IndexError):
        origin_id = None
    if not origin_id:
        from routest_tpu_torch.data.locations import locations_table

        origin_id = locations_table()[0]["id"]
    marker = f"smoke-{uuid.uuid4()}"
    req_id = None
    try:
        req_id = store.insert_request({
            "origin_id": origin_id,
            "stops": {"destination_ids": [],
                      "destination_points": [{"lat": 14.58, "lon": 121.04}]},
            "status": "completed",
            "engine": "smoke_real_backends",
            "vehicle_id": marker,
            "driver_age": 30,
        })
        store.insert_result({
            "request_id": req_id,
            "total_distance": 1.0,
            "total_duration": 2.0,
            "optimized_order": [0],
            "legs": [],
            "geometry": {"type": "LineString", "coordinates": []},
            "eta_minutes_ml": None,
        })
        got = store.get_request(req_id)
        if not got or got.get("vehicle_id") != marker:
            return {"status": "fail", "error": "read-after-write mismatch",
                    "request_id": req_id, "got": got}
        hist = store.list_history(limit=5, engine="smoke_real_backends")
        if not any(h.get("id") == req_id for h in hist):
            return {"status": "fail",
                    "error": "engine-filtered history missed the row",
                    "request_id": req_id}
        return {"status": "ok", "request_id": req_id}
    finally:
        if req_id is not None:
            deleted = store.delete_request(req_id)
            if store.get_request(req_id) is not None:
                print(f"  WARNING: cleanup left row {req_id} "
                      f"(delete={deleted})", file=sys.stderr)


def smoke_redis(url: str) -> dict:
    """publish → subscribe round trip via the port's RedisBus. No sleep
    between the two: ``subscribe`` returns once the server has confirmed
    the ``SUBSCRIBE``."""
    from routest_tpu_torch.serve.bus import RedisBus

    bus = RedisBus(url)
    try:
        if not bus.ping():
            return {"status": "fail",
                    "error": f"redis ping failed ({bus.last_error})"}
        channel = f"smoke:{uuid.uuid4()}"
        payload = {"smoke": True, "ts": time.time()}
        with bus.subscribe(channel) as sub:
            bus.publish(channel, payload)
            deadline = time.time() + 10
            msg = None
            while msg is None and time.time() < deadline:
                msg = sub.get(timeout=1.0)
    finally:
        bus.close()
    if not (isinstance(msg, dict) and msg.get("smoke") is True):
        return {"status": "fail", "error": f"payload mismatch: {msg!r}"}
    return {"status": "ok"}


def main() -> int:
    sections = {}
    url = os.environ.get("SUPABASE_URL")
    key = os.environ.get("SUPABASE_SERVICE_ROLE_KEY")
    if url and key:
        print("PostgREST: driving real backend…", flush=True)
        try:
            sections["postgrest"] = smoke_postgrest(url, key)
        except Exception as e:  # noqa: BLE001 - smoke report, not a crash
            sections["postgrest"] = {"status": "fail",
                                     "error": f"{type(e).__name__}: {e}"}
    else:
        sections["postgrest"] = {
            "status": "skip",
            "reason": "SUPABASE_URL / SUPABASE_SERVICE_ROLE_KEY not set"}

    redis_url = os.environ.get("REDIS_URL")
    if redis_url and redis_url.startswith(("redis://", "rediss://")):
        print("Redis: driving real backend…", flush=True)
        try:
            sections["redis"] = smoke_redis(redis_url)
        except Exception as e:  # noqa: BLE001
            sections["redis"] = {"status": "fail",
                                 "error": f"{type(e).__name__}: {e}"}
    else:
        sections["redis"] = {"status": "skip",
                             "reason": "REDIS_URL not set (redis:// or "
                                       "rediss://)"}

    print(json.dumps(sections, indent=2))
    return 1 if any(s["status"] == "fail" for s in sections.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
