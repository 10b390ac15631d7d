"""Persistence of route requests and results: the in-memory backend.

The counterpart of the memory half of ``routest_tpu/serve/store.py``.
Schema follows the Laravel migrations plus the runtime drift the Flask
service writes (SURVEY.md §2.2): ``route_requests`` (origin_id, stops,
status, engine, vehicle_id, driver_age, request_time) and
``route_results`` (request_id with cascading delete, total_distance,
total_duration, optimized_order, legs, geometry, eta_minutes_ml,
eta_completion_time_ml). The PostgREST backend and the resilience and
tracing wrappers are not ported yet, so :func:`make_store` refuses a
configured Supabase backend rather than serve from memory in its place.
"""

from __future__ import annotations

import datetime as dt
import threading
import uuid
from typing import Dict, List, Optional, Protocol


class StoreUnavailable(RuntimeError):
    """The store cannot serve right now: fail fast instead of stacking
    timeouts against a dead backend. Read handlers surface this as an
    explicit ``degraded: true`` response marker."""


class Store(Protocol):
    def insert_request(self, row: Dict) -> str: ...
    def insert_result(self, row: Dict) -> None: ...
    def list_history(self, limit: int,
                     engine: Optional[str] = None) -> List[Dict]: ...
    def get_request(self, req_id: str) -> Optional[Dict]: ...
    def delete_request(self, req_id: str) -> bool: ...
    def ping(self) -> bool: ...
    @property
    def kind(self) -> str: ...


def _now_iso() -> str:
    return dt.datetime.now(dt.timezone.utc).isoformat()


class InMemoryStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._requests: Dict[str, Dict] = {}
        self._results: Dict[str, List[Dict]] = {}

    def insert_request(self, row: Dict) -> str:
        # A caller-supplied id is honored, as PostgREST would.
        req_id = str(row.get("id") or uuid.uuid4())
        with self._lock:
            self._requests[req_id] = {
                "request_time": _now_iso(),
                **row,
                "id": req_id,
            }
        return req_id

    def insert_result(self, row: Dict) -> None:
        result = {"id": str(uuid.uuid4()), "created_at": _now_iso(), **row}
        with self._lock:
            req_id = row.get("request_id")
            if req_id not in self._requests:
                raise KeyError(f"route_requests.{req_id} does not exist")
            self._results.setdefault(req_id, []).append(result)

    def list_history(self, limit: int,
                     engine: Optional[str] = None) -> List[Dict]:
        with self._lock:
            rows = sorted(self._requests.values(),
                          key=lambda r: r["request_time"], reverse=True)
            if engine is not None:
                rows = [r for r in rows if r.get("engine") == engine]
            rows = rows[:limit]
            return [
                {**r, "route_results": list(self._results.get(r["id"], ()))}
                for r in rows
            ]

    def get_request(self, req_id: str) -> Optional[Dict]:
        with self._lock:
            r = self._requests.get(req_id)
            if r is None:
                return None
            return {**r, "route_results": list(self._results.get(req_id, ()))}

    def delete_request(self, req_id: str) -> bool:
        with self._lock:
            existed = req_id in self._requests
            self._requests.pop(req_id, None)
            self._results.pop(req_id, None)  # FK cascade
            return existed

    def ping(self) -> bool:
        return True

    @property
    def kind(self) -> str:
        return "memory"


def make_store(supabase_url: Optional[str],
               service_key: Optional[str]) -> Store:
    """The in-memory store. With a Supabase URL and key both configured
    this raises: the PostgREST backend is not ported, and serving from
    memory instead would quietly drop every write the operator meant to
    keep."""
    if supabase_url and service_key:
        raise RuntimeError(
            "make_store: a Supabase backend is configured (SUPABASE_URL, "
            "SUPABASE_SERVICE_ROLE_KEY) but the PostgREST store is not "
            "ported yet; unset them to serve history from memory")
    return InMemoryStore()
