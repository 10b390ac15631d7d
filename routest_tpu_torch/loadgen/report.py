"""Report assembly: records → a structured, self-describing artifact.

Every section stamps which measurement regime produced it (``"loop":
"open"`` vs ``"closed"``) because the two disagree by construction
under overload — a consumer diffing artifacts must never average an
open-loop p99 with a closed-loop one. Server-side truth rides along as
registry *deltas* (scrape before, scrape after, subtract): cache
hits/misses during the run, shed counts, autoscale decisions — the
counters are cumulative, so the delta is exactly "what this run did".
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, Iterable, List, Optional, Sequence

from routest_tpu_torch.loadgen.engine import RequestRecord


def _percentiles(samples_s: Sequence[float]) -> dict:
    if not samples_s:
        return {}
    ordered = sorted(samples_s)

    def pct(p: float) -> float:
        return ordered[min(len(ordered) - 1, int(p * len(ordered)))] * 1000

    return {"p50_ms": round(pct(0.50), 2), "p95_ms": round(pct(0.95), 2),
            "p99_ms": round(pct(0.99), 2),
            "mean_ms": round(1000 * sum(ordered) / len(ordered), 2),
            "max_ms": round(ordered[-1] * 1000, 2)}


def summarize(records: List[RequestRecord], duration_s: float,
              offered: int, loop: str = "open") -> dict:
    """Aggregate a run: per-route CO-correct percentiles, shed/error
    rates, achieved vs offered rate, and generator health
    (``send_delay``). ``offered`` is the number of scheduled arrivals —
    with an aborted run it exceeds ``len(records)``, and the report
    says so rather than renormalizing it away."""
    ok = [r for r in records if 200 <= r.status < 400]
    shed = [r for r in records if r.status == 429]
    errors = [r for r in records if r.status >= 500 or r.status < 0]
    other_4xx = [r for r in records
                 if 400 <= r.status < 500 and r.status != 429]
    routes: Dict[str, List[RequestRecord]] = {}
    for r in records:
        routes.setdefault(r.route, []).append(r)
    per_route = {}
    for route, rs in sorted(routes.items()):
        rs_ok = [r for r in rs if 200 <= r.status < 400]
        per_route[route] = {
            "sent": len(rs),
            "ok": len(rs_ok),
            "shed": sum(1 for r in rs if r.status == 429),
            "errors": sum(1 for r in rs if r.status >= 500 or r.status < 0),
            "latency": _percentiles([r.latency_s for r in rs_ok]),
        }
        if loop == "open":
            per_route[route]["service_latency"] = _percentiles(
                [r.service_s for r in rs_ok])
    total = len(records)
    out = {
        "loop": loop,
        "offered": offered,
        "sent": total,
        "ok": len(ok),
        "shed": len(shed),
        "errors": len(errors),
        "other_4xx": len(other_4xx),
        "shed_rate": round(len(shed) / max(1, total), 4),
        "error_rate": round(len(errors) / max(1, total), 4),
        "duration_s": round(duration_s, 2),
        "offered_rps": round(offered / duration_s, 2) if duration_s else 0.0,
        "achieved_rps": round(len(ok) / duration_s, 2) if duration_s
        else 0.0,
        "latency": _percentiles([r.latency_s for r in ok]),
        "routes": per_route,
    }
    if loop == "open" and records:
        out["send_delay"] = _percentiles([r.send_delay_s for r in records])
        out["service_latency"] = _percentiles([r.service_s for r in ok])
    return out


def timeline(records: Iterable[RequestRecord],
             bucket_s: float = 1.0) -> List[dict]:
    """Per-second buckets of ok/shed/err by scheduled offset — the
    x-axis a flash-crowd plot wants."""
    buckets: Dict[int, dict] = {}
    for r in records:
        b = buckets.setdefault(int(r.offset_s / bucket_s),
                               {"ok": 0, "shed": 0, "err": 0})
        if 200 <= r.status < 400:
            b["ok"] += 1
        elif r.status == 429:
            b["shed"] += 1
        else:
            b["err"] += 1
    return [{"t": t * bucket_s, **buckets[t]} for t in sorted(buckets)]


# ── server-side registry deltas ──────────────────────────────────────

def fetch_metrics(base: str, replicas: bool = False,
                  timeout: float = 10.0) -> dict:
    """GET ``/api/metrics`` JSON (gateway or replica). ``replicas=1``
    embeds per-worker registries when ``base`` is a gateway."""
    path = "/api/metrics" + ("?replicas=1" if replicas else "")
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as resp:
        return json.loads(resp.read())


def _family_total(registry: Optional[dict], family: str) -> float:
    fam = (registry or {}).get(family)
    if not fam:
        return 0.0
    total = 0.0
    for series in fam.get("series", []):
        total += series.get("value", series.get("count", 0.0)) or 0.0
    return total


def registry_totals(metrics: dict, families: Sequence[str]) -> dict:
    """Sum each family across this process AND embedded replica
    registries (``?replicas=1`` shape) → {family: total}."""
    registries = [metrics.get("registry")]
    for rep in (metrics.get("replica_metrics") or {}).values():
        if isinstance(rep, dict):
            registries.append(rep.get("registry"))
    return {f: sum(_family_total(reg, f) for reg in registries)
            for f in families}


CACHE_FAMILIES = ("rtpu_cache_hits_total", "rtpu_cache_misses_total",
                  "rtpu_cache_coalesced_total", "rtpu_cache_bypass_total")


def cache_delta(before: dict, after: dict) -> dict:
    """Fast-lane cache activity attributable to one run: deltas of the
    fast lane's counters plus the implied hit rate. ``before``/``after`` are
    ``fetch_metrics(..., replicas=True)`` snapshots."""
    b = registry_totals(before, CACHE_FAMILIES)
    a = registry_totals(after, CACHE_FAMILIES)
    delta = {f.replace("rtpu_cache_", "").replace("_total", ""):
             round(a[f] - b[f], 1) for f in CACHE_FAMILIES}
    looked = delta["hits"] + delta["misses"]
    delta["hit_rate"] = round(delta["hits"] / looked, 4) if looked else None
    return delta
