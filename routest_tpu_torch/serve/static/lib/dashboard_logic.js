/* Pure logic for the dispatch dashboard (dashboard.html).
 *
 * Everything here is DOM-free and side-effect-free so CI can execute
 * this exact file under the in-repo JS engine
 * (routest_tpu/utils/minijs.py, driven by
 * tests/test_dashboard_logic.py with golden vectors from the live
 * server corpus). dashboard.html loads it first and keeps only
 * fetch/DOM glue inline. Behaviors mirror the reference map app
 * (frontend/map-app/app/ui/page.jsx): projection + polyline split
 * (:1540-1576), optimize payload (:1578-1612), SSE backoff reconnect
 * (:598-672), CSV export (history/page.jsx:73-107), maneuver icons,
 * straight-line/OSRM fallbacks (history/[id]/page.jsx:142-244).
 *
 * Subset contract: ES5 + arrows/template-literals/spread/destructuring;
 * no `new`, no async, no classes, no Date (minijs rejects them at
 * parse time, so an accidental use fails CI loudly).
 */

// ── projection: lon/lat → 1000x700 viewbox (fixed Metro Manila frame) ─
const BOUNDS = { latMin: 14.37, latMax: 14.71, lonMin: 120.93, lonMax: 121.13 };
function px(lonlat) {
  const lon = lonlat[0], lat = lonlat[1];
  const x = (lon - BOUNDS.lonMin) / (BOUNDS.lonMax - BOUNDS.lonMin) * 1000;
  const y = (1 - (lat - BOUNDS.latMin) / (BOUNDS.latMax - BOUNDS.latMin)) * 700;
  return [x, y];
}

// Short label for a location dot ("Quezon City Hall - Main" → "Quezon City Hall")
function locLabel(name) {
  return String(name).replace(/ - .*/, "");
}

// ── route polyline path data (drawRoute's geometry math) ──────────────
// coords: GeoJSON [lon, lat] pairs; remaining: suffix of coords still
// to be driven (SSE remaining_routes), or null. Returns SVG path "d"
// strings: whole route, or the done/remaining split + driver head.
function routePaths(coords, remaining) {
  const path = coords.map(px);
  const d = "M" + path.map(p => p[0].toFixed(1) + "," + p[1].toFixed(1)).join(" L");
  if (!remaining || !remaining.length) return { d };
  // remaining is a suffix of the full polyline; overlap one point so
  // the two strokes join (reference splitter, page.jsx:1542-1576)
  const doneCount = coords.length - remaining.length + 1;
  const dDone = "M" + path.slice(0, doneCount).map(p => p.join(",")).join(" L");
  const dRem = "M" + path.slice(doneCount - 1).map(p => p.join(",")).join(" L");
  const head = path[Math.max(0, doneCount - 1)];
  return { d, dDone, dRem, head, doneCount };
}

// ── great-circle fallback route (tier 3) ──────────────────────────────
function haversineM(a, b) {  // [lon,lat] pairs
  const R = 6371008.8, r = x => x * Math.PI / 180;
  const s = Math.sin(r(b[1] - a[1]) / 2) ** 2 + Math.cos(r(a[1])) *
            Math.cos(r(b[1])) * Math.sin(r(b[0] - a[0]) / 2) ** 2;
  return 2 * R * Math.asin(Math.sqrt(s));
}
function straightLineFeature(src, dests) {
  const pts = [[src.lon, src.lat], ...dests.map(d => [d.lon, d.lat])];
  let dist = 0;
  for (let i = 1; i < pts.length; i++) dist += haversineM(pts[i - 1], pts[i]);
  dist *= 1.3;  // road factor over great-circle
  return { type: "Feature",
    geometry: { type: "LineString", coordinates: pts },
    properties: { engine: "straight-line", source: src,
      destinations: dests, optimized_order: dests.map((_, i) => i),
      segments: [], summary: { distance: dist, duration: dist / 8.3,
                               trips: 1 } } };
}

// ── OSRM fallback (tier 2) — URL builder + response mapper ────────────
function osrmUrl(base, src, dests) {
  const coords = [[src.lon, src.lat], ...dests.map(d => [d.lon, d.lat])]
    .map(c => c.join(",")).join(";");
  return `${base}/route/v1/driving/${coords}?overview=full&geometries=geojson`;
}
function osrmFeature(resp, src, dests) {
  if (!resp || !resp.routes || !resp.routes.length) return null;
  const rt = resp.routes[0];
  return { type: "Feature", geometry: rt.geometry,
    properties: { engine: "osrm-fallback", source: src,
      destinations: dests, optimized_order: dests.map((_, i) => i),
      segments: [], summary: { distance: rt.distance,
                               duration: rt.duration, trips: 1 } } };
}

// ── optimize_route payload (the calculate click's request body) ───────
// form: { originId, origin, picked, vehicle, capacity, maxdist, age,
//         engine, refine, roadgraph, topk, weather, traffic }
// origin/picked are location rows {id, name, latitude, longitude}.
function buildOptimizePayload(form) {
  const useMl = form.engine === "ml";
  return {
    source_point: { lat: form.origin.latitude, lon: form.origin.longitude },
    destination_points: form.picked.map(l =>
      ({ lat: l.latitude, lon: l.longitude, payload: 1, name: l.name })),
    driver_details: {
      driver_name: "Dispatcher", vehicle_type: form.vehicle,
      vehicle_capacity: +form.capacity,
      maximum_distance: +form.maxdist,
      driver_age: +form.age,
    },
    meta: { origin_id: form.originId,
            destination_ids: form.picked.map(l => l.id) },
    refine: !!form.refine,
    road_graph: !!form.roadgraph,
    top_k: +form.topk || undefined,
    use_ml_eta: useMl,
    context: { weather: form.weather, traffic: form.traffic },
  };
}

// ── analytics cards + labels (showFeature's text math) ────────────────
function cardValues(props) {
  const s = props.summary;
  return {
    dist: (s.distance / 1000).toFixed(1),
    dur: (s.duration / 60).toFixed(0),
    eta: props.eta_minutes_ml != null ? props.eta_minutes_ml.toFixed(0) : "–",
    trips: s.trips || 1,
  };
}
function etaCardLabel(props) {
  // Calibrated uncertainty band — present only when the serving model
  // has quantile heads (additive API fields).
  const lo = props.eta_minutes_ml_p10, hi = props.eta_minutes_ml_p90;
  return (lo != null && hi != null)
    ? `ML ETA (min, ${lo.toFixed(0)}–${hi.toFixed(0)} p10–p90)`
    : "ML ETA (min)";
}
function durCardLabel(props) {
  // Which leg pricer produced the durations (road-graph routes only)
  return props.leg_cost_model
    ? `duration (min, ${props.leg_cost_model})` : "duration (min)";
}
function stepText(st) {
  return `${st.instruction} (${(st.distance / 1000).toFixed(2)} km)`;
}
function altRowText(alt, i) {
  return `#${i + 1}: ${(alt.distance / 1000).toFixed(1)} km · ` +
    `${(alt.duration / 60).toFixed(0)} min · order ` +
    alt.optimized_order.map(x => x + 1).join("→");
}

// maneuver icons for the step list (reference page.jsx's step icons)
function maneuverIcon(instruction) {
  const t = (instruction || "").toLowerCase();
  // prefix checks FIRST: instructions embed free-form stop names
  // ("Head east toward Wright Plaza" must not match "right")
  if (t.startsWith("arrive")) return "⚑";
  if (t.startsWith("head") || t.startsWith("depart")) return "➤";
  if (t.startsWith("u-turn") || t.startsWith("make a u-turn")) return "↩";
  if (t.startsWith("turn left") || t.startsWith("left")) return "↰";
  if (t.startsWith("turn right") || t.startsWith("right")) return "↱";
  return "↑";
}

// ── health dots ───────────────────────────────────────────────────────
function healthDotClass(status) {
  return "dot " + (status === "ok" ? "ok"
                   : status === "degraded" ? "warn" : "bad");
}

// ── SSE reconnect backoff: exponential, cap 20 s, + jitter ────────────
function backoffDelay(retry) {
  return Math.min(1000 * 2 ** retry, 20000) + Math.random() * 400;
}

// ── history CSV (last 100 requests; reference history/page.jsx:73-107) ─
const CSV_COLS = ["request_id", "created_at", "origin_id", "dest_count",
                  "total_distance", "total_duration", "engine",
                  "eta_minutes_ml", "eta_completion_time_ml"];
function csvEscape(v) {
  return v == null ? "" : /[",\n]/.test(String(v))
    ? '"' + String(v).replace(/"/g, '""') + '"' : String(v);
}
function historyCsv(items) {
  return [CSV_COLS.join(",")].concat(
    (items || []).map(it => CSV_COLS.map(c => csvEscape(it[c])).join(","))
  ).join("\n");
}

// ── history detail → map feature (persisted-geometry branch) ──────────
function persistedFeature(detail, src, stops) {
  const res = detail.result;
  if (!res || !res.geometry) return null;
  return { geometry: res.geometry, properties: {
    source: src, destinations: stops,
    optimized_order: res.optimized_order || [],
    segments: res.legs || [],
    summary: { distance: res.total_distance,
               duration: res.total_duration },
    eta_minutes_ml: res.eta_minutes_ml } };
}

// history row summary text pieces (time rendering stays page-side —
// toLocaleTimeString is locale/DOM territory)
function historyRowParts(it) {
  return {
    stops: `${it.dest_count} stops`,
    km: `${((it.total_distance || 0) / 1000).toFixed(1)} km`,
    ml: it.engine === "ml",
  };
}

// ── auth dialog decision table (login → maybe register) ───────────────
// Pure plan step so the retry/register branching is testable: given the
// login HTTP status, decide the next action.
function authNextStep(loginStatus) {
  if (loginStatus === 422) return "register";   // unknown account
  if (loginStatus >= 200 && loginStatus < 300) return "done";
  return "error";
}
