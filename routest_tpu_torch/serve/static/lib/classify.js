/* Location-name classifier — the reference's lib/classify.js
 * (frontend/map-app/lib/classify.js): warehouses get depot markers,
 * everything else renders as a mall/commercial site. Loaded by
 * mvp.html; executed in CI by tests/test_dashboard_logic.py over the
 * seeded 21-location table (utils/minijs.py hosts the engine).
 */
function classify(name) {
  if (/warehouse|distribution|depot|hub/i.test(name)) return "warehouse";
  // The mall test falls through to the same value on purpose: it
  // mirrors the reference classifier's match order verbatim, so a
  // future third category slots in without reordering semantics.
  if (/mall|center|centre|plaza|galleria|market/i.test(name)) return "mall";
  return "mall";
}
