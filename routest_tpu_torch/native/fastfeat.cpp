// fastfeat: native data-plane for routest_tpu.
//
// The reference outsources its data pipeline entirely (data/ and
// notebooks/ are empty; one pandas row per HTTP request in
// Flaskr/ml.py:35-51). This framework's training/serving pipeline is
// host-side numpy by default; this library is the native runtime for the
// two hot host paths, bound via ctypes (routest_tpu/native/__init__.py):
//
//   ff_encode_batch  — categorical/scalar columns -> the 12-feature ABI
//                      matrix (SURVEY.md Appendix B), row-major f32.
//   ff_parse_csv     — delivery-history CSV -> column arrays, one pass,
//                      no per-row Python objects. Schema documented in
//                      routest_tpu/data/csv_io.py.
//
// Plain C ABI (extern "C"), no Python.h dependency: the same .so loads
// from any runtime. Built on demand by native/build.py with g++ -O3.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// ── feature encoding ────────────────────────────────────────────────────
// Column order (SURVEY.md Appendix B, Flaskr/ml.py:35-48):
//   weather_{Cloudy,Stormy,Sunny,Windy}, traffic_{High,Jam,Low,Medium},
//   weekday_ordered, hour_ordered, distance_km, driver_age
// weather_idx/traffic_idx use -1 for unknown categories => all-zero group.
void ff_encode_batch(const int32_t* weather_idx, const int32_t* traffic_idx,
                     const int32_t* weekday, const int32_t* hour,
                     const float* distance_km, const float* driver_age,
                     int64_t n, float* out /* n x 12, row-major */) {
    for (int64_t i = 0; i < n; ++i) {
        float* row = out + i * 12;
        memset(row, 0, 12 * sizeof(float));
        const int32_t w = weather_idx[i];
        if (w >= 0 && w < 4) row[w] = 1.0f;
        const int32_t t = traffic_idx[i];
        if (t >= 0 && t < 4) row[4 + t] = 1.0f;
        row[8] = (float)weekday[i];
        row[9] = (float)hour[i];
        row[10] = distance_km[i];
        row[11] = driver_age[i];
    }
}

// ── CSV ingest ──────────────────────────────────────────────────────────
// Expected header (validated by the Python wrapper):
//   weather,traffic,weekday,hour,distance_km,driver_age,eta_minutes
// weather/traffic are category NAMES; this parser maps them against the
// vocab tables passed in (entries are NUL-separated, count given), with
// unknown -> -1, matching vocab_index() in data/features.py.

struct FFVocab {
    const char* entries[16];
    int count;
};

static void ff_build_vocab(FFVocab* v, const char* packed, int count) {
    v->count = count > 16 ? 16 : count;
    const char* p = packed;
    for (int i = 0; i < v->count; ++i) {
        v->entries[i] = p;
        p += strlen(p) + 1;
    }
}

static int ff_vocab_lookup(const FFVocab* v, const char* s, int len) {
    for (int i = 0; i < v->count; ++i) {
        if ((int)strlen(v->entries[i]) == len &&
            memcmp(v->entries[i], s, (size_t)len) == 0)
            return i;
    }
    return -1;
}

// Counts data rows (lines after the first non-empty line). Returns -1 on
// open failure. Lets the caller allocate exact-size numpy arrays.
int64_t ff_count_rows(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int64_t lines = 0;
    char buf[1 << 16];
    size_t got;
    char last = '\n';
    while ((got = fread(buf, 1, sizeof(buf), f)) > 0) {
        for (size_t i = 0; i < got; ++i)
            if (buf[i] == '\n') ++lines;
        last = buf[got - 1];
    }
    fclose(f);
    if (last != '\n') ++lines;        // unterminated final line
    return lines > 0 ? lines - 1 : 0; // minus header
}

// Parses up to `cap` data rows into the output arrays. Returns the number
// of rows parsed, or a negative error code: -1 open failure, -2 a row had
// the wrong number of fields, -3 a numeric field failed to parse (the
// offending 1-based line number is written to *err_line for -2/-3).
int64_t ff_parse_csv(const char* path,
                     const char* weather_vocab, int n_weather,
                     const char* traffic_vocab, int n_traffic,
                     int64_t cap,
                     int32_t* weather_idx, int32_t* traffic_idx,
                     int32_t* weekday, int32_t* hour,
                     float* distance_km, float* driver_age,
                     float* eta_minutes, int64_t* err_line) {
    FFVocab wv, tv;
    ff_build_vocab(&wv, weather_vocab, n_weather);
    ff_build_vocab(&tv, traffic_vocab, n_traffic);
    *err_line = 0;

    FILE* f = fopen(path, "rb");
    if (!f) return -1;

    char line[4096];
    int64_t row = 0, lineno = 0;
    bool header = true;
    while (fgets(line, sizeof(line), f)) {
        ++lineno;
        size_t len = strlen(line);
        if (len == sizeof(line) - 1 && line[len - 1] != '\n') {
            // Overlong physical line: fgets would silently split it into
            // bogus rows. No valid row in this 7-field schema approaches
            // 4 KB, so reject instead of mis-parsing. Distinct code so
            // the Python fallback can mirror the exact same contract.
            fclose(f);
            *err_line = lineno;
            return -4;
        }
        while (len && (line[len - 1] == '\n' || line[len - 1] == '\r'))
            line[--len] = '\0';
        if (len == 0) continue;
        if (header) { header = false; continue; }
        if (row >= cap) break;

        // exactly 7 comma-separated fields (6 commas), then split
        int commas = 0;
        for (size_t i = 0; i < len; ++i)
            if (line[i] == ',') ++commas;
        if (commas != 6) {
            fclose(f);
            *err_line = lineno;
            return -2;
        }
        const char* fields[7];
        int flen[7];
        int nf = 0;
        const char* start = line;
        for (size_t i = 0; i <= len; ++i) {
            if (i == len || line[i] == ',') {
                fields[nf] = start;
                flen[nf] = (int)(line + i - start);
                ++nf;
                start = line + i + 1;
            }
        }

        weather_idx[row] = ff_vocab_lookup(&wv, fields[0], flen[0]);
        traffic_idx[row] = ff_vocab_lookup(&tv, fields[1], flen[1]);

        char tmp[64];
        char* end;
        const int numeric[5] = {2, 3, 4, 5, 6};
        double vals[5];
        for (int k = 0; k < 5; ++k) {
            int fi = numeric[k];
            int l = flen[fi];
            if (l > 63) {
                // No representable value in this schema needs 64 chars;
                // reject instead of silently truncating (the Python
                // fallback enforces the same cap).
                fclose(f);
                *err_line = lineno;
                return -3;
            }
            // Strict decimal grammar, identical to the Python fallback's
            // regex: digits/sign/dot/exponent only. This rejects what
            // strtod would otherwise quietly accept beyond the shared
            // contract — leading whitespace, hex (0x10), inf/nan.
            bool ok = l > 0;
            for (int c = 0; c < l && ok; ++c) {
                char ch = fields[fi][c];
                ok = (ch >= '0' && ch <= '9') || ch == '+' || ch == '-' ||
                     ch == '.' || ch == 'e' || ch == 'E';
            }
            memcpy(tmp, fields[fi], (size_t)l);
            tmp[l] = '\0';
            vals[k] = ok ? strtod(tmp, &end) : 0.0;
            // float32 range guard: values that would overflow to inf in
            // the f32 output columns are rejected, not silently mangled.
            if (!ok || end == tmp || *end != '\0' || !std::isfinite(vals[k]) ||
                vals[k] > 3.0e38 || vals[k] < -3.0e38) {
                fclose(f);
                *err_line = lineno;
                return -3;
            }
        }
        // weekday/hour become int32: an out-of-range double->int32 cast
        // is UB in C++, so range-check instead of silently corrupting.
        if (vals[0] < -2147483647.0 || vals[0] > 2147483647.0 ||
            vals[1] < -2147483647.0 || vals[1] > 2147483647.0) {
            fclose(f);
            *err_line = lineno;
            return -3;
        }
        weekday[row] = (int32_t)vals[0];
        hour[row] = (int32_t)vals[1];
        distance_km[row] = (float)vals[2];
        driver_age[row] = (float)vals[3];
        eta_minutes[row] = (float)vals[4];
        ++row;
    }
    fclose(f);
    return row;
}

// ── OSM XML road-network parsing ───────────────────────────────────────
// Native fast path for routest_tpu/data/osm.py:load_osm — same observable
// semantics (drivable-highway filter, maxspeed parsing, oneway handling,
// used-node compaction in ascending-osm-id order, document-order edge
// emission) so the Python wrapper can assert exact parity. On ANY parse
// anomaly the parser returns a nonzero code and Python falls back to the
// ElementTree path, which owns the error messages.

}  // extern "C"

#include <algorithm>
#include <cctype>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct OsmSegment {
    int64_t a, b;
    int32_t cls;
    float speed;
    uint8_t both;
};

// Mirrors data/osm.py:_HIGHWAY_CLASS exactly.
int32_t highway_class(const std::string& v) {
    static const std::unordered_map<std::string, int32_t> m = {
        {"motorway", 0}, {"motorway_link", 0}, {"trunk", 0},
        {"trunk_link", 0}, {"primary", 0}, {"primary_link", 0},
        {"secondary", 1}, {"secondary_link", 1}, {"tertiary", 1},
        {"tertiary_link", 1}, {"unclassified", 2}, {"residential", 2},
        {"living_street", 2}, {"service", 2},
    };
    auto it = m.find(v);
    return it == m.end() ? -1 : it->second;
}

std::string lower_strip(const std::string& s) {
    size_t b = 0, e = s.size();
    while (b < e && std::isspace((unsigned char)s[b])) ++b;
    while (e > b && std::isspace((unsigned char)s[e - 1])) --e;
    std::string out = s.substr(b, e - b);
    for (char& c : out) c = (char)std::tolower((unsigned char)c);
    return out;
}

std::string to_lower(const std::string& s) {
    std::string out = s;
    for (char& c : out) c = (char)std::tolower((unsigned char)c);
    return out;
}

// Strict decimal float parse. Deliberately NARROWER than both strtod and
// Python float(): hex forms ("0x20"), inf/nan, and digit underscores
// ("1_0") are rejected — the Python path's _parse_maxspeed applies the
// same strictness so the two stay observably identical (none of these
// forms appear in real OSM data; they only matter for parity).
// Consumed-value guards: the scanner does NOT decode XML entity
// references (ElementTree does), and strtod/strtoll accept forms
// (hex floats, "inf") that Python's parse rejects while Python accepts
// forms ("1_0") strtod rejects. Rather than reimplement either quirk
// set, any consumed value outside the boring charset makes the whole
// parse return code 1 so load_osm falls back to the ElementTree path,
// which owns the exact semantics. Display-only values (names etc.) are
// never consumed, so real extracts with "Fifth &amp; Main" street
// names keep the fast path.
bool plain_numeric(const std::string& s) {
    if (s.empty()) return false;
    for (char c : s)
        if (!((c >= '0' && c <= '9') || c == '+' || c == '-' ||
              c == '.' || c == 'e' || c == 'E'))
            return false;
    return true;
}

bool entity_free(const std::string& s) {
    return s.find('&') == std::string::npos;
}

bool parse_float(const std::string& s, double* out) {
    if (s.empty()) return false;
    for (char c : s) {
        if (!(std::isdigit((unsigned char)c) || c == '.' || c == '+' ||
              c == '-' || c == 'e' || c == 'E'))
            return false;
    }
    char* end = nullptr;
    *out = strtod(s.c_str(), &end);
    return end && *end == '\0' && std::isfinite(*out);
}

// data/osm.py:_parse_maxspeed: "50" | "50 km/h" (kmh) | "30 mph".
bool parse_maxspeed(const std::string& raw, double* mps) {
    std::string t = lower_strip(raw);
    double v;
    if (t.size() > 3 && t.compare(t.size() - 3, 3, "mph") == 0) {
        if (!parse_float(lower_strip(t.substr(0, t.size() - 3)), &v))
            return false;
        *mps = v * 0.44704;
        return true;
    }
    if (t.size() > 4 && t.compare(t.size() - 4, 4, "km/h") == 0)
        t = lower_strip(t.substr(0, t.size() - 4));
    if (!parse_float(t, &v)) return false;
    *mps = v / 3.6;
    return true;
}

struct Scanner {
    const char* p;
    const char* end;

    // Parse attributes of the tag at p (p just past the name) until the
    // closing '>'; returns false on EOF/malformation. Handles both quote
    // styles. Leaves p past '>'.
    bool attrs(std::vector<std::pair<std::string, std::string>>* out) {
        out->clear();
        while (p < end) {
            while (p < end && std::isspace((unsigned char)*p)) ++p;
            if (p >= end) return false;
            if (*p == '/' || *p == '?') { ++p; continue; }
            if (*p == '>') { ++p; return true; }
            const char* ks = p;
            while (p < end && *p != '=' && *p != '>' &&
                   !std::isspace((unsigned char)*p)) ++p;
            if (p >= end || *p != '=') return false;
            std::string key(ks, p - ks);
            ++p;
            if (p >= end || (*p != '"' && *p != '\'')) return false;
            const char q = *p++;
            const char* vs = p;
            while (p < end && *p != q) ++p;
            if (p >= end) return false;
            out->emplace_back(std::move(key), std::string(vs, p - vs));
            ++p;
        }
        return false;
    }
};

}  // namespace

extern "C" {

struct FfOsmResult {
    int32_t code;        // 0 ok; 1 malformed; 2 nothing drivable/usable
    int32_t n_nodes;
    int64_t n_edges;
    double* lat;
    double* lon;
    int32_t* senders;
    int32_t* receivers;
    int32_t* cls;
    float* speed;
};

void ff_osm_free(FfOsmResult* r) {
    if (!r) return;
    free(r->lat); free(r->lon); free(r->senders); free(r->receivers);
    free(r->cls); free(r->speed); free(r);
}

FfOsmResult* ff_osm_parse(const char* buf, int64_t len,
                          const float* class_speed /* 3 defaults, m/s */) {
    FfOsmResult* res = (FfOsmResult*)calloc(1, sizeof(FfOsmResult));
    if (!res) return nullptr;
    std::unordered_map<int64_t, std::pair<double, double>> coords;
    std::vector<OsmSegment> segments;

    Scanner sc{buf, buf + len};
    std::vector<std::pair<std::string, std::string>> at;
    bool in_way = false;
    bool root_seen = false, root_closed = false;
    std::string root_name;
    std::vector<int64_t> way_nodes;
    int32_t way_cls = -1;
    std::string way_maxspeed;      // raw LAST maxspeed tag value
    bool way_has_maxspeed = false;
    std::string way_oneway;
    bool way_has_oneway = false;
    std::string way_junction;      // junction=roundabout implies oneway

    auto flush_way = [&]() {
        if (way_cls < 0 || way_nodes.size() < 2) return;
        // Python keeps the LAST maxspeed tag and falls back to the class
        // default only if THAT value fails to parse — so parse at flush,
        // not per tag.
        double spd = (double)class_speed[way_cls];
        double mps;
        if (way_has_maxspeed && parse_maxspeed(way_maxspeed, &mps))
            spd = mps;
        // Python lowercases WITHOUT stripping ("yes " stays two-way).
        // No explicit oneway tag: junction=roundabout/circular implies
        // one-way in drawing order (data/osm.py:_ingest_way parity).
        std::string ow;
        if (way_has_oneway) {
            ow = to_lower(way_oneway);
        } else {
            std::string j = to_lower(way_junction);
            ow = (j == "roundabout" || j == "circular") ? "yes" : "no";
        }
        bool rev = ow == "-1";
        bool both = !(ow == "yes" || ow == "true" || ow == "1" || rev);
        for (size_t i = 0; i + 1 < way_nodes.size(); ++i) {
            int64_t a = way_nodes[i], b = way_nodes[i + 1];
            if (rev) { int64_t t = a; a = b; b = t; }
            segments.push_back({a, b, way_cls, (float)spd,
                                (uint8_t)(both ? 1 : 0)});
        }
    };

    while (sc.p < sc.end) {
        const char* lt = (const char*)memchr(sc.p, '<', sc.end - sc.p);
        if (!lt) break;
        sc.p = lt + 1;
        if (sc.p >= sc.end) { res->code = 1; return res; }
        if (*sc.p == '!') {  // comment/decl: skip past it wholesale so a
            // '<' inside "<!-- ... -->" can't be misread as a tag
            if (sc.end - sc.p >= 3 && sc.p[1] == '-' && sc.p[2] == '-') {
                const char* close = nullptr;
                for (const char* q = sc.p + 3; q + 2 < sc.end; ++q)
                    if (q[0] == '-' && q[1] == '-' && q[2] == '>') {
                        close = q + 3;
                        break;
                    }
                if (!close) { res->code = 1; return res; }
                sc.p = close;
            }
            continue;
        }
        if (*sc.p == '?') continue;  // xml declaration
        bool closing = *sc.p == '/';
        if (closing) ++sc.p;
        const char* ns = sc.p;
        while (sc.p < sc.end && !std::isspace((unsigned char)*sc.p) &&
               *sc.p != '>' && *sc.p != '/') ++sc.p;
        std::string name(ns, sc.p - ns);
        if (closing) {
            if (name == "way") {
                if (!in_way) { res->code = 1; return res; }
                flush_way();
                in_way = false;
            }
            if (root_seen && name == root_name) root_closed = true;
            continue;  // skip to '>' via next memchr
        }
        if (!root_seen) {
            root_seen = true;
            root_name = name;
        }
        if (!sc.attrs(&at)) { res->code = 1; return res; }
        if (name == "node") {
            int64_t id = 0; double la = 0, lo = 0;
            bool has_id = false, has_la = false, has_lo = false;
            for (auto& kv : at) {
                double v;
                if (kv.first == "id") {
                    if (!plain_numeric(kv.second)) { res->code = 1; return res; }
                    char* e = nullptr;
                    id = strtoll(kv.second.c_str(), &e, 10);
                    has_id = e && *e == '\0' && !kv.second.empty();
                } else if (kv.first == "lat" || kv.first == "lon") {
                    if (!plain_numeric(kv.second)) { res->code = 1; return res; }
                    if (parse_float(kv.second, &v)) {
                        if (kv.first == "lat") { la = v; has_la = true; }
                        else { lo = v; has_lo = true; }
                    }
                }
            }
            if (has_id && has_la && has_lo) coords[id] = {la, lo};
        } else if (name == "way") {
            if (in_way) { res->code = 1; return res; }  // unclosed way
            in_way = true;
            way_nodes.clear();
            way_cls = -1;
            way_has_maxspeed = false;
            way_oneway.clear();
            way_has_oneway = false;
            way_junction.clear();
        } else if (name == "nd" && in_way) {
            for (auto& kv : at)
                if (kv.first == "ref") {
                    if (!plain_numeric(kv.second)) { res->code = 1; return res; }
                    char* e = nullptr;
                    int64_t r = strtoll(kv.second.c_str(), &e, 10);
                    if (e && *e == '\0' && !kv.second.empty())
                        way_nodes.push_back(r);
                }
        } else if (name == "tag" && in_way) {
            std::string k, v;
            bool has_v = false;
            for (auto& kv : at) {
                if (kv.first == "k") k = kv.second;
                else if (kv.first == "v") { v = kv.second; has_v = true; }
            }
            if (!has_v) continue;  // Python skips tags with no v attribute
            // An entity reference in a key, or in a value one of the
            // consumed keys would read, decodes differently under
            // ElementTree: fall back rather than diverge.
            if (!entity_free(k)) { res->code = 1; return res; }
            if (k == "highway" || k == "maxspeed" || k == "oneway" ||
                k == "junction") {
                if (!entity_free(v)) { res->code = 1; return res; }
            }
            if (k == "highway") way_cls = highway_class(v);
            else if (k == "maxspeed") {
                way_maxspeed = v;       // last tag wins; parsed at flush
                way_has_maxspeed = true;
            } else if (k == "oneway") {
                way_oneway = v;
                way_has_oneway = true;
            } else if (k == "junction") way_junction = v;
        }
    }
    // Truncated document (no root close, or a way left open at EOF):
    // the ElementTree path raises — never hand back a silently partial
    // street network.
    if (!root_seen || !root_closed || in_way) { res->code = 1; return res; }
    if (segments.empty()) { res->code = 2; return res; }

    // Used-node compaction in ascending osm-id order (matches Python's
    // sorted-set indexing exactly).
    std::vector<int64_t> used;
    used.reserve(coords.size());
    {
        std::unordered_map<int64_t, uint8_t> seen;
        for (auto& s : segments) {
            for (int64_t ref : {s.a, s.b}) {
                if (coords.count(ref) && !seen.count(ref)) {
                    seen[ref] = 1;
                    used.push_back(ref);
                }
            }
        }
    }
    std::sort(used.begin(), used.end());
    std::unordered_map<int64_t, int32_t> index;
    index.reserve(used.size());
    for (size_t i = 0; i < used.size(); ++i)
        index[used[i]] = (int32_t)i;

    std::vector<int32_t> snd, rcv, cls;
    std::vector<float> spd;
    for (auto& s : segments) {
        auto ia = index.find(s.a), ib = index.find(s.b);
        if (ia == index.end() || ib == index.end() || s.a == s.b) continue;
        snd.push_back(ia->second); rcv.push_back(ib->second);
        cls.push_back(s.cls); spd.push_back(s.speed);
        if (s.both) {
            snd.push_back(ib->second); rcv.push_back(ia->second);
            cls.push_back(s.cls); spd.push_back(s.speed);
        }
    }
    if (snd.empty()) { res->code = 2; return res; }

    res->n_nodes = (int32_t)used.size();
    res->n_edges = (int64_t)snd.size();
    res->lat = (double*)malloc(sizeof(double) * used.size());
    res->lon = (double*)malloc(sizeof(double) * used.size());
    res->senders = (int32_t*)malloc(sizeof(int32_t) * snd.size());
    res->receivers = (int32_t*)malloc(sizeof(int32_t) * snd.size());
    res->cls = (int32_t*)malloc(sizeof(int32_t) * snd.size());
    res->speed = (float*)malloc(sizeof(float) * snd.size());
    if (!res->lat || !res->lon || !res->senders || !res->receivers ||
        !res->cls || !res->speed) {
        ff_osm_free(res);
        return nullptr;
    }
    for (size_t i = 0; i < used.size(); ++i) {
        res->lat[i] = coords[used[i]].first;
        res->lon[i] = coords[used[i]].second;
    }
    memcpy(res->senders, snd.data(), sizeof(int32_t) * snd.size());
    memcpy(res->receivers, rcv.data(), sizeof(int32_t) * rcv.size());
    memcpy(res->cls, cls.data(), sizeof(int32_t) * cls.size());
    memcpy(res->speed, spd.data(), sizeof(float) * spd.size());
    return res;
}

// ── version stamp (cache invalidation for the build wrapper) ───────────
int ff_abi_version() { return 2; }

}  // extern "C"
