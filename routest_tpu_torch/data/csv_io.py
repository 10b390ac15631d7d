"""CSV dataset ingest/export — the ``data/`` capability the reference
leaves empty (``data/.gitkeep``; SURVEY.md §7.3 item 1: "no data, no
model").

Schema (one header + one row per delivery):

    weather,traffic,weekday,hour,distance_km,driver_age,eta_minutes

``weather``/``traffic`` are category names from the 12-feature ABI
vocabularies (``data/features.py``); unknown names map to index -1
(all-zero one-hot group), matching ``vocab_index``. ``load_csv`` returns
the same dataset-dict schema as ``data/synthetic.py``, so it feeds
``train.loop.fit`` directly.

The format is PLAIN comma-separated — no quoting, no embedded commas
(every value is a vocab name or a number, so none are ever needed) —
and both parsers treat it identically: the header is validated verbatim
before parsing, a row without exactly 7 fields is an error naming the
line, and quote characters are ordinary text (an unknown category).

``load_csv`` always takes the Python parser here: the JAX package's
native parser (``routest_tpu/native``) is not ported yet (Queue A item
11), and the Python path is its identical-contract twin there.
"""

from __future__ import annotations

import csv
import re
from typing import Dict

import numpy as np

# The shared numeric grammar (see _load_csv_python): plain decimal with
# optional sign/fraction/exponent, at most 63 chars — exactly what the
# native parser's charset pre-check + strtod full-consume accepts.
# re.ASCII: \d must mean [0-9] only (float() would happily parse Unicode
# digits the native parser rejects).
_NUMERIC_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$", re.ASCII)
_MAX_NUMERIC_LEN = 63

from routest_tpu_torch.data.features import TRAFFIC_CATEGORIES, WEATHER_CATEGORIES

COLUMNS = ("weather", "traffic", "weekday", "hour",
           "distance_km", "driver_age", "eta_minutes")


def save_csv(path: str, data: Dict[str, np.ndarray]) -> None:
    """Dataset dict → CSV file (the export half of the pipeline)."""
    w = np.asarray(data["weather_idx"])
    t = np.asarray(data["traffic_idx"])
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(COLUMNS)
        for i in range(len(w)):
            out.writerow([
                WEATHER_CATEGORIES[w[i]] if 0 <= w[i] < len(WEATHER_CATEGORIES)
                else "Unknown",
                TRAFFIC_CATEGORIES[t[i]] if 0 <= t[i] < len(TRAFFIC_CATEGORIES)
                else "Unknown",
                int(data["weekday"][i]), int(data["hour"][i]),
                f"{float(data['distance_km'][i]):.6g}",
                f"{float(data['driver_age'][i]):.6g}",
                f"{float(data['eta_minutes'][i]):.6g}",
            ])


def _check_header(path: str) -> None:
    """Validate the verbatim header (both parse paths route through here)."""
    with open(path) as f:
        for line in f:
            first = line.strip("\r\n")
            if first:
                break
        else:
            first = ""
    if first != ",".join(COLUMNS):
        raise ValueError(
            f"{path}:1: bad header (expected {','.join(COLUMNS)!r})")


def load_csv(path: str) -> Dict[str, np.ndarray]:
    """CSV file → dataset dict (the Python parser)."""
    _check_header(path)
    return _load_csv_python(path)


def _load_csv_python(path: str) -> Dict[str, np.ndarray]:
    w_lut = {v: i for i, v in enumerate(WEATHER_CATEGORIES)}
    t_lut = {v: i for i, v in enumerate(TRAFFIC_CATEGORIES)}
    cols: Dict[str, list] = {k: [] for k in (
        "weather_idx", "traffic_idx", "weekday", "hour",
        "distance_km", "driver_age", "eta_minutes")}
    with open(path, newline="") as f:
        header_seen = False
        for lineno, line in enumerate(f, start=1):
            # Native-parser parity: its 4096-byte fgets buffer rejects any
            # physical line of 4095+ content BYTES (code -4) — count bytes,
            # not codepoints, or non-ASCII categories parse-or-error
            # differently under the two parsers.
            content_len = len(line.encode("utf-8", "surrogateescape")) \
                - (1 if line.endswith("\n") else 0)
            if content_len >= 4095:
                raise ValueError(f"{path}:{lineno}: line exceeds 4094 bytes")
            line = line.strip("\r\n")
            if not line:
                continue
            if not header_seen:
                header_seen = True
                continue
            # Plain split, mirroring the native parser exactly: the
            # schema has no quoting (see module docstring), so a
            # csv.reader's quote handling would DIVERGE from native on
            # malformed quote-bearing input, not add capability.
            row = line.split(",")
            if len(row) != 7:
                raise ValueError(f"{path}:{lineno}: expected 7 fields")
            try:
                # _NUMERIC_RE + range guards keep this grammar and the
                # native parser's byte-for-byte identical (no python-isms
                # like '1_0', no strtod-isms like hex or padding; f32/i32
                # overflow is an error, not silent inf/garbage).
                if not all(len(row[i]) <= _MAX_NUMERIC_LEN
                           and _NUMERIC_RE.match(row[i])
                           for i in (2, 3, 4, 5, 6)):
                    raise ValueError
                numeric = [float(row[i]) for i in (2, 3, 4, 5, 6)]
                if not all(np.isfinite(v) and abs(v) <= 3.0e38 for v in numeric):
                    raise ValueError
                if any(abs(v) > 2**31 - 1 for v in numeric[:2]):
                    raise ValueError
                cols["weekday"].append(int(numeric[0]))
                cols["hour"].append(int(numeric[1]))
                cols["distance_km"].append(numeric[2])
                cols["driver_age"].append(numeric[3])
                cols["eta_minutes"].append(numeric[4])
            except (ValueError, OverflowError):
                raise ValueError(f"{path}:{lineno}: non-numeric field") from None
            cols["weather_idx"].append(w_lut.get(row[0], -1))
            cols["traffic_idx"].append(t_lut.get(row[1], -1))
    return {
        "weather_idx": np.asarray(cols["weather_idx"], np.int32),
        "traffic_idx": np.asarray(cols["traffic_idx"], np.int32),
        "weekday": np.asarray(cols["weekday"], np.int32),
        "hour": np.asarray(cols["hour"], np.int32),
        "distance_km": np.asarray(cols["distance_km"], np.float32),
        "driver_age": np.asarray(cols["driver_age"], np.float32),
        "eta_minutes": np.asarray(cols["eta_minutes"], np.float32),
    }
