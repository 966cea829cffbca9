"""The repro-bench/v1 record, the port's own copy of the schema in
benchmarks/common.py (which imports JAX):

    {"schema": "repro-bench/v1", "benchmark": <name>,
     "backend": "cuda"|"cpu", "meta": {...},
     "rows": [{"name", "us_per_call", "derived"}, ...]}

The port writes `BENCH_torch_<name>.json`, never the JAX package's
`BENCH_<name>.json`, and stamps the torch device it ran on (and, on a
card, the card's name) into `meta`.
"""
from __future__ import annotations

import json
import os

SCHEMA = "repro-bench/v1"
REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                         "..", "..", ".."))
_ROW_KEYS = {"name", "us_per_call", "derived"}


def validate_bench_json(doc):
    """Validate the repro-bench/v1 shape (top-level keys and row types),
    raising ValueError naming the offending key or row. Returns `doc`."""
    if not isinstance(doc, dict):
        raise ValueError(f"bench doc must be a JSON object, "
                         f"got {type(doc).__name__}")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"key 'schema' must be {SCHEMA!r}, "
                         f"got {doc.get('schema')!r}")
    for key, typ in (("benchmark", str), ("backend", str),
                     ("meta", dict), ("rows", list)):
        if not isinstance(doc.get(key), typ):
            raise ValueError(
                f"key {key!r} must be {typ.__name__}, got "
                f"{type(doc.get(key)).__name__}: {doc.get(key)!r}")
    for i, row in enumerate(doc["rows"]):
        if not isinstance(row, dict):
            raise ValueError(f"rows[{i}] must be an object, got "
                             f"{type(row).__name__}")
        if set(row) != _ROW_KEYS:
            raise ValueError(f"rows[{i}] keys {sorted(row)} != "
                             f"{sorted(_ROW_KEYS)}")
        if not isinstance(row["name"], str):
            raise ValueError(f"rows[{i}]['name'] must be a string, "
                             f"got {row['name']!r}")
        if not (row["us_per_call"] is None
                or isinstance(row["us_per_call"], (int, float))):
            raise ValueError(f"rows[{i}]['us_per_call'] must be a "
                             f"number or null, got {row['us_per_call']!r}")
        if not isinstance(row["derived"], str):
            raise ValueError(f"rows[{i}]['derived'] must be a string, "
                             f"got {row['derived']!r}")
    return doc


def write_bench_json(benchmark, rows, device, out_dir=None, **meta):
    """Write BENCH_torch_<benchmark>.json to `out_dir` (the repo root by
    default) and return its path. `rows` are (name, us_per_call or
    None, derived) tuples; `device` (a torch.device) gives the backend,
    `meta.device` and, for a card, `meta.device_name`. `meta.quick` is
    always stamped (default False), as tests/test_bench_schema.py
    rejects committed quick-mode records."""
    import torch
    meta.setdefault("quick", False)
    meta["device"] = str(device)
    if device.type == "cuda":
        meta["device_name"] = torch.cuda.get_device_name(device)
    doc = {"schema": SCHEMA, "benchmark": benchmark,
           "backend": device.type, "meta": meta,
           "rows": [{"name": name,
                     "us_per_call": (round(us, 2)
                                     if isinstance(us, (int, float))
                                     else us),
                     "derived": derived}
                    for name, us, derived in rows]}
    validate_bench_json(doc)  # never write a malformed record
    path = os.path.join(out_dir or REPO_ROOT, f"BENCH_torch_{benchmark}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    return path
