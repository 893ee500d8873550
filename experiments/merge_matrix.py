"""Merge bench JSON lines into BENCH_MATRIX.jsonl without ever shrinking it.

Round 3 lost 7 of 9 matrix lines when an end-of-round rerun recreated the
file with only the configs it had re-measured.  This
merger keys every line by its `metric` field (names are self-describing —
bench.py stamps batch/ctx/mode/model into both the name and the record),
updates in place, and never drops a key it didn't re-measure.

Usage: python experiments/merge_matrix.py MATRIX_FILE < new_lines.jsonl
"""

from __future__ import annotations

import json
import sys


def merge(path: str, new_lines) -> int:
    rows: dict[str, dict] = {}
    order: list[str] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                key = rec["metric"]
                if key not in rows:
                    order.append(key)
                rows[key] = rec
    except FileNotFoundError:
        pass

    n_new = 0
    for line in new_lines:
        line = line.strip()
        if not line or not line.startswith("{"):
            continue
        rec = json.loads(line)
        key = rec["metric"]
        if key not in rows:
            order.append(key)
        rows[key] = rec
        n_new += 1

    with open(path, "w") as f:
        for key in order:
            f.write(json.dumps(rows[key]) + "\n")
    return n_new


if __name__ == "__main__":
    n = merge(sys.argv[1], sys.stdin)
    print(f"merged {n} line(s) into {sys.argv[1]}", file=sys.stderr)
