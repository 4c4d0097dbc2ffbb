"""The judgement of a run and its last line."""

from __future__ import annotations

import math
import sys


def judge(checks, limits):
    """Whether every number compared lies at or under its limit:
    ``(ok, [(name, value, limit), ...])`` in the order of ``limits``.  A
    number the reference did not give, or one that is not finite, fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = checks.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows


def result_line(correct, attempted, failed, metrics, device, rows,
                breakdown=None):
    """The result's JSON object; ``checks`` (each number compared beside
    its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in rows}
    return out


def print_checks(rows, file=None):
    """Each number compared beside its limit, one a line."""
    file = sys.stderr if file is None else file
    for name, value, limit in rows:
        verdict = ("ok" if value is not None and math.isfinite(value)
                   and value <= limit else "FAIL")
        print(f"check {name} = {value!r} limit {limit!r} {verdict}",
              file=file, flush=True)
