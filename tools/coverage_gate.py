"""Line-coverage gate with zero external dependencies.

The reference repo enforces coverage through codecov (reference:
codecov.yml:1-8 — 95% project / 80% patch); this image has neither
coverage.py nor pytest-cov, so the gate is built directly on CPython 3.12's
``sys.monitoring``: the LINE callback records the first hit of every code
location and returns DISABLE, so steady-state overhead is near zero (the
interpreter stops reporting a location once seen).

Executable lines are derived from the compiled code objects' ``co_lines()``
tables (recursively through nested functions/comprehensions), so the
denominator is what CPython can actually execute, not raw source lines.

Usage:  python tools/coverage_gate.py [--fail-under PCT] [pytest args...]

Sharded mode (the full suite in ONE process segfaults inside XLA's CPU
compiler on the multislice pjit program once enough compiled state has
accumulated — a native jaxlib crash, reproducible at the same test, absent
when the same tests run in a fresh process):

    python tools/coverage_gate.py --dump /tmp/s1.json tests/test_[a-e]*.py
    python tools/coverage_gate.py --dump /tmp/s2.json tests/test_[f-n]*.py
    python tools/coverage_gate.py --dump /tmp/s3.json tests/test_[o-z]*.py
    python tools/coverage_gate.py --fail-under 95 --merge /tmp/s1.json /tmp/s2.json /tmp/s3.json

(round 4: the old 2-shard [a-o]/[p-z] split started segfaulting once the
suite grew past ~320 tests — same native crash, earlier accumulation point)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TARGET = REPO / "lanczos_tpu"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

_hits: dict[str, set[int]] = {}
_prefix = str(TARGET)


def _on_line(code, line):
    f = code.co_filename
    if f.startswith(_prefix):
        _hits.setdefault(f, set()).add(line)
    return sys.monitoring.DISABLE


def _executable_lines(path: Path) -> set[int]:
    try:
        code = compile(path.read_text(), str(path), "exec")
    except SyntaxError:  # pragma: no cover
        return set()
    lines: set[int] = set()
    stack = [code]
    while stack:
        c = stack.pop()
        for _start, _end, ln in c.co_lines():
            if ln is not None and ln > 0:
                lines.add(ln)
        stack.extend(k for k in c.co_consts if hasattr(k, "co_lines"))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fail-under", type=float, default=85.0)
    ap.add_argument("--missing", default=None, help="substring of a source path: print its uncovered line numbers")
    ap.add_argument("--dump", default=None, help="write raw hits to this JSON and skip the report (shard mode)")
    ap.add_argument("--merge", nargs="*", default=None, help="merge hit dumps from shard runs instead of running pytest")
    ap.add_argument("pytest_args", nargs="*", default=[])
    args = ap.parse_args()

    import json

    if args.merge:
        for p in args.merge:
            for f, lines in json.loads(Path(p).read_text()).items():
                _hits.setdefault(f, set()).update(lines)
    else:
        mon = sys.monitoring
        tool = mon.COVERAGE_ID
        mon.use_tool_id(tool, "lanczos-coverage-gate")
        mon.register_callback(tool, mon.events.LINE, _on_line)
        mon.set_events(tool, mon.events.LINE)

        # Spawned worker processes (the multi-process harness,
        # parallel/mp_demo.py) are out of this process's sys.monitoring
        # reach; export a dump directory so each worker records its own
        # hits (mp_demo._maybe_coverage_hook) and merge them afterwards.
        import os
        import tempfile

        cov_dir = tempfile.mkdtemp(prefix="lt_cov_mp_")
        os.environ["LT_COV_DUMP"] = cov_dir

        import pytest

        # xdist would move tests into worker subprocesses, out of reach of this
        # process's sys.monitoring hooks — "-n 0" keeps execution in-process
        # (disabling the plugin outright would make the addopts -n/--dist
        # unrecognized instead).
        rc = pytest.main((args.pytest_args or ["tests/", "-q"]) + ["-n", "0"])
        mon.set_events(tool, 0)
        for p in Path(cov_dir).glob("mp_*.json"):
            try:
                for f, lines in json.loads(p.read_text()).items():
                    _hits.setdefault(f, set()).update(lines)
            except (OSError, json.JSONDecodeError):
                pass
        if rc != 0:
            print(f"coverage gate: pytest failed (rc={rc})", file=sys.stderr)
            return int(rc)

    if args.dump:
        Path(args.dump).write_text(
            json.dumps({f: sorted(ls) for f, ls in _hits.items()})
        )
        print(f"coverage gate: wrote {sum(map(len, _hits.values()))} hits to {args.dump}")
        return 0

    total_exec = 0
    total_hit = 0
    rows = []
    for path in sorted(TARGET.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        ex = _executable_lines(path)
        if not ex:
            continue
        hit = _hits.get(str(path), set()) & ex
        total_exec += len(ex)
        total_hit += len(hit)
        rows.append((path.relative_to(REPO), len(hit), len(ex)))

    print("\ncoverage (sys.monitoring line gate):")
    for rel, h, e in rows:
        print(f"  {str(rel):55s} {h:5d}/{e:<5d} {100.0 * h / e:6.1f}%")
    if args.missing:
        for path in sorted(TARGET.rglob("*.py")):
            if args.missing in str(path):
                ex = _executable_lines(path)
                miss = sorted(ex - _hits.get(str(path), set()))
                print(f"missing in {path.relative_to(REPO)}: {miss}")
    pct = 100.0 * total_hit / max(total_exec, 1)
    print(f"TOTAL {total_hit}/{total_exec} = {pct:.1f}%  (gate: {args.fail_under:.0f}%)")
    if pct < args.fail_under:
        print("coverage gate: FAIL", file=sys.stderr)
        return 2
    print("coverage gate: PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
