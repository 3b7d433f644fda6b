"""obs-report: render a run report from a trace + optional prom snapshot.

Usage:
    python -m repro_torch.obs.report TRACE [--prom PROM] [--top-k K]

TRACE is a Tracer export — JSONL (``to_jsonl``) or the Chrome JSON object
format (``to_chrome_trace``); both are auto-detected.  PROM is a
Prometheus text exposition (``Registry.to_prom_text``) whose headline
counters get appended to the report.  The analytics live in
``repro_torch.obs.analyze``; this module is only the argv/IO shell, and
prints what the JAX package's ``tools/obs_report.py`` prints:

    python -m repro_torch.obs.report tools/fixtures/tiny_trace.jsonl \\
        --prom tools/fixtures/tiny_prom.txt
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import load_events, parse_prom_text, render_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs_report",
        description="Render a plain-text run report from a Chrome-trace "
                    "export (JSONL or JSON) and an optional prom snapshot.",
    )
    ap.add_argument("trace", help="trace file (Tracer.to_jsonl or "
                                  "Tracer.to_chrome_trace output)")
    ap.add_argument("--prom", default=None,
                    help="Prometheus text exposition (Registry.to_prom_text)")
    ap.add_argument("--top-k", type=int, default=5,
                    help="slowest-microbatch rows to show (default 5)")
    args = ap.parse_args(argv)

    try:
        events = load_events(Path(args.trace).read_text())
    except (OSError, ValueError) as exc:
        print(f"obs_report: cannot load trace {args.trace!r}: {exc}",
              file=sys.stderr)
        return 1
    snapshot = None
    if args.prom is not None:
        try:
            snapshot = parse_prom_text(Path(args.prom).read_text())
        except (OSError, ValueError) as exc:
            print(f"obs_report: cannot load prom {args.prom!r}: {exc}",
                  file=sys.stderr)
            return 1
    sys.stdout.write(render_report(events, snapshot, top_k=args.top_k))
    return 0


if __name__ == "__main__":
    sys.exit(main())
