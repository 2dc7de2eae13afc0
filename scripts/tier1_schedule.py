#!/usr/bin/env python3
"""Replay pytest-xdist's ``--dist loadfile`` schedule on a junit file's
per-test times, to see which files hold the tier-1 run's end.

    python3 scripts/tier1_schedule.py JUNIT.xml [--workers 6] [--scale-port X ...]

xdist (3.x, ``loadscopereorder`` on) queues the files by their number of
tests, most first, ties in collection order; each worker takes one file,
then another while its pending tests number at most 2, and so on.  The
replay runs each file's tests for their recorded times on that schedule
(worker start-up and collection are not in it) and prints the wall time
it gives, the sum of the test times over the workers (the least any
schedule could take), and the files that end last.  ``--scale-port X``
replays it again with the port's own files (`tests/test_torch_*.py`)
taking X times their recorded time.
"""

import argparse
import collections
import heapq
import sys
import xml.etree.ElementTree as ET


def file_times(junit):
    """{file stem: [test seconds, ...]} in the junit file's order."""
    files = collections.OrderedDict()
    for case in ET.parse(junit).getroot().iter("testcase"):
        cls = case.get("classname") or ""
        stem = cls.split(".")[1] if cls.startswith("tests.") else cls
        files.setdefault(stem, []).append(float(case.get("time") or 0.0))
    return files


def replay(files, workers):
    """(wall seconds, {file: (start, end)}) of the loadfile schedule."""
    queue = collections.deque(sorted(sorted(files), key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]

    def assign(w):
        f = queue.popleft()
        pending[w].extend((f, t) for t in files[f])

    for w in range(workers):
        if queue:
            assign(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            assign(w)
    clock = [(0.0, w) for w in range(workers)]
    spans, end = {}, 0.0
    while clock:
        now, w = heapq.heappop(clock)
        if not pending[w]:
            end = max(end, now)
            continue
        f, t = pending[w].popleft()
        start, _ = spans.get(f, (now, now))
        spans[f] = (start, now + t)
        if queue and len(pending[w]) <= 2:
            assign(w)
        heapq.heappush(clock, (now + t, w))
    return end, spans


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--scale-port", type=float, nargs="*", default=[])
    ap.add_argument("--last", type=int, default=6, help="files ending last to print")
    args = ap.parse_args()
    files = file_times(args.junit)
    for scale in [1.0, *args.scale_port]:
        run = {f: [t * scale for t in ts] if f.startswith("test_torch") else ts
               for f, ts in files.items()}
        total = sum(map(sum, run.values()))
        port = sum(sum(ts) for f, ts in run.items() if f.startswith("test_torch"))
        end, spans = replay(run, args.workers)
        print(f"port x{scale:g}: replayed wall {end:.0f} s; tests {total:.0f} s "
              f"(port {port:.0f} s) over {args.workers} workers = {total / args.workers:.0f} s")
        for f, (s, e) in sorted(spans.items(), key=lambda kv: -kv[1][1])[:args.last]:
            print(f"  {f}: {len(run[f])} tests, {sum(run[f]):.0f} s, from {s:.0f} to {e:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
