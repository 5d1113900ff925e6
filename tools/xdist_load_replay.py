"""Replay pytest-xdist's `--dist load` schedule of the Tier-1 suite to
see how many tests pass before its clock cuts the run, for the collection
as it is and with cases added to or removed from the port's tests.

The Tier-1 command runs `pytest tests/ -n 6 --dist load` under a 1470 s
`timeout`, and the suite needs far longer than that.  `--dist load`
hands each worker a run of N/24 consecutive tests, then tops a worker
whose queue falls below pending/24 up to pending/12, but not while it
has two or more tests queued behind one that took 0.1 s or longer.  A
worker held by one of the reference's long tests (4D-Var, the DA
drivers, the sharded steps) keeps the rest of its queue, so the count at
the cut depends on where N puts those runs, and on whether a free worker
is handed the port's tests (tests/test_torch_*, collected after
test_step2d_fb.py) before the cut.

Inputs:
  stamp    prefix each line of standard input with the seconds since
           start: pipe the Tier-1 command, run with -v instead of -q,
           through it to get LOG.
  replay   LOG (per-test times of the reference's tests, as completion
           gaps per worker), COLLECTION (`pytest tests/ -q -m 'not slow'
           --collect-only` output), DURATIONS (`pytest
           tests/test_torch_*.py -p no:xdist --durations=0` output, the
           port's per-test times on one worker) and SUITE_SUMMARY.json
           (whole-file times of tests LOG did not reach).

    python tools/xdist_load_replay.py replay LOG COLLECTION DURATIONS \
        --extra -30 0 40 100

prints, for each number of port cases added (cheap cases at the end of
the port's files; negative: port cases removed), the collection size and
for each speed factor the 20th percentile and median of the replayed
pass counts over randomly perturbed test times, and how many replays
reach --need passes.
"""

import argparse
import collections
import heapq
import json
import random
import re
import sys
import time

RESULT = re.compile(r"([0-9.]+) \[gw(\d+)\] \[\s*\d+%\] "
                    r"(PASSED|FAILED|SKIPPED|ERROR|XFAIL|XPASS) (\S+)")
DURATION = re.compile(r"([0-9.]+)s (call|setup|teardown)\s+(\S+)")


def stamp():
    t0 = time.time()
    for line in sys.stdin:
        print("%.1f %s" % (time.time() - t0, line), end="", flush=True)


def replay_once(coll, dur, status, limit, nodes=6):
    """Passes before `limit` seconds under xdist's LoadScheduling."""
    n = len(coll)
    pending = list(range(n))
    chunk = max(n // nodes // 4, 2)
    queue = [pending[k * chunk:(k + 1) * chunk] for k in range(nodes)]
    del pending[:nodes * chunk]
    heap = []

    def start(k, t):
        # a worker runs a test only with the next one queued
        if queue[k] and (len(queue[k]) >= 2 or not pending):
            i = queue[k][0]
            heapq.heappush(heap, (t + dur[coll[i]], k))

    for k in range(nodes):
        start(k, 0.0)
    passed = 0
    while heap:
        t, k = heapq.heappop(heap)
        if t > limit:
            break
        i = queue[k].pop(0)
        passed += status.get(coll[i], "PASSED") == "PASSED"
        if pending:
            lo = max(2, len(pending) // nodes // 4)
            hi = max(2, len(pending) // nodes // 2)
            if len(queue[k]) < lo and not (dur[coll[i]] >= 0.1
                                           and len(queue[k]) >= 2):
                take = hi - len(queue[k])
                queue[k] += pending[:take]
                del pending[:take]
        start(k, t)
    return passed


def replay(args):
    coll = [ln.strip() for ln in open(args.collection) if "::" in ln]
    events = [RESULT.match(ln) for ln in open(args.log, errors="replace")]
    events = [m for m in events if m]
    t0 = min(float(m.group(1)) for m in events) - 1.0
    dur, status, last = {}, {}, collections.defaultdict(lambda: t0)
    for m in events:
        t, gw, res, node = float(m.group(1)), m.group(2), m.group(3), \
            m.group(4)
        dur[node], status[node], last[gw] = t - last[gw], res, t
    port = collections.defaultdict(float)
    for ln in open(args.durations):
        m = DURATION.match(ln)
        if m:
            port[m.group(3)] += float(m.group(1))
    files = {f["file"]: f for f in json.load(open(args.summary))["files"]}
    for node in coll:
        name = node.split("::")[0].rsplit("/", 1)[-1]
        if node in dur:
            continue
        if name.startswith("test_torch"):
            # one worker among six shares the host's cores
            dur[node] = port.get(node, 0.005) * 1.5 + 0.01
            status[node] = "SKIPPED" if "test_torch_cuda" in node \
                else "PASSED"
        elif name in files:
            f = files[name]
            dur[node] = f["seconds"] / max(1, f["passed"] + f["failed"])
        else:
            dur[node] = 10.0
    last_port = max(i for i, c in enumerate(coll) if "test_torch" in c)
    limit = args.limit - t0
    rng = random.Random(args.seed)
    for extra in args.extra:
        c = list(coll)
        if extra < 0:
            drop = {i for i, x in enumerate(c) if "test_torch_tiles" in x}
            drop = set(sorted(drop)[:-extra])
            c = [x for i, x in enumerate(c) if i not in drop]
        else:
            added = [f"tests/test_torch_added.py::case[{k}]"
                     for k in range(extra)]
            c = c[:last_port + 1] + added + c[last_port + 1:]
            for a in added:
                dur[a] = 0.05
        row = []
        for speed in args.speeds:
            counts = sorted(
                replay_once(c, {x: dur[x] * speed * rng.lognormvariate(
                    0, 0.2) for x in c}, status, limit)
                for _ in range(args.trials))
            row.append("x%.1f: %d/%d %d/%d" % (
                speed, counts[len(counts) // 5], counts[len(counts) // 2],
                sum(x >= args.need for x in counts), len(counts)))
        print(f"{extra:+d} N={len(c)}  " + "  ".join(row), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("stamp")
    r = sub.add_parser("replay")
    r.add_argument("log")
    r.add_argument("collection")
    r.add_argument("durations")
    r.add_argument("--summary", default="SUITE_SUMMARY.json")
    r.add_argument("--extra", type=int, nargs="+", default=[0])
    r.add_argument("--speeds", type=float, nargs="+",
                   default=[0.7, 0.8, 0.9, 1.0, 1.1, 1.2])
    r.add_argument("--trials", type=int, default=20)
    r.add_argument("--limit", type=float, default=1470.0)
    r.add_argument("--need", type=int, default=296)
    r.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    stamp() if args.cmd == "stamp" else replay(args)


if __name__ == "__main__":
    main()
