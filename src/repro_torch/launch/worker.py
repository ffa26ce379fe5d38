"""Sweep worker — one node of the distributed sweep farm.

Connects to a :class:`repro.core.distrib.QueueDispatcher`, handshakes
(protocol version + code fingerprints + the run's queued-key manifest),
then pulls chunks of DES cells and runs them through this process's
long-lived compiled engine until the dispatcher says shutdown.  Each
chunk runs as one `run_des_chunk` call — adjacent same-body policy
siblings share a staging prototype and results take the lean terminal
scatter (DESIGN.md Section 13) — so per-cell Python boundary cost is
paid once per chunk, not once per cell.  The
dispatcher spawns local workers itself; this entry point exists for
*remote* fan-out — run it on any machine that shares the code tree::

    PYTHONPATH=src python -m repro_torch.launch.worker --connect host:5055 \
        --cache-dir /scratch/sweep_cache

With ``--cache-dir`` the worker keeps a local record cache: queued keys it
already holds are *prefilled* to the dispatcher before any cell runs, and
every computed chunk is persisted locally as a packfile — so a farm warms
across runs and a re-run ships bytes, not simulations.  Safe by
construction: cache keys are content-addressed and host-independent
(DESIGN.md Section 5), and the fingerprint handshake refuses a dispatcher
running different result-determining code.

``--die-after N`` hard-exits the process after N computed cells — failure
injection so the re-dispatch path stays testable end to end.

Exit codes: 0 clean shutdown, 1 dispatcher vanished, 3 fingerprint
mismatch.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core.distrib import worker_serve
from repro_torch.core.sweep import code_fingerprints


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="dispatcher address (from the parent sweep run)")
    ap.add_argument("--cache-dir", default=None,
                    help="local record cache: prefill queued keys from it "
                         "and persist computed chunks into it")
    ap.add_argument("--heartbeat", type=float, default=1.0,
                    help="seconds between liveness frames (the dispatcher "
                         "may override via the welcome frame)")
    ap.add_argument("--connect-timeout", type=float, default=10.0,
                    help="keep retrying the connect this long")
    ap.add_argument("--die-after", type=int, default=None, metavar="N",
                    help="failure injection: hard-exit after computing N "
                         "cells (never send their result frame)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-chunk progress lines")
    args = ap.parse_args(argv)

    host, _, port = args.connect.rpartition(":")
    if not host or not port.isdigit():
        ap.error(f"--connect wants HOST:PORT, got {args.connect!r}")

    def log(msg: str) -> None:
        if not args.quiet:
            print(f"[worker] {msg}", flush=True)

    return worker_serve(
        host, int(port),
        cache_dir=args.cache_dir,
        fingerprints=code_fingerprints(),
        heartbeat_s=args.heartbeat,
        connect_timeout_s=args.connect_timeout,
        die_after=args.die_after,
        log=log,
    )


if __name__ == "__main__":
    sys.exit(main())
