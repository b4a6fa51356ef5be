"""Serve-plane CLI: run resident workers and submit tenant jobs.

The port of ``sctools_tpu.serve.cli``.
``python -m sctools_tpu_torch.serve <command>``:

- ``worker <journal_dir>`` — run one resident replica: warm its graph set
  (tracing a calibration BAM through the real gatherer, so the graph of
  every signature it reaches is captured before admission), then serve
  until drained, idle or a job quota. Exits with a one-line JSON summary on
  stdout: jobs committed, time to the first result, the warmup's seconds,
  pack counts, and the graph captures (at warmup and while serving),
  replays and keys. Its
  ``profile`` is always null: the JAX package's run profile is not ported.
  The worker runs on ``cuda`` unless the caller of :func:`main` asks for
  ``cpu``.
- ``submit <journal_dir> --job TENANT BAM OUT ...`` — register tenant jobs
  in the journal (content-hashed ids, the JAX package's: resubmitting the
  same job is a no-op). Submission is journal-only; any worker (or
  ``python -m sctools_tpu_torch.sched resume``) may pick the jobs up.

The worker takes every knob as a flag, once, at spawn. The JAX parser's
``--manifest`` and ``--steer-epoch`` are left out: nothing in the port
would read them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .api import DEFAULT_ADMISSION_DEPTH, SERVE_TASK_KIND, ServeJob


def submit_jobs(journal_dir: str, jobs: List[ServeJob]) -> int:
    """Register jobs (idempotently) in the journal; returns the new count.

    Each job is stamped with its submit wall timestamp, but the task id
    hashes only the identity payload, so resubmitting the same job later
    still dedupes to the existing task (the first submit's time wins).
    """
    from ..sched.journal import Journal, Task, task_id, wall_clock

    journal = Journal(journal_dir, worker_id="serve-submit")
    try:
        now = round(wall_clock(), 6)
        tasks = []
        for job in jobs:
            if job.submitted is None:
                job = ServeJob(job.tenant, job.bam, job.out, submitted=now)
            name = f"{job.tenant}/{os.path.basename(job.out)}"
            tasks.append(
                Task(
                    id=task_id(
                        SERVE_TASK_KIND, name, job.identity_payload()
                    ),
                    kind=SERVE_TASK_KIND,
                    name=name,
                    payload=job.payload(),
                )
            )
        return len(journal.register(tasks))
    finally:
        journal.close()


def _cmd_worker(args, out, device) -> int:
    from ..metrics.gatherer import DEFAULT_BATCH_RECORDS
    from .engine import ServeWorker

    with ServeWorker(
        args.journal_dir,
        worker_id=args.worker_id,
        max_depth=args.max_depth,
        batch_records=args.batch_records or DEFAULT_BATCH_RECORDS,
        compress=not args.no_compress,
        lease_ttl=args.lease_ttl,
        poll_interval=args.poll_interval,
        device=device,
    ) as worker:
        worker.warmup(calibration_bam=args.calibration_bam)
        committed = worker.serve_forever(
            max_jobs=args.max_jobs,
            idle_timeout_s=args.idle_timeout,
            drain=args.drain,
        )
        print(
            json.dumps(
                {
                    "worker": worker.worker_id,
                    "jobs_committed": committed,
                    "first_result_s": worker.first_result_s,
                    "warmup_s": worker.warmup_s,
                    "packs_run": worker.packs_run,
                    "packs_degraded": worker.packs_degraded,
                    "profile": None,
                    "graphs": worker.graph_stats(),
                }
            ),
            file=out,
        )
    return 0


def _cmd_submit(args, out, device) -> int:
    jobs = [
        ServeJob(tenant=tenant, bam=bam, out=stem)
        for tenant, bam, stem in args.job
    ]
    if not jobs:
        print("submit: no --job TENANT BAM OUT given", file=sys.stderr)
        return 2
    fresh = submit_jobs(args.journal_dir, jobs)
    print(
        f"registered {fresh} new job(s) ({len(jobs) - fresh} already known)",
        file=out,
    )
    return 0


def main(argv: Optional[List[str]] = None, out=None, device=None) -> int:
    """Run one CLI command; returns its exit code. ``device``: where
    ``worker`` runs, ``cuda`` unless the caller asks for ``cpu``."""
    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m sctools_tpu_torch.serve",
        description="resident serving plane on the card",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    worker = sub.add_parser(
        "worker", help="run one resident replica over a journal"
    )
    worker.add_argument("journal_dir")
    worker.add_argument("--worker-id", default=None)
    worker.add_argument(
        "--calibration-bam",
        default=None,
        help="warmup traces this BAM through the real gatherer so the graph "
        "of every signature it reaches is captured before admission",
    )
    worker.add_argument("--max-jobs", type=int, default=None)
    worker.add_argument(
        "--idle-timeout",
        type=float,
        default=None,
        help="exit after this many seconds with nothing claimable",
    )
    worker.add_argument(
        "--drain",
        action="store_true",
        help="exit as soon as no open serve task remains",
    )
    worker.add_argument(
        "--max-depth", type=int, default=DEFAULT_ADMISSION_DEPTH
    )
    worker.add_argument(
        "--batch-records",
        type=int,
        default=None,
        help="streaming batch size (bucket capacity for packing)",
    )
    worker.add_argument("--no-compress", action="store_true")
    worker.add_argument("--lease-ttl", type=float, default=30.0)
    worker.add_argument("--poll-interval", type=float, default=0.25)
    worker.set_defaults(fn=_cmd_worker)

    submit = sub.add_parser(
        "submit", help="register tenant jobs in a serve journal"
    )
    submit.add_argument("journal_dir")
    submit.add_argument(
        "--job",
        nargs=3,
        metavar=("TENANT", "BAM", "OUT"),
        action="append",
        default=[],
    )
    submit.set_defaults(fn=_cmd_submit)

    args = parser.parse_args(argv)
    return args.fn(args, out, device)
