#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``sctools_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py [--seed N] [--reads N]

Phases, in order; any failure exits non-zero before the last line:

1. device  -- requires ``torch.cuda.is_available()``; prints the card's name
              and power limit as nvidia-smi gives them, and the versions;
2. build   -- compiles every kernel of ``sctools_tpu_torch/csrc`` with nvcc
              and, at the same time, the native host layer
              (``sctools_tpu_torch/native``) with g++ against zlib; prints the
              toolchain (g++, which of zlib.h and libdeflate.h it finds, the
              libz it links, the cores), the native layer's thread count and
              the seconds;
3. kernel  -- the whitelist kernel against its plain torch version, exactly,
              at the 10x v2 shape (65,536 queries x a 737,280-barcode
              synthetic whitelist) and on edge cases; times the kernel, the
              plain version and two library score products alone (cuBLAS
              float32, and torch._int_mm on the int8 one-hot tables);
4. attach  -- ``TenXV2.attach_barcodes`` through the port's argparse entry
              on 262,144 synthetic reads (4 batches of 65,536) with the
              737,280-barcode whitelist; every record's tags are re-read and
              checked, CB against the plain version's answer for its CR; the
              run must take the native loop (``native.calls``). The library
              leg: on 65,536 further reads (26 bp R1, 8 bp I1; 85% exact,
              8% one substitution, the rest random, 64 planted within
              distance 1 of two barcodes) and a 100,000-barcode whitelist,
              ``bam.Tagger`` over ``BarcodeGeneratorWithCorrectedCellBarcodes``
              and ``EmbeddedBarcodeGenerator`` (the host hash map, no kernel)
              must write the records the attach writes (one kernel launch),
              body for body, with equal exact, corrected, ambiguous and
              uncorrectable counts;
5. metrics -- ``GenericPlatform.calculate_cell_metrics`` and
              ``calculate_gene_metrics`` on the card at the gatherer's
              2^20-record batch width: a synthetic 10x v2 library on GRCh38's
              25 primary sequences, 1,250,000 records sorted by (CB, UB, GE)
              and 1,150,000 of them by (GE, CB, UB), each one full batch, a
              remainder and a carried tail; the CSVs of the commands, of the
              same frames on the card and of the same frames on the CPU must
              be equal byte for byte (decompressed), and per cell n_reads,
              n_molecules, n_genes and n_mitochondrial_molecules must equal
              the generator's counts. The cell frames again through
              ``GatherCellMetrics(bam, stem, mito, False)``, JAX's positional
              order (``compress=False``), must give the keyword run's CSV
              byte for byte as plain text, and ``extract_metrics(mode="r")``
              over a SAM text copy of the cell BAM's first 32,768 records
              the CSV of the same records as BAM. Each command must decode
              through the ingest ring's native arena stream and render its
              CSV through
              the native block formatter (``native.calls``). Prints
              records/s, the wall split (the ring's producer seconds of
              decoding on its thread beside this thread's wait on the ring,
              and the ring's batches), device milliseconds per batch and the
              profiler's top device ops, and the decode alone: the port's Python decoder
              against the native stream over the first 2^16 records of the
              cell BAM, in turns, with equal frames. The metrics path has no
              hand kernel; the phase checks that none launched. The
              commands' CSVs stay for phase 6, the cell CSV and BAM for
              phase 8;
6. count   -- ``GenericPlatform.bam_to_count_matrix`` (CreateCountMatrix) on
              the card at the count's 2^19-record batch width: a
              queryname-grouped 10x v2 library of 750,000 queries (~1,180,000
              records: two full batches, a remainder, carried tails) over all
              33,538 genes of a GTF. The matrix must equal a numpy count of the
              reference's rule over the generator's columns, entry for entry
              and in row order; the file's frames, decoded again and counted
              on the card and on the CPU, must give the same files; the matrix
              split in two must merge back (MergeCountMatrices), and phase 5's
              CSVs must merge as they should (MergeCellMetrics of the cell CSV
              in two files, MergeGeneMetrics of the gene CSV with itself).
              The command must decode through the ingest ring's native
              arena stream. Prints records/s, the wall split (the ring's
              producer decode beside the wait on it), the idle share, and the count
              pass alone on one staged full batch with its top device ops. No
              hand kernel may launch;
7. fastq   -- ``TenXV2.fastq_process`` (FastqProcess -w) on 262,144 synthetic
              10x v2 triplets in two triplet files with the 737,280-barcode
              whitelist, 4 shards from ``--bam-size``, in BAM and in FASTQ
              mode: every shard re-read, every read once, its tags, bases and
              qualities equal to the generator's and its CB to the plain
              version's on the card, the counters, the same shard in both
              modes; ``check_barcode_partition`` 0 on the shards, 1 on a
              shard beside its copy; ``GenericPlatform.sample_fastq`` on
              131,072 slide-seq pairs (8C18X6C9M1X) with a 100,000 x 14 bp
              whitelist, every kept read's R1 rewrite and R2 exact;
              ``fastq_metrics`` on the R1 files against numpy counts. Each
              command must take its native loop (``native.calls``). Prints
              reads/s, the wall split, the BGZF pool's threads and the
              kernel launches of each command, which must equal its batches;
8. sort    -- ``GenericPlatform.tag_sort_bam`` (TagSortBam -t CB UB GE
              --cell-metrics-output -a -o) on the card: phase 5's 1,250,000
              cell records in a shuffled order, sorted on the host by the
              native sort in 3 partials of the default 500,000 records,
              merged through a pipe into the native decoder's 2^20-record
              frames, behind the ingest ring's prefetch stage, for the
              metrics pass on the card in one pass that also writes the
              sorted BAM (``native.calls`` must show that route).
              The CSV must equal
              phase 5's CalculateCellMetrics CSV byte for byte (decompressed)
              and the sorted BAM hold the input's record bodies in phase 5's
              order. ``native.tagsort_stream_frames`` over 200,000 of
              the shuffled records, called in JAX's positional order with
              ``bam_compress_level=6``, ``n_threads=2`` and
              ``want_qname=True``, must tee the record bodies of its run
              with the defaults (level 1, no query names) in fewer bytes,
              in their sorted order, yield every record's query name in
              that order, and leave no partial beside its tee;
              ``verify_bam_sort`` 0 on the sorted BAM, SortError on the
              shuffled BAM. ``split_bam`` (-t CB CR, 4 chunks, 4 processes) on phase
              7's BAM shards: every record in exactly one chunk (byte for
              byte but the bin field, which the writer re-encodes), no scratch
              directory left, ``check_barcode_partition`` 0 on the chunks.
              ``group_qc_outputs`` of all five types on small Picard, HISAT2,
              RSEM and Core inputs, every value read back. Prints records/s,
              the sort's split by phase (read, chunk sort, partial writes,
              merge), the metrics pass's split and the idle share; no hand
              kernel may launch;
9. mesh    -- ``--devices 2`` on the card: CalculateCellMetrics and
              CalculateGeneMetrics on phase 5's BAMs, CreateCountMatrix on
              phase 6's, MergeCellMetrics / MergeGeneMetrics (the collective
              merges) on phase 6's merge inputs and the fused TagSortBam on
              phase 8's shuffled BAM, through their entry points on a
              2-shard mesh: two distinct cards where the machine has them,
              else [cuda:0, cuda:0] (then ``--devices 2`` alone must stop at
              the parser, and the commands get the one-card mesh in its
              place). Every CSV must equal its one-device phase's byte for
              byte (decompressed), the count matrix phase 6's, the merges
              the host merges'. ``collective_preflight``,
              ``distributed_metrics_step`` and ``distributed_sort`` on the
              card mesh, over the cell BAM's first 2^18 records, must equal
              the same on a 2-shard CPU mesh. Prints each command's wall
              and ``seconds``; no hand kernel may launch;
10. sched  -- the chunk queue (``sctools_tpu_torch.sched``,
              ``parallel.launch``) on the card: ``split_bam -t CB`` cuts
              two of phase 5's five cell chunks (cell-disjoint cuts of its
              cell BAM, 40% of its records) into 5 chunks, every record in
              exactly one of them (name, cell, UMI, gene and position as
              the native decoder reads them) and no cell in two; over phase
              5's five chunks, two worker processes
              (``chip_smoke.py --sched-worker``, each its own CUDA context)
              run ``run_process_cell_metrics`` on cuda with a 2 s lease TTL:
              A is killed at its first batch of chunk0000 (exit 86), B, a
              straggler that fails chunk0002 twice, steals A's expired lease
              and drains the queue; a clean relaunch makes no attempt and
              ``python -m sctools_tpu_torch.sched status`` exits 0. The
              parts merged with ``merge_sorted_csv_parts`` (journal and
              sequence checks) and with ``collective_merge_parts`` on the
              card mesh must both equal phase 5's CalculateCellMetrics CSV
              byte for byte (decompressed). Prints each worker's wall,
              attempts, steals and exit code and both merges' seconds; no
              worker may launch a hand kernel. Its chunks stay for phase 11;
11. serve  -- the serving plane (``sctools_tpu_torch.serve``) on the card:
              phase 10's five chunks and six small 30,000-record libraries
              (two a tenant, which the planner's file-size estimate puts in
              the chunks' packs) submitted as three tenants' jobs
              (``python -m sctools_tpu_torch.serve submit``); worker
              processes (``chip_smoke.py --serve-worker``, each ``python -m
              sctools_tpu_torch.serve worker`` on cuda with a 2 s lease TTL
              at the 2^20-record batch width): wA leases one job a tenant
              and is SIGTERM'd inside its pack (an injected
              ``delay@task.claimed``); wB and its replacement wC, each warmed
              on phase 5's cell BAM (its CUDA graphs captured), drain the
              journal in cross-tenant packs. Every job must commit, none
              quarantined, a lease be stolen, a pack hold two tenants, no
              pack degrade and no graph key be captured twice; every served
              CSV must equal its input's solo CalculateCellMetrics CSV on
              the card and the chunks' merge the
              one-shot CSV of phase 5's cell BAM (without -a: a serve job
              carries no GTF), byte for byte (decompressed); ``python -m
              sctools_tpu_torch.sched status`` must exit 0 with the tenant,
              admission, steer and balanced rows lines. Prints each worker's
              warmup, first result, packs, graph captures and replays, the
              pack plans, jobs/s, and one full batch's device pass eager
              against graph replay (presorted and device-sorted); no worker
              may launch a hand kernel;
12. dist   -- processes joined into one mesh on the card: two worker
              processes (``chip_smoke.py --dist-worker``, each its own CUDA
              context) join one ``torch.distributed`` group with
              ``initialize_distributed``, on distinct cards over NCCL where
              the machine has two or more, else both on cuda:0 over gloo
              (the phase asserts the transport it expects). Tier 1: phase
              10's five chunks through ``run_process_cell_metrics`` on cuda
              under the group, ``sync_processes``, rank 0's
              ``merge_sorted_csv_parts``, equal to phase 5's
              CalculateCellMetrics CSV byte for byte (decompressed). Tier 2:
              phase 5's whole cell BAM (1,250,000 records) partitioned by
              cell into 2 shards of the gatherer's 2^20 width, one a process,
              through ``host_local_to_global`` into
              ``distributed_metrics_step`` on the 2-shard ``global_mesh``;
              every per-shard output must equal this process's in-process
              ``[cuda:0, cuda:0]`` step on the same stacked columns, bit for
              bit. Prints the transport, each worker's init seconds, the
              step's wall and device milliseconds (CUDA events) per process
              and the bytes its ``all_to_all`` sent across the process
              boundary; no worker may launch a hand kernel;
13. analysis -- the port's static checks and its runtime lock witness on
              this machine: ``python -m sctools_tpu_torch.analysis
              sctools_tpu_torch chip_smoke.py --json`` with the lint
              (SCX113 and SCX114 among its rules), ABI, tsan.supp audit,
              race and life passes (phase 19 runs every pass) must exit 0
              with no finding, and ``--emit-lock-graph`` writes the static lock
              graph. Two worker processes (``chip_smoke.py
              --analysis-worker``), unwitnessed and then under
              ``SCTOOLS_TPU_LOCK_DEBUG=1`` (with that graph),
              ``SCTOOLS_TPU_FRAME_DEBUG=1``, ``SCTOOLS_TPU_TRACE`` and
              ``SCTOOLS_TPU_PULSE=1`` (so that every lock is taken), each
              run attach -w on 131,072 new synthetic reads (2 kernel
              batches; the witnessed one's launches must equal its batches)
              and one sched worker draining phase 10's five chunks. The
              witnessed BAM must equal the unwitnessed one byte for byte and
              each merged CSV phase 5's (decompressed); the witnessed
              worker's ``locks.<worker>.json`` (named after the sched
              worker's journal id, as ``obs.configured_worker_name`` gives
              it) must hold no violation, only blocking edges of the static
              graph, and an acquisition of every lock in it; the frame
              witness must have stamped frames and seen no stale read.
              Prints the passes' seconds and files, the locks, edges and
              entries, each lock's acquisitions and the witnessed walls
              beside the unwitnessed ones. Its attach inputs stay for phase
              14;
14. tracing -- the observability layer (``sctools_tpu_torch.obs``) on the
              card. Four steps: attach -w on phase 13's 131,072 reads (2
              kernel batches), CalculateCellMetrics on phase 5's cell BAM
              and CreateCountMatrix on phase 6's BAM at their full batch
              widths, and one serve worker draining three jobs (two of phase
              10's chunks and a small library, which the planner packs with
              one chunk across tenants). Each runs untraced (the four in
              one worker process, in turn) and then traced, each traced run
              in a worker process of its own (``chip_smoke.py
              --trace-worker``), with
              ``SCTOOLS_TPU_TRACE=<dir>``, ``SCTOOLS_TPU_PULSE=1`` and its
              own ``SCTOOLS_TPU_TRACE_WORKER``. Every traced output must
              equal the untraced one (the BAM bytes, the CSVs decompressed,
              the count arrays); every trace line parse; the decode,
              upload, compute and writeback spans' records equal the
              inputs' records; every ``metrics.*.prom`` line be Prometheus
              exposition; the rings parse untorn, their heartbeats equal the
              batches, and each worker's exposed legs plus ``overlap`` and
              ``idle`` sum to its ``wall_s``; the serve worker's summary name
              a complete, schema-valid profile; ``python -m
              sctools_tpu_torch.obs summarize|pulse|slo|delta`` exit 0 on
              the captures; attach's launches equal its batches and no other
              step launch a hand kernel. Prints each step's wall untraced
              and traced, what one span, one heartbeat, one
              ``xprof.record_dispatch`` and one ``xprof.record_transfer``
              cost on the host (20,000 of each, traced and not) and so each
              step's records, and ``bubble_fraction`` and
              ``limiting_stage`` per stage. Its inputs, its untraced attach
              BAM and its traced cell run stay for phase 15;
15. efficiency -- the device half of the observability layer
              (``obs.xprof``, ``obs.fleet``) on the card, every step traced
              (``SCTOOLS_TPU_TRACE``, ``SCTOOLS_TPU_PULSE=1``) in a worker
              process of its own: two sched workers (phase 10's
              ``--sched-worker``, each claim delayed 0.5 s so that both take
              chunks) drain phase 10's five chunks at the 2^20 batch width,
              then again with worker A crashed at its first batch of
              chunk0000 and B stealing it (A's registry is the one its
              flight record carries); attach -w on phase 13's
              131,072 reads (2 batches of 65,536) against the
              737,280-barcode whitelist; CreateCountMatrix on phase 6's BAM;
              one serve worker warmed on its CUDA graphs (phase 14's steps).
              Checks: every declared site of every worker is in the merged
              ``python -m sctools_tpu_torch.obs efficiency --json``; 0
              retraces at every site and 1 or more compiles (graph captures)
              at the serve worker's; each site's real rows equal its inputs'
              records times the passes; every worker's transfer ledger equals
              its own spans' and heartbeats' bytes, per site and direction;
              ``whitelist.correct_pallas``'s dispatches equal the kernel's
              launches and the attach's batches, and its BAM equals phase
              14's untraced one byte for byte; the memory peak is above 0,
              at most the card's memory and attributed to a stage; ``obs
              timeline`` merges both clean workers onto the journal's clock,
              gives every committed task one lineage, an occupancy and a
              critical path, and shows the crash run's steal; ``sched
              status`` prints the ``device:`` line; ``obs delta`` between
              phase 14's traced cell run and the sched run reports sites and
              transfers. Prints each site's calls, compiles, dispatches,
              rows and occupancy, the bytes per direction and site, the
              memory peak, the recording calls' cost and the device line;
16. audit  -- the flight recorder and the record-conservation ledger
              (``obs.flight_dump``, ``obs.audit``) on the card, each worker
              traced (``SCTOOLS_TPU_TRACE``, ``SCTOOLS_TPU_PULSE=1``) in a
              process of its own: sched worker A (phase 10's
              ``--sched-worker``) commits chunk0000 of phase 10's five chunks
              and is crashed at chunk0001's first batch, B steals chunk0001
              and drains the queue; ``merge_sorted_csv_parts`` joins the
              parts, which must equal phase 5's CalculateCellMetrics CSV
              (decompressed). A's ``flight.<worker>.jsonl`` must name the
              crash and the open ``sched:task`` span and carry the ``pulse``
              (its last heartbeats) and ``ring_slots`` sections and a
              registry with ``parallel.sharded_metrics``, which ``obs
              timeline`` and ``obs efficiency`` read (``from_flight``).
              ``python -m sctools_tpu_torch.obs audit`` must exit 0 with
              ``RESULT: EXACT`` over the 1,250,000 records (ingested =
              decoded = computed, counted once over the committed attempts;
              rows computed = emitted + filtered; the merge's rows in =
              out); ``obs explain --job chunk0001`` must narrate both
              attempts and the steal, ``--barcode`` resolve a cell to its
              part's and the merged CSV's rows; a fabricated quarantine
              sidecar line must make the same journal audit UNBALANCED
              (exit 1). A worker SIGTERM'd inside its task must leave a
              flight record (``signal:SIGTERM``, its ring slots) and still
              die of the signal; a rerun in this process steals and commits
              the chunk, EXACT. Phase 11's serve journal must audit EXACT,
              each pack's routed rows equal its emitted rows, and the
              exporter's body hold every tenant's ``sctools_tpu_audit_``
              gauges; an ABBA cycle in a child process under the lock
              witness must write a flight record ``lock-witness:cycle``
              beside the witness's snapshot. Prints the workers, the
              records, one ``flight_dump``'s and one ``audit.add``'s cost;
              no worker may launch a hand kernel;
17. steer  -- online steering (``sctools_tpu_torch.steer``) and the graph
              manifest on the card: 24 jobs of 4 tenants (2,700 records
              each: 675 cells x 2 molecules x 2 reads of 48 bases, on
              disjoint barcodes) drained twice by a 2-worker fleet (phase
              11's ``--serve-worker``, each traced with
              ``SCTOOLS_TPU_PULSE=1``, warmed on a 10,240-record calibration
              library at ``--batch-records 4096``): first with
              ``SCTOOLS_TPU_STEER=0``, then armed with ``--steer-epoch 0.1``,
              where warmup captures the graphs of every rung of the
              controller's ladder. No job may be lost and every artifact
              must equal its job's solo CalculateCellMetrics CSV on the card
              (decompressed); the armed leg's occupancy (real over padded
              rows in the pulse rings, warmup beats excluded) must be
              strictly above the static leg's; it must journal an
              ``applied`` decision, each applied bucket inside its worker's
              announced ladder and resident; both legs' registries must show
              0 retraces and every recorded signature inside the graph
              manifest's contract (``shardcheck.check_signatures``); every
              worker must capture 0 graphs while serving; every bucket a
              controller announced resident or applied must pass the
              contract's ``dim_admissible``; the static leg must announce
              only ``{"mode": "off"}``. Before the legs, the committed
              ``serve/graph_manifest.json`` must pass the AOT pass's
              staleness gate (``--aot-only --aot-manifest``). Prints each
              leg's captures at warmup and while serving, replays,
              occupancy, packs by bucket, decisions and wall; no worker may
              launch a hand kernel;
18. guard  -- the guard ladder (``sctools_tpu_torch.guard``) and the
              writeback ring on the card, after the JAX package's
              tests/guard_smoke.py, each run a process of its own. (a) Two
              sched workers (phase 10's ``--sched-worker``), traced
              (``SCTOOLS_TPU_TRACE``, ``SCTOOLS_TPU_PULSE=1``) and witnessed
              (``SCTOOLS_TPU_LOCK_DEBUG=1`` with the static lock graph,
              ``SCTOOLS_TPU_FRAME_DEBUG=1``), drain phase 10's five chunks
              at the 2^20-record width with
              ``SCTOOLS_TPU_GUARD_TIMEOUT_COMPUTE=20`` under a fault
              cocktail: a ``device_oom`` at ``gatherer.dispatch`` on
              chunk0001, one ``xla_transient`` at ``gatherer.dispatch`` and
              one at ``gatherer.writeback`` a worker, a 60 s ``stall`` on
              chunk0002 and ``corrupt_record`` at records 3 and 10 of
              chunk0000; a fault-free twin pair with
              ``SCTOOLS_TPU_WIRE_OVERLAP=0`` drains the same chunks less those
              two records (cut out with the port's ``io.sam``). Every task
              must commit once with no ``failed`` event, the sidecars name
              exactly the two records, the merged CSV equal the twin's
              (decompressed), 0 retraces, at least one OOM bisection, two
              transient retries and one stall, two poison records; the lock
              witness must show no violation and acquire the guard's five
              locks, the frame witness no stale read; ``obs audit`` EXACT
              with ``records.quarantined:PoisonData`` = 2, ``sched status``
              naming the quarantined records, and the stall's flight record
              ``guard_retries``, ``guard_degraded`` ({}) and
              ``writeback_slots``. (b) A child measures the peak device
              memory of one full batch of phase 5's cell BAM and of one
              2^19 batch, caps itself between them
              (``torch.cuda.set_per_process_memory_fraction``) and runs
              CalculateCellMetrics: a genuine ``torch.OutOfMemoryError``
              must classify ``resource_exhausted`` and bisect, and the CSV
              equal phase 5's. (c) Attach -w of phase 13's 131,072 reads
              under ``xla_transient@whitelist.correct:times=1``: one retry,
              launches = batches = 2, the BAM equal phase 14's untraced one
              byte for byte. (d) ``native.synth_bam_native`` writes 1,000
              cells and the ring decodes as many records as it returned.
              Prints the peaks and the cap, the counters, what a fault-free
              ``run_batch`` and ``retrying`` cost on the host (20,000 of
              each) and each step's wall; no sched worker and no step but
              (c) may launch a hand kernel;
19. discipline -- the static checks (``sctools_tpu_torch.analysis``) on the
              card machine: the gate (``--json``, every pass, scx-shard,
              scx-aot, the tsan.supp audit and the lint's SCX113 and SCX114
              among them) over the port and this script; ``--list-rules``
              naming exactly the passes' rule tables, and a seeded corpus
              giving SCX113, SCX114 and SCX302 (the line before names this
              host's sanitizer runtimes, for information); and
              ``--emit-transfer-inventory`` / ``--emit-collective-schedule``
              / ``--emit-shape-contract`` into the run directory; the merged
              transfer ledgers of phases 14-15's traced workers (attach,
              cell, count, serve, sched) against the inventory (0 phantom
              sites, 0 wrong directions) and the signatures of their merged
              registries and of phase 17's serve workers against the shape
              contract (0 violations); the autotuner (``--retune``)
              against a copy of ``sctools_tpu_torch``, over all those
              registries and over phase 17's static serve fleet's alone,
              each a dry run and then an applied run whose gates pass
              (exit 0) or restore the copy's ``ops/segments.py`` byte for
              byte (exit 5), the repository's own file untouched; then, at
              a smaller depth
              (131,072 records), phase 9's ``--devices 2`` gene command,
              preflight and sample sort in one worker and phase 12's two
              joined processes, each unwitnessed and then under
              ``SCTOOLS_TPU_MESH_DEBUG=1`` with the emitted schedule
              (``SCTOOLS_TPU_MESH_SCHEDULE``) and a trace dir: every
              ``mesh.<worker>.json`` non-empty with 0 violations, the two
              processes' per-region schedules identical, every observed
              (name, axis) inside the static schedule, the witnessed outputs
              byte-equal to the unwitnessed ones, and ``obs efficiency``
              printing the collectives section from the dumps. Prints the
              gate's time, the sites, the contract's sites and the
              signatures checked, the derived constants, and each worker's
              unwitnessed and witnessed walls; no worker may launch a hand
              kernel;
20. kernels -- one JSON line per the port's kernel contract; its launches are
              those of every main-path run (phases 4, 7, 13, 14, 15 and 18).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The whitelist and the metrics library are synthetic, made from ``--seed``;
the whitelist has the size and length of Cell Ranger's
737K-august-2016.txt. Work files go to ``.chip_smoke_work/`` in the
checkout and are removed at the end.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import csv
import gzip
import io
import json
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".chip_smoke_work"
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
WHITELIST_SIZE = 737_280  # Cell Ranger's 737K-august-2016.txt
CB_LEN, UMI_LEN, SAMPLE_LEN = 16, 10, 8  # 10x v2 (sctools_tpu/platform.py:916-922)
R1_LEN, R2_LEN = 28, 98
BATCH = 1 << 16
# query mix: exact, one ACGT substitution, one N, two substitutions, random,
# lowercase or short
MIX = ("exact", "sub1", "n1", "sub2", "random", "odd")
MIX_P = (0.85, 0.08, 0.02, 0.02, 0.02, 0.01)
INT32_OPS_PER_CLOCK_PER_SM = 64  # Hopper: IADD3/LOP3/SHF/ISETP/SEL
POPC_PER_CLOCK_PER_SM = 16  # Hopper: POPC
# NVIDIA's published H100 SXM peaks (dense, at the 700 W power limit)
INT8_TENSOR_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def log(message: str) -> None:
    print(message, flush=True)


def nvidia_smi(query: str) -> str:
    result = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return result.stdout.strip().splitlines()[0]


def to_card(array: np.ndarray, device):
    """``array`` on ``device`` through the port's host->device seam."""
    import torch

    from sctools_tpu_torch import ingest

    return ingest.upload(array, torch.device(device), site="smoke.upload")


def cuda_ms(fn, repeats: int, warmup: int = 2, groups: int = 3) -> float:
    """Device milliseconds per call of ``fn``.

    ``repeats`` calls are queued back to back between two CUDA events, so
    the host's work to enqueue one call runs while the card executes the
    one before and stays out of the window; the median over ``groups``
    such windows.
    """
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / repeats)
    return statistics.median(times)


# ---------------------------------------------------------------- inputs


def make_whitelist(rng: np.random.Generator, n: int, length: int) -> np.ndarray:
    """[n, length] ASCII letters of a random whitelist."""
    return LETTERS[rng.integers(0, 4, size=(n, length), dtype=np.uint8)]


def make_queries(rng, whitelist: np.ndarray, n: int):
    """Barcodes drawn from ``whitelist`` in the MIX proportions.

    Returns ([n, L] ASCII array, lengths, kinds). An "odd" query is all
    lowercase or cut short by 6 bases (its length says which).
    """
    length = whitelist.shape[1]
    kinds = rng.choice(len(MIX), size=n, p=MIX_P)
    out = whitelist[rng.integers(0, whitelist.shape[0], size=n)].copy()
    rows = np.arange(n)
    pos = rng.integers(0, length, size=(n, 2))
    if length > 1:  # a second position, distinct from the first
        pos[:, 1] = (pos[:, 0] + 1 + rng.integers(0, length - 1, size=n)) % length

    def substitute(mask, p):
        codes = np.searchsorted(LETTERS, out[mask, p[mask]])
        out[mask, p[mask]] = LETTERS[(codes + rng.integers(1, 4, size=mask.sum())) % 4]

    sub1, n1, sub2 = (kinds == MIX.index(k) for k in ("sub1", "n1", "sub2"))
    substitute(sub1, pos[:, 0])
    out[rows[n1], pos[n1, 0]] = ord("N")
    substitute(sub2, pos[:, 0])
    substitute(sub2, pos[:, 1])
    random_rows = kinds == MIX.index("random")
    out[random_rows] = LETTERS[rng.integers(0, 4, size=(random_rows.sum(), length))]
    lengths = np.full(n, length)
    odd = np.flatnonzero(kinds == MIX.index("odd"))
    lower, short = odd[::2], odd[1::2]
    out[lower] += ord("a") - ord("A")
    lengths[short] = max(0, length - 6)
    return out, lengths, kinds


def as_bytes(ascii_rows: np.ndarray, lengths: np.ndarray):
    rows = ascii_rows.tobytes()
    width = ascii_rows.shape[1]
    return [rows[i * width : i * width + int(k)] for i, k in enumerate(lengths)]


def write_fastq_gz(path: Path, sequences, qualities) -> None:
    lines = []
    for i, (seq, qual) in enumerate(zip(sequences, qualities)):
        lines.append(b"@r%07d\n%s\n+\n%s\n" % (i, seq, qual))
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(b"".join(lines))


def write_u2(path: Path, rng, n: int, bgzf) -> list:
    """An unaligned BAM of ``n`` 98 bp reads; returns the record bodies."""
    nt16 = np.zeros(256, dtype=np.uint8)
    nt16[list(b"ACGT")] = (1, 2, 4, 8)
    seq = LETTERS[rng.integers(0, 4, size=(n, R2_LEN))]
    packed = (nt16[seq[:, 0::2]] << 4) | nt16[seq[:, 1::2]]
    qual = rng.integers(2, 41, size=(n, R2_LEN), dtype=np.uint8)
    packed_rows, qual_rows = packed.tobytes(), qual.tobytes()
    pw, qw = packed.shape[1], R2_LEN
    fixed = struct.Struct("<iiBBHHHiiii")
    bodies = []
    for i in range(n):
        name = b"r%07d\0" % i
        bodies.append(
            fixed.pack(-1, -1, len(name), 0, 4680, 0, 4, R2_LEN, -1, -1, 0)
            + name + packed_rows[i * pw : (i + 1) * pw] + qual_rows[i * qw : (i + 1) * qw]
        )
    text = b"@HD\tVN:1.6\tSO:unsorted\n@RG\tID:A\tSM:smoke\n"
    header = b"BAM\1" + struct.pack("<I", len(text)) + text + struct.pack("<I", 0)
    with bgzf.BgzfWriter(str(path)) as out:
        out.write(header)
        out.write(b"".join(struct.pack("<I", len(b)) + b for b in bodies))
    return bodies


# GRCh38's 25 primary sequences (1-22, X, Y, MT) and their lengths
GRCH38 = [
    ("1", 248956422), ("2", 242193529), ("3", 198295559), ("4", 190214555),
    ("5", 181538259), ("6", 170805979), ("7", 159345973), ("8", 145138636),
    ("9", 138394717), ("10", 133797422), ("11", 135086622), ("12", 133275309),
    ("13", 114364328), ("14", 107043718), ("15", 101991189), ("16", 90338345),
    ("17", 83257441), ("18", 80373285), ("19", 58617616), ("20", 64444167),
    ("21", 46709983), ("22", 50818468), ("X", 156040895), ("Y", 57227415), ("MT", 16569),
]
N_GENES, N_MITO_GENES, N_CELLS = 33_538, 37, 1_000  # Cell Ranger's GRCh38-2020-A gene count
METRICS_BATCH = 1 << 20  # the gatherer's DEFAULT_BATCH_RECORDS, never cut
CELL_CHUNKS = "cell_chunks"  # phase 5's cell BAM in cell-disjoint chunks, for phase 10 on
N_CELL_CHUNKS = 5
# depth, cut so that the phase's four decodes stay near four minutes on the
# card: each axis keeps one full 2^20-record batch, a cut remainder and the
# carried tail (three device passes)
CELL_RECORDS = 1_250_000
GENE_RECORDS = 1_150_000
XF_VALUES = (b"CODING", b"INTRONIC", b"UTR", b"INTERGENIC", b"")  # b"": no XF tag
XF_P = (0.6, 0.15, 0.1, 0.1, 0.05)


def gene_names() -> np.ndarray:
    """33,538 names of 10 bytes; the last 37 are MT- genes."""
    names = [b"GENE%06d" % i for i in range(N_GENES - N_MITO_GENES)]
    names += [b"MT-G%06d" % i for i in range(N_MITO_GENES)]
    return np.array(names, dtype="S10")


def make_reads(rng, n: int) -> dict:
    """Per-read columns of a synthetic 10x v2 library, in molecule order.

    About 2.4 reads a molecule over ~1,000 cells (lognormal sizes), genes
    Zipf-like over the vocabulary with 5% of molecules on MT- genes; 98 bp
    reads, ~5% unmapped, ~10% duplicates, ~10% spliced (49M1000N49M); XF
    over CODING/INTRONIC/UTR/INTERGENIC/missing with GE only on the first
    three; ~0.5% of GE tags name two genes; NH in {1, 1, 1, 2, 3}; CR = CB
    and UR = UB for 95% of reads.
    """
    cells = np.unique(LETTERS[rng.integers(0, 4, size=(N_CELLS + 64, CB_LEN))].view(f"S{CB_LEN}").ravel())
    cells = np.sort(rng.choice(cells, N_CELLS, replace=False))
    n_mol = int(n / 2.4 * 1.05)  # 2.4 reads a molecule on average; the surplus is cut
    sizes = rng.lognormal(0, 0.6, N_CELLS)
    mol_cell = rng.choice(N_CELLS, n_mol, p=sizes / sizes.sum())
    mol_umi = LETTERS[rng.integers(0, 4, size=(n_mol, UMI_LEN))]
    weights = 1.0 / (np.arange(N_GENES - N_MITO_GENES) + 10.0)
    mol_gene = rng.choice(N_GENES - N_MITO_GENES, n_mol, p=weights / weights.sum())
    mito = rng.random(n_mol) < 0.05
    mol_gene[mito] = N_GENES - N_MITO_GENES + rng.integers(0, N_MITO_GENES, mito.sum())
    mol_ref = np.where(mito, 24, mol_gene % 24)
    lengths = np.array([length for _, length in GRCH38])
    mol_pos = (rng.random(n_mol) * (lengths[mol_ref] - 2000)).astype(np.int64)
    per_mol = 1 + rng.poisson(1.4, n_mol)
    mol = np.repeat(np.arange(n_mol), per_mol)[:n]
    if mol.size < n:
        raise AssertionError("too few molecules for the record count")
    unmapped = rng.random(n) < 0.05
    xf = rng.choice(len(XF_VALUES), n, p=XF_P)
    xf[unmapped] = len(XF_VALUES) - 1
    names = gene_names()
    ge = names[mol_gene[mol]].astype("S21")
    multi = (rng.random(n) < 0.005) & (mol_gene[mol] < N_GENES - N_MITO_GENES - 1)
    ge[multi] = np.char.add(np.char.add(names[mol_gene[mol][multi]], b","), names[mol_gene[mol][multi] + 1])
    ge[xf >= 3] = b""
    cb = cells[mol_cell[mol]]
    cr = cb.view(np.uint8).reshape(n, CB_LEN).copy()
    bad = np.flatnonzero(rng.random(n) < 0.05)
    cr[bad, rng.integers(0, CB_LEN, bad.size)] = ord("N")
    ub = mol_umi[mol]
    ur = ub.copy()
    bad = np.flatnonzero(rng.random(n) < 0.05)
    ur[bad, rng.integers(0, UMI_LEN, bad.size)] = ord("N")
    return dict(
        cell=mol_cell[mol], cb=cb.view(np.uint8).reshape(n, CB_LEN), cr=cr, ub=ub, ur=ur,
        ge=ge, xf=xf, unmapped=unmapped,
        ref=np.where(unmapped, -1, mol_ref[mol]),
        pos=np.where(unmapped, -1, mol_pos[mol] + rng.integers(0, 6, n)),
        reverse=rng.random(n) < 0.5, duplicate=(rng.random(n) < 0.1) & ~unmapped,
        spliced=(rng.random(n) < 0.1) & ~unmapped,
        nh=np.where(unmapped, 0, rng.choice([1, 1, 1, 2, 3], n)),
    )


def sort_reads(reads: dict, order: str) -> dict:
    """The reads sorted by (CB, UB, GE) for ``order="cell"``, else by
    (GE, CB, UB); ties keep their order. A missing GE sorts first."""
    _, ge_code = np.unique(reads["ge"], return_inverse=True)
    umi = (np.searchsorted(LETTERS, reads["ub"]).astype(np.int64) * (4 ** np.arange(UMI_LEN - 1, -1, -1))).sum(1)
    keys = (ge_code, umi, reads["cell"]) if order == "cell" else (umi, reads["cell"], ge_code)
    perm = np.lexsort(keys)
    return {name: column[perm] for name, column in reads.items()}


def _u8(values, dtype) -> np.ndarray:
    return np.ascontiguousarray(values.astype(dtype)).view(np.uint8).reshape(len(values), np.dtype(dtype).itemsize)


def _z_tag(key: bytes, values: np.ndarray) -> np.ndarray:
    head = np.frombuffer(key + b"Z", dtype=np.uint8)
    n = len(values)
    return np.concatenate(
        [np.broadcast_to(head, (n, 3)), values, np.zeros((n, 1), np.uint8)], axis=1
    )


def write_tagged_bam(path: Path, rng, reads: dict, bgzf, slices=()) -> None:
    """The reads as raw BAM records (tags [CB] CR CY [UB] UR UY [GE] [XF]
    [NH]), built with numpy one layout group at a time, BGZF level 1.
    Optional columns: ``qname`` (the number in each record's name; by
    default its position) and ``has_cb`` / ``has_ub`` (False leaves out the
    CB / UB tag). Each ``(path, first, end)`` of ``slices`` is written too:
    the header and the same records' bytes from ``first`` to ``end``."""
    n = len(reads["cell"])
    qname = reads.get("qname", np.arange(n))
    has_cb = reads.get("has_cb", np.ones(n, dtype=bool))
    has_ub = reads.get("has_ub", np.ones(n, dtype=bool))
    qual_q = rng.integers(2, 42, size=(n, R2_LEN), dtype=np.uint8)
    seq = LETTERS[rng.integers(0, 4, size=(n, R2_LEN))]
    nt16 = np.zeros(256, dtype=np.uint8)
    nt16[list(b"ACGT")] = (1, 2, 4, 8)
    packed = (nt16[seq[:, 0::2]] << 4) | nt16[seq[:, 1::2]]
    ge_len = np.char.str_len(reads["ge"])
    xf_len = np.array([len(v) for v in XF_VALUES])[reads["xf"]]
    n_cigar = np.where(reads["unmapped"], 0, np.where(reads["spliced"], 3, 1))
    flag = (np.where(reads["unmapped"], 4, 0) | np.where(reads["reverse"], 16, 0)
            | np.where(reads["duplicate"], 1024, 0))
    # one layout group a mixed-radix key (GE values stay under 64 bytes)
    key = ((((n_cigar * 64 + ge_len) * 8 + reads["xf"]) * 2 + (reads["nh"] > 0)) * 2 + has_cb) * 2 + has_ub
    groups, group_of = np.unique(key, return_inverse=True)
    sizes = np.empty(n, dtype=np.int64)
    blocks = []
    for g, code in enumerate(groups):
        code, ub_on = divmod(int(code), 2)
        code, cb_on = divmod(code, 2)
        code, has_nh = divmod(code, 2)
        code, xf_code = divmod(code, 8)
        cig, glen = divmod(code, 64)
        idx = np.flatnonzero(group_of.ravel() == g)
        m = idx.size
        cigar = {0: [], 1: [R2_LEN << 4], 3: [49 << 4, (1000 << 4) | 3, 49 << 4]}[int(cig)]
        parts = [
            None,  # block_size, filled in below
            _u8(reads["ref"][idx], "<i4"), _u8(reads["pos"][idx], "<i4"),
            np.broadcast_to(np.array([11, 0 if cig == 0 else 255], np.uint8), (m, 2)),
            np.zeros((m, 2), np.uint8), np.broadcast_to(_u8(np.array([cig]), "<u2")[0], (m, 2)),
            _u8(flag[idx], "<u2"), np.broadcast_to(_u8(np.array([R2_LEN]), "<i4")[0], (m, 4)),
            np.broadcast_to(_u8(np.array([-1, -1, 0]), "<i4").ravel(), (m, 12)),
            np.frombuffer(b"".join(b"r%09d\0" % i for i in qname[idx]), np.uint8).reshape(m, 11),
            np.broadcast_to(_u8(np.array(cigar, np.uint32), "<u4").ravel(), (m, 4 * int(cig))),
            packed[idx], qual_q[idx],
            _z_tag(b"CB", reads["cb"][idx]) if cb_on else None, _z_tag(b"CR", reads["cr"][idx]),
            _z_tag(b"CY", qual_q[idx, :CB_LEN] + 33),
            _z_tag(b"UB", reads["ub"][idx]) if ub_on else None, _z_tag(b"UR", reads["ur"][idx]),
            _z_tag(b"UY", qual_q[idx, CB_LEN : CB_LEN + UMI_LEN] + 33),
        ]
        parts = parts[:1] + [part for part in parts[1:] if part is not None]
        if glen:
            parts.append(_z_tag(b"GE", reads["ge"][idx].astype(f"S{glen}").view(np.uint8).reshape(m, glen)))
        if XF_VALUES[xf_code]:
            parts.append(_z_tag(b"XF", np.broadcast_to(np.frombuffer(XF_VALUES[xf_code], np.uint8), (m, len(XF_VALUES[xf_code])))))
        if has_nh:
            parts.append(np.concatenate([np.broadcast_to(np.frombuffer(b"NHC", np.uint8), (m, 3)),
                                         reads["nh"][idx].astype(np.uint8)[:, None]], axis=1))
        width = sum(p.shape[1] for p in parts[1:])
        parts[0] = np.broadcast_to(_u8(np.array([width]), "<i4")[0], (m, 4))
        sizes[idx] = width + 4
        blocks.append((idx, np.concatenate(parts, axis=1)))
    # the records in their order: each group's rows scattered to their offsets
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    body = np.empty(offsets[-1], dtype=np.uint8)
    for idx, block in blocks:
        for lo in range(0, idx.size, 1 << 15):
            rows = idx[lo : lo + (1 << 15)]
            body[offsets[rows][:, None] + np.arange(block.shape[1])] = block[lo : lo + (1 << 15)]
    text = b"@HD\tVN:1.6\tSO:unsorted\n" + b"".join(b"@SQ\tSN:%s\tLN:%d\n" % (name.encode(), length) for name, length in GRCH38)
    header = b"BAM\1" + struct.pack("<I", len(text)) + text + struct.pack("<I", len(GRCH38))
    for name, length in GRCH38:
        header += struct.pack("<I", len(name) + 1) + name.encode() + b"\0" + struct.pack("<I", length)
    write_bgzf(path, header + body.tobytes(), bgzf)
    for part, first, end in slices:
        write_bgzf(part, header + body[offsets[first] : offsets[end]].tobytes(), bgzf)


def cell_ranges(cells: np.ndarray, n_parts: int) -> list:
    """``n_parts`` (first, end) record ranges of a cell-sorted column, of
    near-equal size, each cut at a cell boundary."""
    starts = np.flatnonzero(np.r_[True, cells[1:] != cells[:-1]])
    cuts = [0] + [int(starts[np.searchsorted(starts, len(cells) * i // n_parts)]) for i in range(1, n_parts)]
    return list(zip(cuts, cuts[1:] + [len(cells)]))


def write_bgzf(path: Path, data: bytes, bgzf) -> None:
    """``data`` as the BGZF file ``bgzf.BgzfWriter(level=1)`` writes, byte
    for byte: the same 64 KiB blocks, compressed on a pool of threads (zlib
    releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    step = bgzf.MAX_BLOCK_PAYLOAD
    chunks = [data[i : i + step] for i in range(0, len(data), step)]
    with ThreadPoolExecutor(max_workers=8) as pool, open(path, "wb") as out:
        for block in pool.map(lambda chunk: bgzf.compress_block(chunk, 1), chunks):
            out.write(block)
        out.write(bgzf.BGZF_EOF)


def write_mito_gtf(path: Path) -> None:
    """A GTF declaring the 37 MT- genes (gene_id = gene_name, as in the BAM's
    GE tags) and a few others."""
    names = gene_names()
    lines = ["#!genome-build synthetic\n"]
    for i, name in enumerate(list(names[:50]) + list(names[-N_MITO_GENES:])):
        chrom = "MT" if name.startswith(b"MT-") else "1"
        lines.append(f'{chrom}\tsmoke\tgene\t{100 * i + 1}\t{100 * i + 90}\t.\t+\t.\t'
                     f'gene_id "{name.decode()}"; gene_name "{name.decode()}";\n')
    path.write_text("".join(lines))


def expected_cell_counts(reads: dict) -> dict:
    """Per cell barcode, (n_reads, n_molecules, n_genes,
    n_mitochondrial_molecules) counted from the generator's columns: a
    molecule is a distinct (CB, UB, GE), a gene a distinct GE (a missing GE
    included), mitochondrial molecules the reads on an MT- gene."""
    cell = reads["cell"]
    _, ge_code = np.unique(reads["ge"], return_inverse=True)
    umi = (np.searchsorted(LETTERS, reads["ub"]).astype(np.int64) * (4 ** np.arange(UMI_LEN - 1, -1, -1))).sum(1)
    molecule = np.unique(np.stack([cell, umi, ge_code], axis=1), axis=0)[:, 0]
    gene = np.unique(np.stack([cell, ge_code], axis=1), axis=0)[:, 0]
    mito = np.char.startswith(reads["ge"], b"MT-")
    counts = np.stack([
        np.bincount(cell, minlength=N_CELLS), np.bincount(molecule, minlength=N_CELLS),
        np.bincount(gene, minlength=N_CELLS), np.bincount(cell, weights=mito, minlength=N_CELLS),
    ], axis=1).astype(np.int64)
    first = np.zeros(N_CELLS, np.int64)
    first[cell] = np.arange(len(cell))
    return {reads["cb"][first[c]].tobytes().decode(): tuple(counts[c]) for c in np.unique(cell)}


# ---------------------------------------------------------------- phases


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    log(nvidia_smi("name,power.limit"))
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(
        f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"{props.multi_processor_count} SMs, max SM clock {clock_mhz:.0f} MHz, "
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}"
    )
    # the plain version runs on the card here: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return props.multi_processor_count, clock_mhz * 1e6


def toolchain_probe() -> str:
    """The host toolchain the native layer builds with: g++'s version, which
    of zlib.h and libdeflate.h its preprocessor finds, the libz and
    libdeflate the linker's cache lists, and the cores."""
    def run(*command, stdin=""):
        result = subprocess.run(command, input=stdin, capture_output=True, text=True)
        return result.returncode, result.stdout

    found = [header for header in ("zlib.h", "libdeflate.h")
             if run("g++", "-E", "-x", "c++", "-", stdin=f"#include <{header}>\n")[0] == 0]
    libraries = [line.split()[0] for line in run("ldconfig", "-p")[1].splitlines()
                 if line.strip().startswith(("libz.so", "libdeflate"))]
    return (f"{run('g++', '--version')[1].splitlines()[0]}; headers found: {', '.join(found) or 'none'}; "
            f"libraries: {', '.join(libraries) or 'none'}; nproc {run('nproc')[1].strip()}")


def phase_build(kernels, native):
    """nvcc for each kernel and g++ for the native layer, all at once."""
    import threading

    log(f"[build] toolchain: {toolchain_probe()}")
    start = time.perf_counter()
    native_seconds, native_error = [], []

    def build_native():
        try:
            native.library()
            native_seconds.append(time.perf_counter() - start)
        except BaseException as error:  # re-raised below, on the main thread
            native_error.append(error)

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    for name in kernels.launches:
        kernels.library(name)
    seconds = time.perf_counter() - start
    native_thread.join()
    if native_error:
        raise native_error[0]
    for name, output in kernels.build_output.items():
        for line in output.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(kernels.launches)} kernel(s) built and loaded in {seconds:.2f} s; the native "
        f"layer ({', '.join(native.SOURCES)}, {' '.join(native.CXX_FLAGS + native.LINK_FLAGS)}) in "
        f"{native_seconds[0]:.2f} s as {native.library_path().name}; native threads "
        f"{native.default_threads()} (decoder), {native.pool_threads()} (FASTQ loops' BGZF pool)")


def kernel_bound_ms(n_q: int, n_w: int, length: int):
    """The least time the card could take for one batch: (ms, "operations" or "bytes").

    Counted from the function: the TPU kernel's one-hot score product,
    [n_q, 4L] x [4L, n_w], whose 0/1 values are exact in int8, at the
    published int8 tensor-core peak (two operations per multiply-add); the
    threshold and the max run beside it and are not counted. Bytes: the
    query codes and the int8 one-hot whitelist table read once, the int32
    indices written once.
    """
    ops_s = 2.0 * n_q * n_w * 4 * length / INT8_TENSOR_OPS_PER_S
    kpad = 32 * -(-4 * length // 32)
    bytes_s = (n_q * length + n_w * kpad + n_q * 4) / HBM_BYTES_PER_S
    return (ops_s * 1e3, "operations") if ops_s >= bytes_s else (bytes_s * 1e3, "bytes")


def int32_issue_floor_ms(n_q: int, n_w: int, length: int, sms: int, clock_hz: float) -> float:
    """The floor of the kernel's first, popc design: its instruction mix at issue rate.

    That design (2-bit packed barcodes on the CUDA cores) spent, per pair and
    per 16-base word, an xor, a shift and two 3-input logic ops (LOP3) on the
    mismatch mask and one POPC to count it; per pair a compare and a select
    kept the best index, and an add per extra word summed the counts. INT32
    ops issue at 64 and POPC at 16 per clock per SM. Kept as the line the
    tensor-core kernel has to come in under, on the same card in the same
    run; not the function's bound.
    """
    words = -(-length // 16)
    pairs = float(n_q) * n_w
    alu = pairs * (4 * words + 2 + (words - 1))
    popc = pairs * words
    seconds = max(alu / INT32_OPS_PER_CLOCK_PER_SM, popc / POPC_PER_CLOCK_PER_SM) / (sms * clock_hz)
    return seconds * 1e3


def check_exact(name: str, got, expected) -> None:
    got, expected = got.cpu().numpy(), expected.cpu().numpy()
    if got.shape != expected.shape or not np.array_equal(got, expected):
        bad = np.flatnonzero(got != expected)[:5]
        raise AssertionError(
            f"{name}: kernel != plain at {bad.tolist()}: "
            f"{got[bad].tolist()} vs {expected[bad].tolist()}"
        )


def edge_case(wl_ops, device, wl_ascii, q_ascii, q_len):
    """(kernel, plain) indices for an ASCII whitelist and ASCII queries."""
    import torch

    length = wl_ascii.shape[1]
    table = wl_ops.make_table(to_card(wl_ops.barcode_codes(
        as_bytes(wl_ascii, np.full(len(wl_ascii), length)), length), device))
    q = to_card(wl_ops.barcode_codes(as_bytes(q_ascii, q_len), length), device)
    got, plain = wl_ops.correct_codes(q, table), wl_ops.correct_plain(q, table)
    torch.cuda.synchronize()
    return got, plain


def phase_kernel(rng, whitelist_ascii, sms, clock_hz, wl_ops):
    import torch

    device = torch.device("cuda")
    table = wl_ops.make_table(
        to_card(wl_ops.barcode_codes(as_bytes(whitelist_ascii, np.full(len(whitelist_ascii), CB_LEN)), CB_LEN), device)
    )
    q_ascii, q_len, _ = make_queries(rng, whitelist_ascii, BATCH)
    queries = to_card(wl_ops.barcode_codes(as_bytes(q_ascii, q_len), CB_LEN), device)

    got = wl_ops.correct_codes(queries, table)
    plain = wl_ops.correct_plain(queries, table)
    torch.cuda.synchronize()
    check_exact("10x v2 batch", got, plain)
    max_abs_err = int((got.long() - plain.long()).abs().max().item())
    hits = int((plain >= 0).sum().item())
    log(f"[kernel] {BATCH} x {table.codes.shape[0]} x L={CB_LEN}: exact "
        f"({hits} hits, max_abs_err {max_abs_err})")

    # edge cases: L = 1 to 64 across every Kpad step, duplicates, N in the
    # whitelist, ragged sizes, n_q = 1 and 129
    edge_rng = np.random.default_rng(7)
    edges = ((1, 5, 3001), (14, 5003, 3001), (16, 2049, 257), (17, 1025, 999), (24, 1000, 300),
             (32, 1000, 300), (33, 777, 555), (49, 1031, 611), (64, 1537, 700), (16, 3000, 1),
             (16, 3000, 129))
    for length, n_w, n_q in edges:
        wl = make_whitelist(edge_rng, n_w, length)
        wl[3, 0] = ord("N")
        wl[-1] = wl[1]  # duplicate: the last copy wins
        qa, ql, _ = make_queries(edge_rng, wl, n_q)
        head = min(4, n_q)
        qa[:head], ql[:head] = wl[[1, 3, -1, 0][:head]], length
        got_e, plain_e = edge_case(wl_ops, device, wl, qa, ql)
        check_exact(f"edge L={length} n_w={n_w} n_q={n_q}", got_e, plain_e)
        if length > 1 and got_e[0].item() != n_w - 1:
            raise AssertionError(f"duplicate entry: got {got_e[0].item()}, want the last ({n_w - 1})")
    # the only reachable entry in the kernel's last, partial 512-row slice
    for length in (1, 16, 64):
        n_w = 2 * 512 + 77
        wl = np.full((n_w, length), ord("N"), dtype=np.uint8)
        wl[-1] = make_whitelist(edge_rng, 1, length)[0]
        qa, ql, _ = make_queries(edge_rng, wl[-1:], 300)
        got_e, plain_e = edge_case(wl_ops, device, wl, qa, ql)
        check_exact(f"last-slice hit L={length}", got_e, plain_e)
        if not bool((got_e[ql == length] == n_w - 1).any()):
            raise AssertionError(f"last-slice hit L={length}: no query found entry {n_w - 1}")
    log(f"[kernel] edge cases exact: L={', '.join(str(e[0]) for e in edges[:9])}; duplicates; "
        "N in whitelist; ragged n_q/n_w; n_q = 1 and 129; the only hit in the last partial slice")

    ms = cuda_ms(lambda: wl_ops.correct_codes(queries, table), repeats=15)
    plain_ms = cuda_ms(lambda: wl_ops.correct_plain(queries, table), repeats=3, warmup=1)
    # yardsticks only, never called by the port: the one-hot score product
    # alone, chunked like the plain version (the full [65,536 x 737,280]
    # score matrix would be 193 GB), by cuBLAS in float32 and by
    # torch._int_mm on the int8 one-hot tables (the tensor cores' own rate
    # on this shape)
    chunk = wl_ops.PLAIN_CHUNK

    def score_product(q_onehot, w_onehot, matmul, dtype):
        scores = torch.empty(BATCH * chunk, dtype=dtype, device=device)

        def run():
            for start in range(0, w_onehot.shape[0], chunk):
                w = w_onehot[start : start + chunk]
                matmul(q_onehot, w.T, out=scores[: BATCH * w.shape[0]].view(BATCH, -1))

        return run

    library_ms = cuda_ms(score_product(wl_ops.onehot_codes(queries), wl_ops.onehot_codes(table.codes),
                                       torch.matmul, torch.float32), repeats=3, warmup=1)
    library_int8_ms = cuda_ms(score_product(wl_ops.onehot_int8(queries), table.onehot,
                                            torch._int_mm, torch.int32), repeats=3, warmup=1)
    torch.cuda.empty_cache()
    n_w = table.codes.shape[0]
    bound_ms, bound_by = kernel_bound_ms(BATCH, n_w, CB_LEN)
    floor_ms = int32_issue_floor_ms(BATCH, n_w, CB_LEN, sms, clock_hz)
    log(f"[kernel] per {BATCH}-query batch: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: int8 tensor-core one-hot product at the "
        f"published peak, {bound_ms / ms:.0%} of it reached), the first (popc) design's INT32 issue "
        f"floor {floor_ms:.3f} ms (kernel {'under' if ms < floor_ms else 'NOT under'} it), "
        f"score product only: cuBLAS float32 {library_ms:.3f} ms, torch._int_mm int8 "
        f"{library_int8_ms:.3f} ms")
    if ms >= floor_ms:
        raise AssertionError(f"kernel {ms:.3f} ms is not under the popc design's INT32 issue "
                             f"floor {floor_ms:.3f} ms")
    return table, dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                       library_int8_ms=library_int8_ms, int32_issue_floor_ms=floor_ms)


def parse_z_tags(tail: bytes):
    tags = []
    for field in tail.split(b"\0")[:-1]:
        if field[2:3] != b"Z":
            raise AssertionError(f"unexpected tag {field[:3]!r}")
        tags.append((field[:2].decode(), field[3:]))
    return tags


def check_calls(native, what: str, **want) -> None:
    """``native.calls`` must hold ``want`` (a count, or None for at least
    one call) and 0 for every other route."""
    got = dict(native.calls)
    for name, count in want.items():
        calls = got.pop(name)
        if calls < 1 if count is None else calls != count:
            raise AssertionError(f"{what} did not take the native route: {native.calls}")
    if any(got.values()):
        raise AssertionError(f"{what} took another native route too: {native.calls}")


def write_attach_inputs(rng, whitelist_ascii, n_reads: int, bgzf, directory: Path):
    """Attach's inputs in ``directory``: the whitelist, ``n_reads`` synthetic
    10x v2 R1 and I1 reads (gz FASTQ) and a u2 BAM. Returns the R1 and I1
    sequences and qualities and the u2 record bodies."""
    newline = np.full((whitelist_ascii.shape[0], 1), ord("\n"), dtype=np.uint8)
    (directory / "whitelist.txt").write_bytes(np.concatenate([whitelist_ascii, newline], axis=1).tobytes())
    cb_ascii, cb_len, _ = make_queries(rng, whitelist_ascii, n_reads)
    tail = LETTERS[rng.integers(0, 4, size=(n_reads, R1_LEN - CB_LEN))]
    r1_ascii = np.concatenate([cb_ascii, tail], axis=1)
    r1_len = np.where(cb_len < CB_LEN, cb_len, R1_LEN)  # a short barcode is a short read
    r1_seq = as_bytes(r1_ascii, r1_len)
    r1_qual = as_bytes(rng.integers(35, 75, size=(n_reads, R1_LEN), dtype=np.uint8), r1_len)
    i1_seq = as_bytes(LETTERS[rng.integers(0, 4, size=(n_reads, SAMPLE_LEN))], np.full(n_reads, SAMPLE_LEN))
    i1_qual = as_bytes(rng.integers(35, 75, size=(n_reads, SAMPLE_LEN), dtype=np.uint8), np.full(n_reads, SAMPLE_LEN))
    write_fastq_gz(directory / "r1.fastq.gz", r1_seq, r1_qual)
    write_fastq_gz(directory / "i1.fastq.gz", i1_seq, i1_qual)
    u2_bodies = write_u2(directory / "u2.bam", rng, n_reads, bgzf)
    return r1_seq, r1_qual, i1_seq, i1_qual, u2_bodies


def attach_args(directory: Path, output: Path) -> list:
    """``Attach10xBarcodes -w`` over ``write_attach_inputs``' files."""
    return ["--r1", str(directory / "r1.fastq.gz"), "--u2", str(directory / "u2.bam"),
            "--i1", str(directory / "i1.fastq.gz"), "-o", str(output), "-w", str(directory / "whitelist.txt")]


def phase_attach(rng, whitelist_ascii, n_reads, table, kernel_ms, stamp: str, modules):
    import torch

    kernels, native, wl_ops, port_platform, port_bam, port_fastq, bgzf, sam = modules
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    start = time.perf_counter()
    r1_seq, r1_qual, i1_seq, i1_qual, u2_bodies = write_attach_inputs(rng, whitelist_ascii, n_reads, bgzf, WORK)
    log(f"[attach] inputs: {n_reads} reads (R1 {R1_LEN} bp gz, I1 {SAMPLE_LEN} bp gz, "
        f"u2 {R2_LEN} bp BAM), whitelist {whitelist_ascii.shape[0]} x {CB_LEN}, "
        f"made in {time.perf_counter() - start:.1f} s")

    output = WORK / "tagged.bam"
    args = attach_args(WORK, output)
    stderr = io.StringIO()
    torch.cuda.synchronize()
    native.reset_calls()
    kernels.reset_launches()  # the main path's run starts here
    start = time.perf_counter()
    with contextlib.redirect_stderr(stderr):
        rc = port_platform.TenXV2.attach_barcodes(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(kernels.launches)  # ... and ends here
    if rc != 0:
        raise AssertionError(f"attach returned {rc}")
    check_calls(native, "attach", attach=1)
    batches = -(-n_reads // BATCH)
    if launches["whitelist_correct"] != batches:
        raise AssertionError(f"{launches['whitelist_correct']} kernel launches, want {batches}")
    summary = stderr.getvalue()
    log(f"[attach] {stamp} | {n_reads} reads in {seconds:.2f} s = {n_reads / seconds:.0f} reads/s "
        f"(native loop, BGZF pool of {native.pool_threads()} threads), {batches} batches, "
        f"{launches['whitelist_correct']} kernel launches")
    for line in summary.strip().splitlines():
        log(f"[attach] {line.strip()}")

    # expected CB: the plain version, beside the table, for every CR
    cr = [s[:CB_LEN] for s in r1_seq]
    expected = []
    for lo in range(0, n_reads, BATCH):
        q = to_card(wl_ops.barcode_codes(cr[lo : lo + BATCH], CB_LEN), table.codes.device)
        expected.append(wl_ops.correct_plain(q, table).cpu().numpy())
    expected = np.concatenate(expected)
    expected[np.array([len(c) for c in cr]) != CB_LEN] = -1
    whitelist_rows = whitelist_ascii.tobytes()

    counts = {"correct": 0, "corrected": 0, "uncorrectible": 0}
    with bgzf.open_bgzf_reader(str(output)) as fh:
        if sam.read_raw_header(fh)[:4] != b"BAM\1":
            raise AssertionError("output is not a BAM")
        n_out = 0
        for i, body in enumerate(sam.iter_raw_records(fh)):
            n_out += 1
            u2 = u2_bodies[i]
            if body[: len(u2)] != u2:
                raise AssertionError(f"record {i}: u2 bytes changed")
            tags = parse_z_tags(body[len(u2):])
            want = [("CR", cr[i]), ("CY", r1_qual[i][:CB_LEN])]
            if expected[i] >= 0:
                cb = whitelist_rows[expected[i] * CB_LEN : (expected[i] + 1) * CB_LEN]
                want.append(("CB", cb))
                counts["correct" if cb == cr[i] else "corrected"] += 1
            else:
                counts["uncorrectible"] += 1
            want += [("UR", r1_seq[i][CB_LEN : CB_LEN + UMI_LEN]),
                     ("UY", r1_qual[i][CB_LEN : CB_LEN + UMI_LEN]),
                     ("SR", i1_seq[i]), ("SY", i1_qual[i])]
            if tags != want:
                raise AssertionError(f"record {i}: tags {tags} != {want}")
    if n_out != n_reads:
        raise AssertionError(f"{n_out} records written, want {n_reads}")
    want_summary = (
        f"Total barcodes:{n_reads}\n correct:{counts['correct']}\n"
        f"corrected:{counts['corrected']}\nuncorrectible:{counts['uncorrectible']}\n"
        f"uncorrected:{counts['uncorrectible'] / n_reads * 100.0:f}\n"
    )
    if summary != want_summary:
        raise AssertionError(f"summary {summary!r} != {want_summary!r}")
    log(f"[attach] all {n_out} records checked: CR/CY/UR/UY/SR/SY slices and every CB "
        f"against the plain version ({counts})")

    # the same run without -w (no whitelist load, no kernel, no CB): what
    # correction adds to the command's time
    native.reset_calls()
    start = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        port_platform.TenXV2.attach_barcodes(args[:-2])
    plain_seconds = time.perf_counter() - start
    check_calls(native, "attach without -w", attach=1)
    log(f"[attach] without -w: {n_reads} reads in {plain_seconds:.2f} s = "
        f"{n_reads / plain_seconds:.0f} reads/s; correction adds "
        f"{seconds - plain_seconds:.2f} s, of which the kernel "
        f"~{launches['whitelist_correct'] * kernel_ms / 1e3:.3f} s (launches x kernel ms)")
    start = time.perf_counter()
    launches["whitelist_correct"] += library_leg(
        rng, stamp, (kernels, native, port_platform, port_bam, port_fastq, bgzf, sam))
    log(f"[attach] library leg took {time.perf_counter() - start:.1f} s")
    shutil.rmtree(WORK)
    return launches


# the library leg: JAX's generator builds a hash map of 5 x L x |whitelist|
# entries (sctools_tpu/barcode.py), ~6.5 M at 100,000 barcodes against
# ~48 M at 737,280, so its whitelist is cut to 100,000
LIBRARY_WHITELIST = 100_000
LIBRARY_READS = BATCH  # one kernel batch
LIBRARY_R1_LEN = CB_LEN + UMI_LEN
LIBRARY_MIX_P = (0.85, 0.08, 0.07)  # exact, one substitution, random
LIBRARY_AMBIGUOUS = 64
BIN_FIELD = 10  # the offset of a record body's bin (after refID, pos, l_read_name, mapq)


def write_library_inputs(rng, bgzf, directory: Path):
    """The library leg's inputs in ``directory``: a whitelist whose last
    ``LIBRARY_AMBIGUOUS`` barcodes each lie at distance 2 from an earlier
    one, 10x v2 R1 and I1 reads (gz FASTQ) in the ``LIBRARY_MIX_P`` mix with
    one read a pair planted at distance 1 from both of its barcodes, and a
    u2 BAM. Returns the planted reads' indices, the barcode each must
    correct to (the later one, as the kernel's largest index and the hash
    map's last writer both give) and the u2 records' lengths."""
    whitelist = make_whitelist(rng, LIBRARY_WHITELIST, CB_LEN)
    n_amb = LIBRARY_AMBIGUOUS
    first = np.arange(n_amb)
    second = LIBRARY_WHITELIST - n_amb + first
    pos = np.stack([rng.choice(CB_LEN, size=2, replace=False) for _ in range(n_amb)])
    moved = whitelist[first].copy()
    for k in range(2):
        codes = np.searchsorted(LETTERS, moved[np.arange(n_amb), pos[:, k]])
        moved[np.arange(n_amb), pos[:, k]] = LETTERS[(codes + rng.integers(1, 4, size=n_amb)) % 4]
    whitelist[second] = moved
    queries = whitelist[first].copy()
    queries[np.arange(n_amb), pos[:, 0]] = moved[np.arange(n_amb), pos[:, 0]]
    newline = np.full((LIBRARY_WHITELIST, 1), ord("\n"), dtype=np.uint8)
    (directory / "whitelist.txt").write_bytes(np.concatenate([whitelist, newline], axis=1).tobytes())

    n = LIBRARY_READS
    kinds = rng.choice(len(LIBRARY_MIX_P), size=n, p=LIBRARY_MIX_P)
    cells = whitelist[rng.integers(0, LIBRARY_WHITELIST, size=n)]
    sub = np.flatnonzero(kinds == 1)
    at = rng.integers(0, CB_LEN, size=sub.size)
    codes = np.searchsorted(LETTERS, cells[sub, at])
    cells[sub, at] = LETTERS[(codes + rng.integers(1, 4, size=sub.size)) % 4]
    random_rows = np.flatnonzero(kinds == 2)
    cells[random_rows] = LETTERS[rng.integers(0, 4, size=(random_rows.size, CB_LEN))]
    planted = rng.choice(n, size=n_amb, replace=False)
    cells[planted] = queries
    r1 = np.concatenate([cells, LETTERS[rng.integers(0, 4, size=(n, UMI_LEN))]], axis=1)
    full = np.full(n, LIBRARY_R1_LEN)
    write_fastq_gz(directory / "r1.fastq.gz", as_bytes(r1, full),
                   as_bytes(rng.integers(35, 75, size=(n, LIBRARY_R1_LEN), dtype=np.uint8), full))
    sample = np.full(n, SAMPLE_LEN)
    write_fastq_gz(directory / "i1.fastq.gz", as_bytes(LETTERS[rng.integers(0, 4, size=(n, SAMPLE_LEN))], sample),
                   as_bytes(rng.integers(35, 75, size=(n, SAMPLE_LEN), dtype=np.uint8), sample))
    u2_lengths = [len(body) for body in write_u2(directory / "u2.bam", rng, n, bgzf)]
    return planted, [row.tobytes() for row in moved], u2_lengths


def route_counts(bodies, u2_lengths, planted, want) -> dict:
    """exact / corrected / uncorrectable reads of one route's BAM, and the
    planted ambiguous reads corrected to the barcode they must take."""
    counts = {"exact": 0, "corrected": 0, "ambiguous": 0, "uncorrectable": 0}
    cb_of = {}
    for i, body in enumerate(bodies):
        tags = dict(parse_z_tags(body[u2_lengths[i]:]))
        cb = tags.get("CB")
        cb_of[i] = cb
        counts["uncorrectable" if cb is None else "exact" if cb == tags["CR"] else "corrected"] += 1
    counts["ambiguous"] = sum(cb_of[int(i)] == barcode for i, barcode in zip(planted, want))
    return counts


def library_leg(rng, stamp: str, modules) -> int:
    """Phase 4's library leg: ``bam.Tagger`` over the library's generators
    against ``TenXV2.attach_barcodes -w --i1`` on the same inputs, record
    for record. Returns the attach's kernel launches."""
    import torch

    kernels, native, port_platform, port_bam, port_fastq, bgzf, sam = modules
    directory = WORK / "library"
    directory.mkdir()
    start = time.perf_counter()
    planted, want, u2_lengths = write_library_inputs(rng, bgzf, directory)
    log(f"[attach] library leg inputs: {LIBRARY_READS} reads (R1 {LIBRARY_R1_LEN} bp gz, I1 {SAMPLE_LEN} bp gz), "
        f"whitelist {LIBRARY_WHITELIST} x {CB_LEN} with {LIBRARY_AMBIGUOUS} ambiguous reads planted, made in "
        f"{time.perf_counter() - start:.1f} s")

    attached, tagged = directory / "attach.bam", directory / "tagger.bam"
    torch.cuda.synchronize()
    native.reset_calls()
    kernels.reset_launches()
    start = time.perf_counter()
    summary_out = io.StringIO()
    with contextlib.redirect_stderr(summary_out):
        rc = port_platform.TenXV2.attach_barcodes(attach_args(directory, attached))
    torch.cuda.synchronize()
    attach_seconds = time.perf_counter() - start
    launches = dict(kernels.launches)
    if rc != 0:
        raise AssertionError(f"library leg: attach returned {rc}")
    check_calls(native, "library leg attach", attach=1)
    batches = -(-LIBRARY_READS // BATCH)
    if launches != {"whitelist_correct": batches}:
        raise AssertionError(f"library leg: attach launched {launches}, want {batches} (one a batch)")
    summary = dict(re.findall(r"(\w+):(\d+)\n", summary_out.getvalue()))

    native.reset_calls()
    kernels.reset_launches()
    embedded = port_fastq.EmbeddedBarcode
    start = time.perf_counter()
    cells = port_fastq.BarcodeGeneratorWithCorrectedCellBarcodes(
        str(directory / "r1.fastq.gz"), embedded(0, CB_LEN, "CR", "CY"), str(directory / "whitelist.txt"),
        [embedded(CB_LEN, CB_LEN + UMI_LEN, "UR", "UY")])
    map_seconds = time.perf_counter() - start
    samples = port_fastq.EmbeddedBarcodeGenerator(str(directory / "i1.fastq.gz"),
                                                  [embedded(0, SAMPLE_LEN, "SR", "SY")])
    start = time.perf_counter()
    port_bam.Tagger(str(directory / "u2.bam")).tag(str(tagged), [cells, samples])
    tag_seconds = time.perf_counter() - start
    if any(kernels.launches.values()) or any(native.calls.values()):
        raise AssertionError(f"library leg: the library route launched {dict(kernels.launches)}, "
                             f"native calls {dict(native.calls)}")

    routes = {}
    for name, path in (("attach", attached), ("library", tagged)):
        with bgzf.open_bgzf_reader(str(path)) as fh:
            sam.read_raw_header(fh)
            routes[name] = list(sam.iter_raw_records(fh))
    if len(routes["attach"]) != LIBRARY_READS or len(routes["library"]) != LIBRARY_READS:
        raise AssertionError(f"library leg: {len(routes['attach'])} and {len(routes['library'])} records, "
                             f"want {LIBRARY_READS}")
    # the record encoder writes bin 0 for an unplaced read, as JAX's does;
    # the attach copies the u2's bytes, bin 4680 included
    differ = [i for i, (a, b) in enumerate(zip(routes["attach"], routes["library"]))
              if a[:BIN_FIELD] + a[BIN_FIELD + 2:] != b[:BIN_FIELD] + b[BIN_FIELD + 2:]]
    if differ:
        i = differ[0]
        raise AssertionError(f"library leg: {len(differ)} records differ, the first {i}: attach tags "
                             f"{parse_z_tags(routes['attach'][i][u2_lengths[i]:])}, library tags "
                             f"{parse_z_tags(routes['library'][i][u2_lengths[i]:])}")
    counts = {name: route_counts(bodies, u2_lengths, planted, want) for name, bodies in routes.items()}
    if counts["attach"] != counts["library"] or counts["library"]["ambiguous"] != LIBRARY_AMBIGUOUS:
        raise AssertionError(f"library leg: counts {counts}, want equal with {LIBRARY_AMBIGUOUS} ambiguous")
    said = {"exact": summary.get("correct"), "corrected": summary.get("corrected"),
            "uncorrectable": summary.get("uncorrectible")}
    if {k: int(v) for k, v in said.items() if v is not None} != {k: counts["attach"][k] for k in said}:
        raise AssertionError(f"library leg: the attach's summary {summary} disagrees with {counts['attach']}")
    log(f"[attach] {stamp} | library leg: bam.Tagger over BarcodeGeneratorWithCorrectedCellBarcodes + "
        f"EmbeddedBarcodeGenerator, hash map of the {LIBRARY_WHITELIST}-barcode whitelist built in "
        f"{map_seconds:.2f} s, {LIBRARY_READS} reads tagged in {tag_seconds:.2f} s = "
        f"{LIBRARY_READS / tag_seconds:.0f} reads/s, no kernel launch; attach -w --i1 on the same inputs "
        f"{attach_seconds:.2f} s, {launches['whitelist_correct']} kernel launch")
    log(f"[attach] library leg: all {LIBRARY_READS} records equal body for body but the bin field (every tag "
        f"and value, CB included); counts {counts['library']} on both routes and in the attach's summary")
    shutil.rmtree(directory)
    return launches["whitelist_correct"]


DECODE_AB_RECORDS = 1 << 16


def same_frames(a, b, packed) -> bool:
    """Every column, dtype and vocabulary of two ReadFrames equal."""
    return all(
        getattr(a, f).dtype == getattr(b, f).dtype and np.array_equal(getattr(a, f), getattr(b, f))
        for f in packed._PER_RECORD_FIELDS
    ) and all(getattr(a, f"{f}_names") == getattr(b, f"{f}_names") for f in packed._CODED_FIELDS)


def decode_ab(path: Path, packed, native, stamp: str) -> None:
    """The first DECODE_AB_RECORDS records of ``path`` decoded by the port's
    Python decoder and by the native stream (query names included, as the
    Python decoder always reads them), in the order Python, native, native,
    Python; every run's frame must be the same."""
    runs = []
    for arm in ("python", "native", "native", "python"):
        begin = time.perf_counter()
        if arm == "python":
            frames = packed._python_frames(str(path), DECODE_AB_RECORDS, packed.DEFAULT_TAG_KEYS)
        else:
            frames = native.stream_frames(str(path), DECODE_AB_RECORDS, want_qname=True)
        frame = next(frames)
        frames.close()
        runs.append((arm, time.perf_counter() - begin, frame))
    if any(f.n_records != DECODE_AB_RECORDS or not same_frames(f, runs[0][2], packed) for _, _, f in runs):
        raise AssertionError("decode A/B: the Python and native frames differ")
    rates = {arm: [DECODE_AB_RECORDS / sec for a, sec, _ in runs if a == arm] for arm in ("python", "native")}
    log(f"[metrics] {stamp} | decode A/B over the first {DECODE_AB_RECORDS} records of the cell BAM "
        f"(Python, native, native, Python; equal frames): Python decoder "
        f"{' / '.join(f'{r:.0f}' for r in rates['python'])} records/s, native stream "
        f"({native.default_threads()} threads) {' / '.join(f'{r:.0f}' for r in rates['native'])} records/s; "
        f"native/Python {statistics.median(rates['native']) / statistics.median(rates['python']):.1f}x")


@contextlib.contextmanager
def recording(module, name: str, into: list):
    """Within the block, ``module.name`` (a gatherer class) is a subclass
    that appends each instance to ``into``, so a command's gatherer can be
    read after the command returns."""
    cls = getattr(module, name)

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            into.append(self)

    setattr(module, name, Recorded)
    try:
        yield
    finally:
        setattr(module, name, cls)


def read_csv(path: Path):
    """(decompressed bytes, header, {index: fields}) of a metrics CSV."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    lines = data.decode().strip().split("\n")
    rows = {}
    for line in lines[1:]:
        name, _, rest = line.partition(",")
        if name in rows:
            raise AssertionError(f"{path.name}: row {name} written twice")
        rows[name] = rest.split(",")
    return data, lines[0].split(",")[1:], rows


def check_cell_rows(header, rows, expected: dict) -> None:
    """Per cell, the CSV's n_reads, n_molecules, n_genes and
    n_mitochondrial_molecules equal the generator's counts."""
    columns = [header.index(c) for c in ("n_reads", "n_molecules", "n_genes", "n_mitochondrial_molecules")]
    if set(rows) != set(expected):
        raise AssertionError(f"cells: {len(rows)} rows, {len(expected)} expected; "
                             f"e.g. {sorted(set(rows) ^ set(expected))[:3]}")
    for cell, want in expected.items():
        got = tuple(int(rows[cell][i]) for i in columns)
        if got != tuple(int(v) for v in want):
            raise AssertionError(f"cell {cell}: (n_reads, n_molecules, n_genes, n_mito) {got} != {want}")


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


def device_events(prof) -> list:
    """The profile's device-side entries (kernels, copies, fills) with their
    device time. An aten op's device time is its kernels' again, so only
    the device-side level is kept: counting both would count each twice."""
    import torch

    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    typed = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    return typed or events


def device_busy_ms(prof) -> float:
    """Milliseconds the device spent in the profile's kernels and copies (one
    stream: they do not overlap)."""
    return sum(_device_us(e) for e in device_events(prof)) / 1e3


def _short(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name if len(name) <= 110 else name[:107] + "..."


def top_device_ops(fn, n: int = 10):
    """The ``n`` kernels of one call of ``fn`` with the most device time,
    from ``torch.profiler``: [(name, calls, device ms)] and the total."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(device_events(prof), key=_device_us, reverse=True)
    return [(_short(e.key), e.count, _device_us(e) / 1e3) for e in events[:n]], device_busy_ms(prof)


SAM_SLICE_RECORDS = 1 << 15


def jax_order_calls(port_gatherer, bgzf, sam, cell_bam: Path, frames: list, mito, keyword_csv: bytes,
                    stamp: str) -> None:
    """The gatherer called as JAX's callers call it, on the card:
    ``GatherCellMetrics(bam, stem, mito, False)`` (``compress`` is JAX's
    fourth parameter) over the cell frames must write the keyword run's CSV
    as plain text, byte for byte; ``extract_metrics(mode="r")`` over a SAM
    text copy of the cell BAM's first SAM_SLICE_RECORDS records must write
    the CSV of the same records as BAM."""
    plain = WORK / "frames_cell_positional"
    begin = time.perf_counter()
    port_gatherer.GatherCellMetrics(str(cell_bam), str(plain), mito, False, frame_source=lambda: iter(frames),
                                    device="cuda").extract_metrics()
    seconds = time.perf_counter() - begin
    written = plain.with_name(plain.name + ".csv")
    if plain.with_name(plain.name + ".csv.gz").exists() or written.read_bytes() != keyword_csv:
        raise AssertionError("GatherCellMetrics(bam, stem, mito, False) did not write the keyword run's CSV "
                             "as plain text")
    log(f"[metrics] {stamp} | GatherCellMetrics(bam, stem, mito, False) on cuda over the cell frames: a plain "
        f".csv equal to the keyword run's CSV byte for byte ({len(keyword_csv)} bytes) in {seconds:.2f} s")

    with bgzf.open_bgzf_reader(str(cell_bam)) as fh:
        header = sam.read_raw_header(fh)
        bodies = []
        for body in sam.iter_raw_records(fh):
            bodies.append(body)
            if len(bodies) == SAM_SLICE_RECORDS:
                break
    slice_bam, slice_sam = WORK / "slice.bam", WORK / "slice.sam"
    write_bgzf(slice_bam, header + b"".join(struct.pack("<I", len(b)) + b for b in bodies), bgzf)
    with sam.AlignmentReader(str(slice_bam)) as reader, \
            sam.AlignmentWriter(str(slice_sam), reader.header, "w") as writer:
        for record in reader:
            writer.write(record)
    csvs, seconds = {}, {}
    for name, path, mode in (("sam", slice_sam, "r"), ("bam", slice_bam, "rb")):
        stem = WORK / f"slice_{name}"
        begin = time.perf_counter()
        port_gatherer.GatherCellMetrics(str(path), str(stem), mito, device="cuda").extract_metrics(mode=mode)
        seconds[name] = time.perf_counter() - begin
        csvs[name] = read_csv(stem.with_name(stem.name + ".csv.gz"))
    if csvs["sam"][0] != csvs["bam"][0] or len(csvs["sam"][2]) < 2:
        raise AssertionError("extract_metrics(mode='r') over the SAM copy differs from the BAM run")
    log(f"[metrics] {stamp} | extract_metrics(mode='r') on cuda over a SAM text copy of the cell BAM's first "
        f"{len(bodies)} records ({slice_sam.stat().st_size} bytes): {len(csvs['sam'][2])} cells in "
        f"{seconds['sam']:.2f} s (the Python decoder), the BAM copy's CSV byte for byte (decompressed; "
        f"{seconds['bam']:.2f} s through the native stream)")


def phase_metrics(rng, stamp: str, modules) -> None:
    """CalculateCellMetrics and CalculateGeneMetrics on the card at the
    2^20-record batch width; the CSVs against the same port on the CPU and
    against the generator's counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels, native, port_platform, port_gatherer, port_device, port_gtf, port_seg, bgzf, packed, sam = modules
    if port_gatherer.DEFAULT_BATCH_RECORDS != METRICS_BATCH:
        raise AssertionError("the smoke's batch width is not the gatherer's default")
    WORK.mkdir(exist_ok=True)
    start = time.perf_counter()
    reads = make_reads(rng, CELL_RECORDS)
    axes = {
        "cell": sort_reads(reads, "cell"),
        "gene": sort_reads({k: v[:GENE_RECORDS] for k, v in reads.items()}, "gene"),
    }
    paths = {axis: WORK / f"{axis}_sorted.bam" for axis in axes}
    # the cell BAM cut in 5 cell-disjoint chunks of its own bytes: phase 10's
    # chunk queue and the later phases' jobs
    (WORK / CELL_CHUNKS).mkdir(exist_ok=True)
    chunk_parts = [(WORK / CELL_CHUNKS / f"chunk{i:04d}.bam", first, end)
                   for i, (first, end) in enumerate(cell_ranges(axes["cell"]["cell"], N_CELL_CHUNKS))]
    for axis, sorted_reads in axes.items():
        write_tagged_bam(paths[axis], rng, sorted_reads, bgzf, chunk_parts if axis == "cell" else ())
    gtf_path = WORK / "mito.gtf"
    write_mito_gtf(gtf_path)
    expected = expected_cell_counts(axes["cell"])
    gene_axis_names = set(np.unique(axes["gene"]["ge"]).astype(str))
    want_genes = {name or "None" for name in gene_axis_names if "," not in name}
    log(f"[metrics] inputs: {CELL_RECORDS} records sorted by (CB, UB, GE), {GENE_RECORDS} by "
        f"(GE, CB, UB); {len(expected)} cells, {len(gene_axis_names)} GE values "
        f"({sum(',' in n for n in gene_axis_names)} multi-gene), {N_GENES} genes in the "
        f"vocabulary ({N_MITO_GENES} MT-), 25 GRCh38 references, {R2_LEN} bp; made in "
        f"{time.perf_counter() - start:.1f} s")

    # the profiler's first start in a process takes seconds (CUPTI set-up):
    # take it here, outside the timed commands
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    launches_before = dict(kernels.launches)
    entry = {"cell": "calculate_cell_metrics", "gene": "calculate_gene_metrics"}
    cls_name = {"cell": "GatherCellMetrics", "gene": "GatherGeneMetrics"}
    cli_csv = {}
    # each command runs alone: nothing else decodes or unpickles meanwhile
    for axis in ("cell", "gene"):
        out = WORK / f"cli_{axis}"
        args = ["-i", str(paths[axis]), "-o", str(out)] + (["-a", str(gtf_path)] if axis == "cell" else [])
        made = []
        torch.cuda.synchronize()
        native.reset_calls()
        begin = time.perf_counter()
        # the device-side profile (no host ops) gives the command's busy time
        with recording(port_platform, cls_name[axis], made), profile(
            activities=[ProfilerActivity.CUDA]
        ) as prof:
            getattr(port_platform.GenericPlatform, entry[axis])(args)
            torch.cuda.synchronize()
        wall = time.perf_counter() - begin
        check_calls(native, entry[axis], batch_stream=1, format_csv_block=None)
        busy_ms = device_busy_ms(prof)
        gatherer = made[0]
        device_ms = gatherer.device_ms()
        split = gatherer.seconds
        # the ring's decode runs on its own thread, beside the rest
        other = wall - sum(v for k, v in split.items() if k != "decode")
        n = len(axes[axis]["cell"])
        log(f"[metrics] {stamp} | {entry[axis]} on cuda: {n} records in {wall:.2f} s = "
            f"{n / wall:.0f} records/s; ring: {gatherer.ring_batches} batches decoded into the native "
            f"arena on its thread in {split['decode']:.2f} s, this thread waited on it "
            f"{split['decode_wait']:.2f} s; pack {split['pack']:.2f} s, upload+enqueue {split['dispatch']:.2f} s, waiting on "
            f"pulls {split['wait']:.2f} s, CSV {split['csv']:.2f} s, other {other:.2f} s; "
            f"per batch, upload to pull on the stream (CUDA events, host gaps included) "
            f"{' + '.join(f'{ms:.2f}' for ms in device_ms)} ms; device busy (torch.profiler, "
            f"kernels and copies) {busy_ms:.1f} ms, idle share {1 - busy_ms / (wall * 1e3):.4f}")
        for i, batch in enumerate(gatherer.batches):
            log(f"[metrics] {axis} batch {i}: {batch['records']} records padded to "
                f"{batch['padded']}, {batch['entities']} entities, "
                f"{'prepacked' if batch['prepacked'] else 'plain'}, "
                f"{'run-keyed' if batch['run_keyed'] else 'dense keys'}, "
                f"{'presorted' if batch['presorted'] else 'device-sorted'}, "
                f"{batch['h2d_bytes']} bytes up")
        if len(gatherer.batches) < 3 or gatherer.batches[0]["padded"] != METRICS_BATCH:
            raise AssertionError(f"{axis}: want a full {METRICS_BATCH}-record batch, a "
                                 f"remainder and a tail")
        cli_csv[axis] = read_csv(out.with_name(out.name + ".csv.gz"))

    decode_ab(paths["cell"], packed, native, stamp)
    # the frames for the cuda/cpu comparison, decoded as the commands decode
    frames = {axis: list(packed.iter_frames_from_bam(str(path), METRICS_BATCH, want_qname=False))
              for axis, path in paths.items()}

    mito = port_gtf.get_mitochondrial_gene_names(str(gtf_path))
    if len(mito) != N_MITO_GENES:
        raise AssertionError(f"{len(mito)} mitochondrial genes read from the GTF")
    frames_csv = {}
    for axis in ("cell", "gene"):
        cls = getattr(port_gatherer, cls_name[axis])
        data = {}
        for device in ("cuda", "cpu"):
            out = WORK / f"frames_{axis}_{device}"
            gatherer = cls(str(paths[axis]), str(out), mito if axis == "cell" else set(),
                           frame_source=lambda: iter(frames[axis]), device=device)
            begin = time.perf_counter()
            gatherer.extract_metrics()
            log(f"[metrics] {axis} from decoded frames on {device}: {time.perf_counter() - begin:.2f} s")
            data[device] = read_csv(out.with_name(out.name + ".csv.gz"))
        if not (data["cuda"][0] == data["cpu"][0] == cli_csv[axis][0]):
            raise AssertionError(f"{axis}: the cuda, cpu and command CSVs differ")
        _, header, rows = data["cuda"]
        if axis == "cell":
            check_cell_rows(header, rows, expected)
        elif set(rows) != want_genes:
            raise AssertionError(f"genes: {len(rows)} rows, {len(want_genes)} single-gene GE values")
        log(f"[metrics] {axis}: decompressed CSVs equal on cuda, cpu and through the command "
            f"({len(rows)} rows, {len(data['cuda'][0])} bytes)"
            + ("; n_reads, n_molecules, n_genes, n_mitochondrial_molecules equal the generator's "
               "for every cell" if axis == "cell" else "; no multi-gene row"))
        frames_csv[axis] = data["cuda"][0]
    jax_order_calls(port_gatherer, bgzf, sam, paths["cell"], frames["cell"], mito, frames_csv["cell"], stamp)

    # the device pass alone, on one staged full batch of each axis
    for axis in ("cell", "gene"):
        frame = frames[axis][0]
        key = frame.cell if axis == "cell" else frame.gene
        cut = int(np.nonzero(key[1:] != key[:-1])[0][-1]) + 1
        batch = port_gatherer.slice_frame(frame, 0, cut)
        gatherer = getattr(port_gatherer, cls_name[axis])(
            str(paths[axis]), str(WORK / "unused"), mito if axis == "cell" else set(), device="cuda")
        gatherer.start_stream()
        cols, kwargs, decisions = gatherer.pack_batch(batch, pad_to=METRICS_BATCH)
        # scx-lint: disable=SCX702 -- each upload is another column (the comprehension's variable), which the model reads as loop-invariant
        staged = {name: to_card(array, gatherer._device) for name, array in cols.items()}
        int_names, float_names = port_gatherer.wire_result_names(gatherer.columns)
        n_entities = int(np.count_nonzero(key[1:cut] != key[: cut - 1])) + 1
        k = port_seg.entity_bucket(n_entities, METRICS_BATCH)

        def one_batch():
            result = port_device.compute_entity_metrics(staged, **kwargs)
            return port_device.compact_results_wire(result, int_names, float_names, k)

        ms = cuda_ms(one_batch, repeats=5)
        ops, profiled_ms = top_device_ops(one_batch)
        log(f"[metrics] {stamp} | {axis} device pass (compute_entity_metrics + "
            f"compact_results_wire) per full batch ({decisions['records']} records padded to "
            f"{kwargs['num_segments']}, {'run-keyed' if decisions['run_keyed'] else 'dense'}): "
            f"{ms:.3f} ms (CUDA events, 5 calls queued back to back); torch.profiler device "
            f"total {profiled_ms:.3f} ms; top ops:")
        for name, count, op_ms in ops:
            log(f"[metrics]   {op_ms:8.3f} ms  x{count:<4d} {name}")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the metrics phase: {kernels.launches}")
    log("[metrics] no hand kernel launched (kernels.launches unchanged)")
    # the commands' CSVs stay for the count phase's merges, the cell CSV and
    # the cell BAM for the sort phase
    clear_work("cli_cell.csv.gz", "cli_gene.csv.gz", "cell_sorted.bam")
    return {axis: WORK / f"cli_{axis}.csv.gz" for axis in ("cell", "gene")}


COUNT_BATCH = 1 << 19  # the count's DEFAULT_BATCH_RECORDS, never cut
# depth: ~1,180,000 records, two full 2^19 batches, a remainder and the
# carried tails at each cut
COUNT_QUERIES = 750_000
ELIGIBLE_XF = (0, 1, 2)  # CODING, INTRONIC, UTR in XF_VALUES
INTERGENIC = 3


def make_count_library(rng, n_queries: int) -> dict:
    """Per-record columns of a queryname-grouped 10x v2 library.

    ~2.4 queries a molecule (cell, UMI, gene as in ``make_reads``); a query
    has NH = k alignments (k = 1, 2, 3 at 57/30/13%) with its molecule's CB
    and UB. The first alignment carries the molecule's gene (5% of them
    INTERGENIC, with no GE); each other one the same gene (60%), another
    gene (25%) or INTERGENIC with no GE (15%). ~0.5% of queries lack CB and
    ~0.5% lack UB; ~0.5% of GE tags name two genes. Queries come in random
    molecule order under increasing zero-padded names, as a queryname sort
    leaves them, so a molecule's queries fall in different batches.
    """
    cells = np.unique(LETTERS[rng.integers(0, 4, size=(N_CELLS + 64, CB_LEN))].view(f"S{CB_LEN}").ravel())
    cells = np.sort(rng.choice(cells, N_CELLS, replace=False))
    n_mol = int(n_queries / 2.4)
    sizes = rng.lognormal(0, 0.6, N_CELLS)
    mol_cell = rng.choice(N_CELLS, n_mol, p=sizes / sizes.sum())
    mol_umi = LETTERS[rng.integers(0, 4, size=(n_mol, UMI_LEN))]
    weights = 1.0 / (np.arange(N_GENES - N_MITO_GENES) + 10.0)
    mol_gene = rng.choice(N_GENES - N_MITO_GENES, n_mol, p=weights / weights.sum())
    mito = rng.random(n_mol) < 0.05
    mol_gene[mito] = N_GENES - N_MITO_GENES + rng.integers(0, N_MITO_GENES, mito.sum())
    query_mol = rng.integers(0, n_mol, n_queries)
    hits = rng.choice([1, 2, 3], n_queries, p=[0.57, 0.30, 0.13])
    query = np.repeat(np.arange(n_queries), hits)
    n = query.size
    first = np.ones(n, dtype=bool)
    first[1:] = query[1:] != query[:-1]
    mol = query_mol[query]
    gene = mol_gene[mol].copy()
    draw = rng.random(n)
    other = ~first & (draw >= 0.6) & (draw < 0.85)
    gene[other] = rng.integers(0, N_GENES, other.sum())
    intergenic = np.where(first, draw < 0.05, draw >= 0.85)
    xf = np.where(intergenic, INTERGENIC, rng.choice(ELIGIBLE_XF, n, p=[0.7, 0.2, 0.1]))
    names = gene_names()
    ge = names[gene].astype("S21")
    multi = ~intergenic & (rng.random(n) < 0.005) & (gene < N_GENES - 1)
    ge[multi] = np.char.add(np.char.add(names[gene[multi]], b","), names[gene[multi] + 1])
    ge[intergenic] = b""
    cb = cells[mol_cell[mol]].view(np.uint8).reshape(n, CB_LEN)
    ub = mol_umi[mol]
    ref = np.where(gene >= N_GENES - N_MITO_GENES, 24, gene % 24)
    lengths = np.array([length for _, length in GRCH38])
    return dict(
        cell=mol_cell[mol], cb=cb, cr=cb, ub=ub, ur=ub, ge=ge, xf=xf,
        unmapped=np.zeros(n, dtype=bool), ref=ref,
        pos=(rng.random(n) * (lengths[ref] - 2000)).astype(np.int64),
        reverse=rng.random(n) < 0.5, duplicate=np.zeros(n, dtype=bool),
        spliced=np.zeros(n, dtype=bool), nh=hits[query],
        qname=query, has_cb=np.repeat(rng.random(n_queries) >= 0.005, hits),
        has_ub=np.repeat(rng.random(n_queries) >= 0.005, hits),
        gene=gene, eligible=~intergenic & ~multi,
    )


def expected_count_matrix(library: dict):
    """(row names, CSR matrix) by the reference's rule (count.py:156-169),
    counted with numpy from the generator's own columns: a query counts iff
    its first alignment has CB and UB and its alignments name exactly one
    eligible gene; each (CB, UB, gene) counts once; rows in order of each
    cell's first counted query (count.py:319-329)."""
    import scipy.sparse as sp

    query, eligible, gene = library["qname"], library["eligible"], library["gene"]
    starts = np.flatnonzero(np.r_[True, query[1:] != query[:-1]])
    lowest = np.minimum.reduceat(np.where(eligible, gene, N_GENES), starts)
    highest = np.maximum.reduceat(np.where(eligible, gene, -1), starts)
    counted = (highest >= 0) & (lowest == highest) & library["has_cb"][starts] & library["has_ub"][starts]
    rows = starts[counted]  # each counted query's first record, in file order
    umi = (np.searchsorted(LETTERS, library["ub"][rows]).astype(np.int64)
           * (4 ** np.arange(UMI_LEN - 1, -1, -1))).sum(1)
    cell = library["cell"][rows]
    key = (cell.astype(np.int64) * 4 ** UMI_LEN + umi) * N_GENES + lowest[counted]
    _, first = np.unique(key, return_index=True)  # each triple's first query
    cell, triple_gene, first_row = cell[first], lowest[counted][first], rows[first]
    present = np.unique(cell)
    cell_first = np.full(N_CELLS, np.iinfo(np.int64).max)
    np.minimum.at(cell_first, cell, first_row)
    order = present[np.argsort(cell_first[present], kind="stable")]
    rank = np.empty(N_CELLS, dtype=np.int64)
    rank[order] = np.arange(order.size)
    matrix = sp.coo_matrix(
        (np.ones(cell.size, dtype=np.uint32), (rank[cell], triple_gene)),
        shape=(order.size, N_GENES), dtype=np.uint32,
    ).tocsr()
    first_record = np.zeros(N_CELLS, dtype=np.int64)
    first_record[library["cell"][::-1]] = np.arange(len(library["cell"]))[::-1]
    names = [library["cb"][first_record[c]].tobytes().decode() for c in order]
    return names, matrix


def write_gene_gtf(path: Path) -> None:
    """A GTF declaring all 33,538 genes (gene_id = gene_name)."""
    lines = ["#!genome-build synthetic\n"]
    for i, name in enumerate(gene_names().astype(str)):
        chrom = "MT" if name.startswith("MT-") else "1"
        lines.append(f'{chrom}\tsmoke\tgene\t{100 * i + 1}\t{100 * i + 90}\t.\t+\t.\t'
                     f'gene_id "{name}"; gene_name "{name}";\n')
    path.write_text("".join(lines))


def canonical(matrix):
    """The CSR matrix with duplicates summed and column indices sorted."""
    matrix = matrix.tocsr(copy=True)
    matrix.sum_duplicates()
    matrix.sort_indices()
    return matrix


def check_same_matrix(name: str, got, want_rows, want) -> None:
    """Entry for entry, in the same row order, with the same row index."""
    if list(map(str, got.row_index)) != list(want_rows):
        raise AssertionError(f"{name}: row index differs ({len(got.row_index)} rows, want {len(want_rows)})")
    a, b = canonical(got.matrix), canonical(want)
    if a.shape != b.shape or a.dtype != b.dtype or not all(
        np.array_equal(getattr(a, attr), getattr(b, attr)) for attr in ("indptr", "indices", "data")
    ):
        raise AssertionError(f"{name}: matrix differs ({a.shape} {a.dtype}, nnz {a.nnz}; want {b.shape} "
                             f"{b.dtype}, nnz {b.nnz})")


def same_files(prefix_a: Path, prefix_b: Path) -> bool:
    """Index files equal byte for byte, the .npz arrays equal."""
    for suffix in ("_row_index.npy", "_col_index.npy"):
        if Path(f"{prefix_a}{suffix}").read_bytes() != Path(f"{prefix_b}{suffix}").read_bytes():
            return False
    with np.load(f"{prefix_a}.npz") as a, np.load(f"{prefix_b}.npz") as b:
        return sorted(a.files) == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a.files)


def write_csv_gz(path: Path, lines) -> Path:
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(("\n".join(lines) + "\n").encode())
    return path


def as_pandas_reads(port_merge, text: str) -> float:
    """A CSV field as the merge reads it (pandas' NA spellings are NaN)."""
    return float("nan") if text in port_merge._NA_VALUES else port_merge._parse_float(text)


def check_metric_merges(port_platform, port_merge, csvs: dict) -> str:
    """MergeCellMetrics on the cell CSV split in two gives its rows back;
    MergeGeneMetrics on the gene CSV and a copy doubles every count, keeps
    every ratio and every read-weighted mean (rtol 1e-12)."""
    _, header, rows = read_csv(csvs["cell"])
    names = list(rows)
    half = len(names) // 2
    parts = [write_csv_gz(WORK / f"cell_part{i}.csv.gz",
                          ["," + ",".join(header)] + [f"{n},{','.join(rows[n])}" for n in chunk])
             for i, chunk in enumerate((names[:half], names[half:]))]
    out = WORK / "merged_cell"
    port_platform.GenericPlatform.merge_cell_metrics([*map(str, parts), "-o", str(out)])
    _, merged_header, merged = read_csv(out.with_name(out.name + ".csv.gz"))
    # the merge reads as pandas does: "None" is NA (written empty), and a
    # float is pandas' parse of its text
    want_names = ["" if n == "None" else n for n in names]
    if merged_header != header or list(merged) != want_names:
        raise AssertionError("merged cell CSV: header or row order differs")
    for name, want_name in zip(names, want_names):
        for got, text in zip(merged[want_name], rows[name]):
            # the merge writes the shortest text of what it read
            if got != text and not np.isclose(float(got or "nan"), as_pandas_reads(port_merge, text),
                                              rtol=0, atol=0, equal_nan=True):
                raise AssertionError(f"merged cell {name}: {got!r} is not {text!r}")

    _, gene_header, gene_rows = read_csv(csvs["gene"])
    out = WORK / "merged_gene"
    port_platform.GenericPlatform.merge_gene_metrics([str(csvs["gene"]), str(csvs["gene"]), "-o", str(out)])
    _, header, merged = read_csv(out.with_name(out.name + ".csv.gz"))
    if set(merged) != set(gene_rows) - {"None"} or list(merged) != sorted(merged):
        raise AssertionError("merged gene CSV: genes differ from the input's, or unsorted")
    counts = port_merge.MergeGeneMetrics.COUNT_COLUMNS_TO_SUM
    weighted = port_merge.MergeGeneMetrics.READ_WEIGHTED_COLUMNS
    ratios = {"reads_per_molecule": ("n_reads", "n_molecules"),
              "fragments_per_molecule": ("n_fragments", "n_molecules"),
              "reads_per_fragment": ("n_reads", "n_fragments")}
    for gene, fields in merged.items():
        got = dict(zip(header, fields))
        src = dict(zip(gene_header, gene_rows[gene]))
        for column in counts:
            if int(got[column]) != 2 * int(src[column]):
                raise AssertionError(f"merged gene {gene}: {column} {got[column]} is not 2 x {src[column]}")
        for column, (top, bottom) in ratios.items():
            with np.errstate(divide="ignore", invalid="ignore"):
                want = np.float64(int(src[top])) / np.float64(int(src[bottom]))
            value = float(got[column]) if got[column] else float("nan")
            if not (value == want or (np.isnan(value) and np.isnan(want))):
                raise AssertionError(f"merged gene {gene}: {column} {value} is not {want}")
        for column in weighted:
            want, value = as_pandas_reads(port_merge, src[column]), float(got[column] or "nan")
            if not np.isclose(value, want, rtol=1e-12, atol=0, equal_nan=True):
                raise AssertionError(f"merged gene {gene}: {column} {value} is not {want}")
    return (f"MergeCellMetrics of the cell CSV in two files gave its {len(names)} rows back; "
            f"MergeGeneMetrics of the gene CSV with itself: {len(merged)} genes, counts doubled, "
            f"ratios kept, read-weighted means within rtol 1e-12")


def phase_count(rng, stamp: str, modules, csvs: dict) -> None:
    """CreateCountMatrix on the card at the count's 2^19-record batch width
    against a numpy count of the generator's columns, the same frames on the
    card and on the CPU, and the three merges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels, native, port_platform, port_count, port_counting, port_merge, port_gtf, bgzf, packed = modules
    if port_count.DEFAULT_BATCH_RECORDS != COUNT_BATCH:
        raise AssertionError("the smoke's batch width is not the count's default")
    phase_start = start = time.perf_counter()
    library = make_count_library(rng, COUNT_QUERIES)
    bam, gtf_path = WORK / "count.bam", WORK / "genes.gtf"
    write_tagged_bam(bam, rng, library, bgzf)
    write_gene_gtf(gtf_path)
    want_rows, want = expected_count_matrix(library)
    n = len(library["qname"])
    log(f"[count] inputs: {COUNT_QUERIES} queries, {n} records grouped by query name, "
        f"{len(want_rows)} cells, {N_GENES} genes in the GTF; made in {time.perf_counter() - start:.1f} s")

    launches_before = dict(kernels.launches)
    made = []
    out = WORK / "cli_count"
    torch.cuda.synchronize()
    native.reset_calls()
    begin = time.perf_counter()
    with recording(port_platform, "CountMatrix", made), profile(activities=[ProfilerActivity.CUDA]) as prof:
        port_platform.GenericPlatform.bam_to_count_matrix(
            ["-b", str(bam), "-a", str(gtf_path), "-o", str(out)])
        torch.cuda.synchronize()
    wall = time.perf_counter() - begin
    check_calls(native, "bam_to_count_matrix", batch_stream=1)
    busy_ms = device_busy_ms(prof)
    command = made[0]
    split = command.seconds
    # the ring's decode runs on its own thread, beside the rest
    other = wall - sum(v for k, v in split.items() if k != "decode")
    log(f"[count] {stamp} | bam_to_count_matrix on cuda: {n} records in {wall:.2f} s = "
        f"{n / wall:.0f} records/s; ring: {command.ring_batches} batches decoded into the native arena "
        f"on its thread in {split['decode']:.2f} s, this thread waited on it {split['decode_wait']:.2f} s; "
        f"carried tails (concat, "
        f"compact, copy) {split['carry']:.2f} s, pack {split['pack']:.2f} s, "
        f"upload+enqueue {split['dispatch']:.2f} s, waiting on pulls {split['wait']:.2f} s, "
        f"accumulate {split['accumulate']:.2f} s, assemble {split['assemble']:.2f} s, save "
        f"{split['save']:.2f} s, other (GTF, CLI, profiler) {other:.2f} s; device busy (torch.profiler, kernels "
        f"and copies) {busy_ms:.1f} ms, idle share {1 - busy_ms / (wall * 1e3):.4f}")
    for i, batch in enumerate(command.batches):
        log(f"[count] batch {i}: {batch['records']} records padded to {batch['padded']}, "
            f"{batch['molecules']} molecules, {batch['h2d_bytes']} bytes up")
    if len(command.batches) < 3 or [b["padded"] for b in command.batches[:2]] != [COUNT_BATCH] * 2:
        raise AssertionError(f"want two full {COUNT_BATCH}-record batches and a remainder")
    check_same_matrix("command", port_count.CountMatrix.load(str(out)), want_rows, want)
    log(f"[count] the command's matrix equals the generator's count: {want.shape[0]} cells x "
        f"{want.shape[1]} genes, {want.nnz} entries, {int(want.sum())} molecules, same row order")

    # the frames for the cuda/cpu comparison, decoded as the command decodes
    kept = list(packed.iter_frames_from_bam(str(bam), COUNT_BATCH, want_qname=True))
    for device in ("cuda", "cpu"):
        prefix = WORK / f"frames_count_{device}"
        begin = time.perf_counter()
        port_count.CountMatrix.from_sorted_tagged_bam(
            str(bam), port_gtf.extract_gene_names(str(gtf_path)),
            frame_source=lambda: iter(kept), device=device).save(str(prefix))
        log(f"[count] from the decoded frames on {device}: {time.perf_counter() - begin:.2f} s")
        if not same_files(prefix, out):
            raise AssertionError(f"the count of the decoded frames on {device} differs from the command's")
    log("[count] the decoded frames counted on cuda and on cpu give the command's .npy bytes and .npz arrays")

    # the count pass alone, on one staged full batch
    frame = kept[0]
    cut = int(np.nonzero(frame.qname[1:] != frame.qname[:-1])[0][-1]) + 1
    block = port_count.pack_count_block(packed.slice_frame(frame, 0, cut), pad_to=COUNT_BATCH)
    staged = to_card(block, "cuda")

    def one_pass():
        return port_counting.count_molecules(dict(zip(port_count.UPLOAD_COLUMNS, staged)),
                                             num_segments=COUNT_BATCH)

    ms = cuda_ms(one_pass, repeats=5)
    ops, profiled_ms = top_device_ops(one_pass)
    log(f"[count] {stamp} | count_molecules per full batch ({cut} records padded to {COUNT_BATCH}): "
        f"{ms:.3f} ms (CUDA events, 5 calls queued back to back); torch.profiler device total "
        f"{profiled_ms:.3f} ms; top ops:")
    for name, count, op_ms in ops:
        log(f"[count]   {op_ms:8.3f} ms  x{count:<4d} {name}")

    # MergeCountMatrices of the matrix split by rows gives it back
    whole = port_count.CountMatrix.load(str(out))
    half = whole.matrix.shape[0] // 2
    parts = []
    for i, rows in enumerate((slice(0, half), slice(half, None))):
        parts.append(str(WORK / f"count_part{i}"))
        port_count.CountMatrix(whole.matrix[rows].tocsr(), whole.row_index[rows], whole.col_index).save(parts[-1])
    port_platform.GenericPlatform.merge_count_matrices(["-i", *parts, "-o", str(WORK / "merged_count")])
    check_same_matrix("MergeCountMatrices", port_count.CountMatrix.load(str(WORK / "merged_count")),
                      want_rows, want)
    log(f"[count] MergeCountMatrices of the matrix in two row chunks ({half} + "
        f"{whole.matrix.shape[0] - half} cells) gave it back exactly")
    log(f"[count] {check_metric_merges(port_platform, port_merge, csvs)}")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the count phase: {kernels.launches}")
    log("[count] no hand kernel launched (kernels.launches unchanged)")
    clear_work(*KEPT_FOR_SORT)
    log(f"[count] phase 6 took {time.perf_counter() - phase_start:.1f} s")


FASTQ_READS = 4 * BATCH  # FastqProcess triplets, in two triplet files
FASTQ_SHARDS = 4
SLIDESEQ_READS = 2 * BATCH
SLIDESEQ_WHITELIST = 100_000
SLIDESEQ_STRUCTURE = "8C18X6C9M1X"  # 14-base cell barcode around an 18-base linker
IUPAC = np.frombuffer(b"RYKMSWBDHVN", dtype=np.uint8)
# BAM base codes as FastqProcess writes them: ACGT in either case, else 15
NIBBLE = np.full(256, 15, dtype=np.uint8)
NIBBLE[list(b"ACGTacgt")] = (1, 2, 4, 8, 1, 2, 4, 8)


def full_rows(rows: np.ndarray) -> list:
    """Each row of a 2-D uint8 array as bytes."""
    return as_bytes(rows, np.full(len(rows), rows.shape[1]))


def write_fastq_files(paths, names, sequences, qualities, cuts) -> None:
    """Records [lo, hi) of each cut into its own gzipped FASTQ file."""
    for path, (lo, hi) in zip(paths, cuts):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(b"".join(b"@%s\n%s\n+\n%s\n" % (names[i], sequences[i], qualities[i])
                             for i in range(lo, hi)))


def expected_indices(wl_ops, table, barcodes, length) -> np.ndarray:
    """The plain version's whitelist index per barcode, on the card, batch by
    batch; -1 for a barcode of another length."""
    out = []
    for lo in range(0, len(barcodes), BATCH):
        q = to_card(wl_ops.barcode_codes(barcodes[lo : lo + BATCH], length), table.codes.device)
        out.append(wl_ops.correct_plain(q, table).cpu().numpy())
    out = np.concatenate(out)
    out[np.array([len(b) for b in barcodes]) != length] = -1
    return out


def read_bam_shard(path: str, bgzf, sam) -> list:
    """(name, packed bases, qualities, [(tag, value)]) of each record of an
    unaligned shard, in order."""
    text = b"@HD\tVN:1.6\tSO:unsorted\n@RG\tID:A\tSM:smoke\n"
    records = []
    with bgzf.open_bgzf_reader(path) as fh:
        if sam.read_raw_header(fh) != b"BAM\1" + struct.pack("<I", len(text)) + text + struct.pack("<I", 0):
            raise AssertionError(f"{path}: unexpected header")
        for body in sam.iter_raw_records(fh):
            l_name, (l_seq,) = body[8], struct.unpack_from("<I", body, 16)
            if body[:16] != struct.pack("<iiBBHHH", -1, -1, l_name, 0, 4680, 0, 4):
                raise AssertionError(f"{path}: unexpected fixed fields {body[:16]!r}")
            seq_at = 32 + l_name
            qual_at = seq_at + (l_seq + 1) // 2
            records.append((body[32 : seq_at - 1], body[seq_at:qual_at], body[qual_at : qual_at + l_seq],
                            parse_z_tags(body[qual_at + l_seq :])))
    return records


def timed_command(kernels, module, class_name, call):
    """Run ``call`` with the launch counts reset just before and read just
    after; returns (result, wall seconds, launches, the command's instance)."""
    import torch

    made = []
    torch.cuda.synchronize()
    kernels.reset_launches()  # a main path's run starts here
    start = time.perf_counter()
    with recording(module, class_name, made):
        result = call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(kernels.launches)  # ... and ends here
    return result, seconds, launches, made[0]


def split_line(seconds: float, split: dict) -> str:
    other = seconds - sum(split.values())
    return (f"read {split['read']:.2f} s, correct (submit + wait) {split['correct']:.2f} s, "
            f"write/compress {split['write']:.2f} s, other {other:.2f} s")


def phase_fastq(rng, whitelist_ascii, table, stamp: str, modules):
    """FastqProcess (BAM and FASTQ shards), SampleFastq, FastqMetrics and
    CheckBarcodePartition through their entry points on the card, against
    the generator and the plain version; returns the kernel launches of
    the phase's main-path runs and the BAM shards, which stay for the sort
    phase."""
    kernels, native, wl_ops, port_platform, port_fqp, port_sample, bgzf, sam = modules
    phase_start = start = time.perf_counter()
    WORK.mkdir(exist_ok=True)
    wl_path = WORK / "whitelist.txt"
    newline = np.full((whitelist_ascii.shape[0], 1), ord("\n"), dtype=np.uint8)
    wl_path.write_bytes(np.concatenate([whitelist_ascii, newline], axis=1).tobytes())

    # 10x v2 triplets: phase 4's query mix without its short reads (FastqMetrics
    # refuses reads shorter than 16C10M; short reads run in the card tests)
    n = FASTQ_READS
    cb_ascii, _, _ = make_queries(rng, whitelist_ascii, n)
    r1_ascii = np.concatenate([cb_ascii, LETTERS[rng.integers(0, 4, size=(n, R1_LEN - CB_LEN))]], axis=1)
    r2_ascii = LETTERS[rng.integers(0, 4, size=(n, R2_LEN))]
    odd = rng.random((n, R2_LEN))
    r2_ascii[odd < 0.002] = IUPAC[rng.integers(0, IUPAC.size, size=int((odd < 0.002).sum()))]
    r2_ascii[(odd >= 0.002) & (odd < 0.004)] += ord("a") - ord("A")
    r1_seq, r2_seq = full_rows(r1_ascii), full_rows(r2_ascii)
    r1_qual = full_rows(rng.integers(35, 75, size=(n, R1_LEN), dtype=np.uint8))
    r2_qual_rows = rng.integers(35, 75, size=(n, R2_LEN), dtype=np.uint8)
    r2_qual = full_rows(r2_qual_rows)
    i1_seq = full_rows(LETTERS[rng.integers(0, 4, size=(n, SAMPLE_LEN))])
    i1_qual = full_rows(rng.integers(35, 75, size=(n, SAMPLE_LEN), dtype=np.uint8))
    names = [b"r%07d 1:N:0:1" % i for i in range(n)]  # Illumina comments: cut at the space
    cuts = ((0, n // 2), (n // 2, n))
    paths = {kind: [str(WORK / f"{kind}_{t}.fastq.gz") for t in range(2)] for kind in ("r1", "r2", "i1")}
    for kind, (seqs, quals) in (("r1", (r1_seq, r1_qual)), ("r2", (r2_seq, r2_qual)), ("i1", (i1_seq, i1_qual))):
        write_fastq_files(paths[kind], names, seqs, quals, cuts)
    total_bytes = sum(Path(p).stat().st_size for kind in paths.values() for p in kind)
    bam_size = total_bytes / ((FASTQ_SHARDS - 0.5) * (1 << 30))  # ceil(3.5) = 4 shards
    log(f"[fastq] inputs: {n} 10x v2 triplets in 2 triplet files (R1 {R1_LEN} bp, R2 {R2_LEN} bp with "
        f"IUPAC and lowercase bases, I1 {SAMPLE_LEN} bp; gz), {total_bytes} bytes, --bam-size {bam_size!r}; "
        f"whitelist {whitelist_ascii.shape[0]} x {CB_LEN}; made in {time.perf_counter() - start:.1f} s")

    cr = [s[:CB_LEN] for s in r1_seq]
    want_index = expected_indices(wl_ops, table, cr, CB_LEN)
    whitelist_rows = whitelist_ascii.tobytes()
    want_cb = [whitelist_rows[k * CB_LEN : (k + 1) * CB_LEN] if k >= 0 else None for k in want_index.tolist()]
    want_counts = {"correct": sum(c is not None and c == r for c, r in zip(want_cb, cr)),
                   "uncorrectable": int((want_index < 0).sum())}
    want_counts["corrected"] = n - want_counts["correct"] - want_counts["uncorrectable"]
    want_packed = ((NIBBLE[r2_ascii[:, 0::2]] << 4) | NIBBLE[r2_ascii[:, 1::2]]).tobytes()
    want_phred = (r2_qual_rows - 33).tobytes()
    half = R2_LEN // 2

    base = ["--r1", *paths["r1"], "--r2", *paths["r2"], "--i1", *paths["i1"], "-w", str(wl_path),
            "--bam-size", repr(bam_size), "--sample-id", "smoke"]
    launches_total = 0
    shard_of = {}
    for fmt in ("BAM", "FASTQ"):
        prefix = WORK / f"shard_{fmt.lower()}"
        stderr = io.StringIO()
        native.reset_calls()
        with contextlib.redirect_stderr(stderr):
            rc, seconds, launches, command = timed_command(
                kernels, port_fqp, "FastqProcess",
                lambda: port_platform.TenXV2.fastq_process(base + ["--output-format", fmt, "-o", str(prefix)]))
        if rc != 0:
            raise AssertionError(f"FastqProcess {fmt} returned {rc}")
        check_calls(native, f"FastqProcess {fmt}", fastqprocess=1)
        batches = -(-n // BATCH)
        launches_total += launches["whitelist_correct"]
        if launches["whitelist_correct"] != batches:
            raise AssertionError(f"FastqProcess {fmt}: {launches['whitelist_correct']} launches, want {batches}")
        lines = stderr.getvalue().strip().splitlines()
        want_lines = [f"Total barcodes:{n}", f" correct:{want_counts['correct']}",
                      f"corrected:{want_counts['corrected']}", f"uncorrectible:{want_counts['uncorrectable']}",
                      f"uncorrected:{want_counts['uncorrectable'] / n * 100.0:f}",
                      f"wrote {FASTQ_SHARDS} {fmt} shard(s), {n} reads"]
        if lines != want_lines:
            raise AssertionError(f"FastqProcess {fmt} stderr {lines} != {want_lines}")
        log(f"[fastq] {stamp} | FastqProcess -w {fmt} on cuda: {n} reads in {seconds:.2f} s = "
            f"{n / seconds:.0f} reads/s (native loop, BGZF pool of {native.pool_threads()} threads); "
            f"{split_line(seconds, command.seconds)}; {batches} batches, "
            f"{launches['whitelist_correct']} kernel launches; counters {want_counts}")

        check_start = time.perf_counter()
        seen = np.zeros(n, dtype=np.int64)
        if fmt == "BAM":
            shards = bam_shards = port_fqp.shard_paths(str(prefix), FASTQ_SHARDS)
            for shard, path in enumerate(shards):
                for name, packed, phred, tags in read_bam_shard(path, bgzf, sam):
                    i = int(name[1:])
                    seen[i] += 1
                    shard_of[i] = shard
                    want = [("CR", cr[i]), ("CY", r1_qual[i][:CB_LEN])]
                    if want_cb[i] is not None:
                        want.append(("CB", want_cb[i]))
                    want += [("UR", r1_seq[i][CB_LEN : CB_LEN + UMI_LEN]), ("UY", r1_qual[i][CB_LEN : CB_LEN + UMI_LEN]),
                             ("SR", i1_seq[i]), ("SY", i1_qual[i])]
                    if (name != b"r%07d" % i or tags != want or packed != want_packed[i * half : (i + 1) * half]
                            or phred != want_phred[i * R2_LEN : (i + 1) * R2_LEN]):
                        raise AssertionError(f"BAM shard {shard}: read {i} differs: {name!r} {tags} != {want}")
            partition = io.StringIO()
            with contextlib.redirect_stderr(partition):
                begin = time.perf_counter()
                ok = port_platform.GenericPlatform.check_barcode_partition(["-b", *shards])
                partition_seconds = time.perf_counter() - begin
                copy = str(WORK / "copy_of_shard_0.bam")
                shutil.copy(shards[0], copy)
                duplicated = port_platform.GenericPlatform.check_barcode_partition(["-b", shards[0], copy])
            if (ok, duplicated) != (0, 1):
                raise AssertionError(f"CheckBarcodePartition: {ok} on the shards, {duplicated} on a shard "
                                     f"and its copy: {partition.getvalue()[-300:]}")
            report = partition.getvalue().strip().splitlines()
            log(f"[fastq] CheckBarcodePartition: 0 on the {FASTQ_SHARDS} shards ({report[0]}; {n} records in "
                f"{partition_seconds:.2f} s), 1 on shard 0 beside its copy ({report[-1]})")
        else:
            for shard in range(FASTQ_SHARDS):
                r1_lines = gzip.decompress(Path(f"{prefix}_R1_{shard}.fastq.gz").read_bytes()).split(b"\n")
                r2_lines = gzip.decompress(Path(f"{prefix}_R2_{shard}.fastq.gz").read_bytes()).split(b"\n")
                for k in range(0, len(r1_lines) - 1, 4):
                    i = int(r1_lines[k][2:])
                    seen[i] += 1
                    want_r1 = [b"@r%07d" % i, r1_seq[i][: CB_LEN + UMI_LEN], b"+", r1_qual[i][: CB_LEN + UMI_LEN]]
                    want_r2 = [b"@r%07d" % i, r2_seq[i], b"+", r2_qual[i]]
                    if r1_lines[k : k + 4] != want_r1 or r2_lines[k : k + 4] != want_r2 or shard_of[i] != shard:
                        raise AssertionError(f"FASTQ shard {shard}: read {i} differs or moved from BAM shard "
                                             f"{shard_of[i]}")
        if not (seen == 1).all():
            raise AssertionError(f"{fmt}: {int((seen == 0).sum())} reads missing, {int((seen > 1).sum())} repeated")
        sizes = np.bincount(np.array([shard_of[i] for i in range(n)]), minlength=FASTQ_SHARDS)
        log(f"[fastq] {fmt} shards checked in {time.perf_counter() - check_start:.1f} s: every read once, "
            + ("names, bases (IUPAC as 15), qualities and tags CR CY [CB] UR UY SR SY equal the generator's, "
               "CB the plain version's on the card" if fmt == "BAM" else
               "R1 = CR+UR / CY+UY, R2 the read, each read in its BAM shard")
            + f"; reads per shard {sizes.tolist()}")

    # SampleFastq: slide-seq pairs, R1 and R2 each over two files cut at
    # different reads (two concatenated streams)
    start = time.perf_counter()
    m = SLIDESEQ_READS
    wl14 = make_whitelist(rng, SLIDESEQ_WHITELIST, 14)
    wl14_path = WORK / "whitelist14.txt"
    wl14_path.write_bytes(np.concatenate([wl14, np.full((len(wl14), 1), ord("\n"), np.uint8)], axis=1).tobytes())
    bc_ascii, bc_len, _ = make_queries(rng, wl14, m)
    linker = LETTERS[rng.integers(0, 4, size=(m, 18))]
    umi = LETTERS[rng.integers(0, 4, size=(m, 10))]
    s1_ascii = np.concatenate([bc_ascii[:, :8], linker, bc_ascii[:, 8:], umi], axis=1)  # 42 bp
    s1_seq = [s if k == 14 else bc[:k] for s, bc, k in zip(full_rows(s1_ascii), full_rows(bc_ascii), bc_len)]
    s1_qual = [q[: len(s)] for q, s in zip(full_rows(rng.integers(35, 75, size=(m, 42), dtype=np.uint8)), s1_seq)]
    s2_seq = full_rows(LETTERS[rng.integers(0, 4, size=(m, R2_LEN))])
    s2_qual = full_rows(rng.integers(35, 75, size=(m, R2_LEN), dtype=np.uint8))
    s_names = [b"s%07d" % i for i in range(m)]
    s_paths = {kind: [str(WORK / f"s{kind}_{t}.fastq.gz") for t in range(2)] for kind in ("r1", "r2")}
    write_fastq_files(s_paths["r1"], s_names, s1_seq, s1_qual, ((0, m // 3), (m // 3, m)))
    write_fastq_files(s_paths["r2"], s_names, s2_seq, s2_qual, ((0, m // 2 + 17), (m // 2 + 17, m)))
    barcodes = [s[:8] + s[26:32] if len(s) == 42 else s for s in s1_seq]
    table14 = wl_ops.make_table(
        to_card(wl_ops.barcode_codes(full_rows(wl14), 14), table.codes.device))
    kept_rows = np.flatnonzero(expected_indices(wl_ops, table14, barcodes, 14) >= 0)
    log(f"[fastq] SampleFastq inputs: {m} {SLIDESEQ_STRUCTURE} pairs (R1 42 bp, R2 {R2_LEN} bp; R1 and R2 in "
        f"two files each, cut at different reads), whitelist {SLIDESEQ_WHITELIST} x 14; made in "
        f"{time.perf_counter() - start:.1f} s")
    out = WORK / "sampled"
    stdout = io.StringIO()
    native.reset_calls()
    with contextlib.redirect_stdout(stdout):
        rc, seconds, launches, command = timed_command(
            kernels, port_sample, "SampleFastq",
            lambda: port_platform.GenericPlatform.sample_fastq(
                ["--R1", *s_paths["r1"], "--R2", *s_paths["r2"], "--white-list", str(wl14_path),
                 "--read-structure", SLIDESEQ_STRUCTURE, "--output-prefix", str(out)]))
    batches = -(-m // BATCH)
    launches_total += launches["whitelist_correct"]
    if rc != 0 or stdout.getvalue() != f"kept {kept_rows.size} of {m} reads\n":
        raise AssertionError(f"SampleFastq: rc {rc}, {stdout.getvalue()!r}, want {kept_rows.size} kept of {m}")
    if launches["whitelist_correct"] != batches:
        raise AssertionError(f"SampleFastq: {launches['whitelist_correct']} launches, want {batches}")
    check_calls(native, "SampleFastq", sample_fastq=1)
    want_r1 = b"".join(
        b"@s%07d\n%s%s%s%sT\n+\n%s%s%s%sF\n" % (
            i, s1_seq[i][:8], b"CTTCAGCGTTCCCGAGAG", s1_seq[i][26:32], s1_seq[i][32:41],
            s1_qual[i][:8], b"F" * 18, s1_qual[i][26:32], s1_qual[i][32:41])
        for i in kept_rows.tolist())
    want_r2 = b"".join(b"@s%07d\n%s\n+\n%s\n" % (i, s2_seq[i], s2_qual[i]) for i in kept_rows.tolist())
    if Path(f"{out}.R1").read_bytes() != want_r1 or Path(f"{out}.R2").read_bytes() != want_r2:
        raise AssertionError("SampleFastq: the kept reads' R1 rewrite or R2 differs from the generator's")
    log(f"[fastq] {stamp} | SampleFastq on cuda: {m} pairs in {seconds:.2f} s = {m / seconds:.0f} reads/s "
        f"(native loop); "
        f"{split_line(seconds, command.seconds)}; {batches} batches, {launches['whitelist_correct']} kernel "
        f"launches; kept {kept_rows.size} (the plain version's count on the card), every rewritten R1 "
        f"(barcode[:8] + linker + barcode[8:] + UMI + T) and R2 exact")

    # FastqMetrics on FastqProcess's R1 files
    prefix = WORK / "fastq_metrics"
    native.reset_calls()
    begin = time.perf_counter()
    port_platform.GenericPlatform.fastq_metrics(["--R1", *paths["r1"], "--read-structure", "16C10M",
                                                 "--sample-id", str(prefix)])
    seconds = time.perf_counter() - begin
    check_calls(native, "FastqMetrics", fastq_metrics=1)
    for suffix, rows in ((".numReads_perCell_XC.txt", r1_ascii[:, :CB_LEN]),
                         (".numReads_perCell_XM.txt", r1_ascii[:, CB_LEN : CB_LEN + UMI_LEN])):
        values, first, counts = np.unique(np.ascontiguousarray(rows).view(f"S{rows.shape[1]}").ravel(),
                                          return_index=True, return_counts=True)
        order = np.lexsort((first, -counts))
        want = b"".join(b"%d\t%s\n" % (counts[k], values[k]) for k in order)
        if Path(f"{prefix}{suffix}").read_bytes() != want:
            raise AssertionError(f"FastqMetrics {suffix} differs from the generator's counts")
    upper = np.where((r1_ascii >= ord("a")) & (r1_ascii <= ord("z")), r1_ascii - 32, r1_ascii)
    for suffix, rows in ((".barcode_distribution_XC.txt", upper[:, :CB_LEN]),
                         (".barcode_distribution_XM.txt", upper[:, CB_LEN : CB_LEN + UMI_LEN])):
        table_rows = np.stack([(rows == ord(b)).sum(axis=0) for b in "ACGTN"], axis=1)
        want = b"position\tA\tC\tG\tT\tN\n" + b"".join(
            b"%d\t%d\t%d\t%d\t%d\t%d\n" % (k + 1, *row) for k, row in enumerate(table_rows.tolist()))
        if Path(f"{prefix}{suffix}").read_bytes() != want:
            raise AssertionError(f"FastqMetrics {suffix} differs from the generator's counts")
    log(f"[fastq] {stamp} | FastqMetrics (host, native scan, {min(2, native.pool_threads())} threads) on the 2 R1 "
        f"files: {n} reads in {seconds:.2f} s = {n / seconds:.0f} reads/s; the four files equal numpy counts "
        f"of the generator")
    clear_work(*KEPT_FOR_SORT, *(Path(p).name for p in bam_shards))
    log(f"[fastq] phase 7 took {time.perf_counter() - phase_start:.1f} s")
    return launches_total, bam_shards


SORT_TAGS = ("CB", "UB", "GE")
SORT_CHUNK = 500_000  # TagSortBam's default --records-per-chunk, not cut
# phase 5's outputs that phases 6 and 7 leave for the sort phase
KEPT_FOR_SORT = ("cli_cell.csv.gz", "cell_sorted.bam")
# the inputs and one-device outputs of phases 5, 6 and 8 that the mesh
# phase runs again on the mesh and compares with
KEPT_FOR_MESH = (
    "cell_sorted.bam", "gene_sorted.bam", "mito.gtf", "cli_cell.csv.gz", "cli_gene.csv.gz",
    "count.bam", "genes.gtf", "cli_count.npz", "cli_count_row_index.npy", "cli_count_col_index.npy",
    "cell_part0.csv.gz", "cell_part1.csv.gz", "merged_cell.csv.gz", "merged_gene.csv.gz",
    "cell_shuffled.bam", "fused_cell.csv.gz", CELL_CHUNKS,
)


def clear_work(*keep: str) -> None:
    """Remove the work files but the names in ``keep``, KEPT_FOR_MESH and
    KEPT_FOR_SERVE, which a later phase reads."""
    for path in WORK.iterdir():
        if path.name not in keep and path.name not in KEPT_FOR_MESH and path.name not in KEPT_FOR_SERVE:
            shutil.rmtree(path) if path.is_dir() else path.unlink()


def raw_bodies(path, bgzf, sam) -> list:
    """The record bodies of a BAM, undecoded, in order."""
    with bgzf.open_bgzf_reader(str(path)) as fh:
        sam.read_raw_header(fh)
        return list(sam.iter_raw_records(fh))


def write_qc_inputs(directory: Path) -> dict:
    """Small Picard, HISAT2 and RSEM files for two cells; returns, per
    GroupQCs type, (files, {(row, column): value written})."""
    directory.mkdir()
    cells = {"cellA": (1000, 0.25, 812), "cellB": (500, 0.5, 377)}
    out = {"Picard": ([], {}), "PicardTable": ([], {}), "HISAT2": ([], {}), "RSEM": ([], {})}
    for cell, (total, duplication, insert) in cells.items():
        path = directory / f"{cell}_qc.alignment_summary_metrics.txt"
        rows = [f"{category}\t{reads}\t{reads}\t" for category, reads in
                (("FIRST_OF_PAIR", total // 2), ("SECOND_OF_PAIR", total // 2), ("PAIR", total))]
        path.write_text("## htsjdk.samtools.metrics.StringHeader\n## METRICS CLASS\t"
                        "picard.analysis.AlignmentSummaryMetrics\nCATEGORY\tTOTAL_READS\tPF_READS\tSAMPLE\n"
                        + "\n".join(rows) + "\n\n## HISTOGRAM\tjava.lang.Integer\nx\ty\n1\t2\n")
        out["Picard"][0].append(str(path))
        out["Picard"][1].update({(cell, "TOTAL_READS.PAIR"): total, (cell, "PF_READS.FIRST_OF_PAIR"): total // 2})
        path = directory / f"{cell}_qc.duplication_metrics.txt"
        path.write_text("## METRICS CLASS\tpicard.sam.DuplicationMetrics\nLIBRARY\tREAD_PAIRS_EXAMINED\t"
                        f"PERCENT_DUPLICATION\nlib1\t{total // 2}\t{duplication}\n")
        out["Picard"][0].append(str(path))
        out["Picard"][1][(cell, "PERCENT_DUPLICATION")] = duplication
        path = directory / f"{cell}_qc.insert_size_metrics.txt"
        path.write_text("## METRICS CLASS\tpicard.analysis.InsertSizeMetrics\nMEDIAN_INSERT_SIZE\t"
                        f"PAIR_ORIENTATION\n{insert}\tFR\n{insert + 5}\tRF\n")
        out["PicardTable"][0].append(str(path))
        out["PicardTable"][1].update({(cell, "MEDIAN_INSERT_SIZE"): insert, (cell, "PAIR_ORIENTATION"): "FR"})
        path = directory / f"{cell}_qc.log"
        path.write_text(f"HISAT2 summary stats:\nTotal reads: {total}\nAligned 0 time: {total // 10} (10.00%)\n"
                        f"Overall alignment rate: 90.00%\n")
        out["HISAT2"][0].append(str(path))
        out["HISAT2"][1].update({(cell, "Total reads"): total, (cell, "Overall alignment rate"): "90.00%"})
        path = directory / f"{cell}_rsem.cnt"
        path.write_text(f"{total // 10} {total - total // 10} 0 {total}\n{insert} 7 3\n{total + 9} 0\n")
        out["RSEM"][0].append(str(path))
        out["RSEM"][1].update({(cell, "total reads"): total, (cell, "unique aligned"): insert})
    return out


def check_qc_csv(path: Path, written: dict, index_column: str = None) -> int:
    """Every (row, column) value written reads back from the CSV (numbers
    as numbers); returns the cells checked."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = rows[0]
    key = header.index(index_column) if index_column else 0
    table = {}
    for row in rows[1:]:
        table.setdefault(row[key], dict(zip(header, row)))
    for (row, column), value in written.items():
        got = table[row][column]
        if (float(got) != value) if isinstance(value, (int, float)) else (got != value):
            raise AssertionError(f"{path.name}: [{row}, {column}] is {got!r}, {value!r} was written")
    return len(written)


def phase_sort(rng, stamp: str, modules, shards) -> None:
    """TagSortBam with the fused cell metrics pass on the card, VerifyBamSort,
    SplitBam and GroupQCs through their entry points."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels, native, port_platform, port_bam, bgzf, sam = modules
    phase_start = start = time.perf_counter()
    with bgzf.open_bgzf_reader(str(WORK / "cell_sorted.bam")) as fh:
        header = sam.read_raw_header(fh)
        phase5 = list(sam.iter_raw_records(fh))
    shuffled = WORK / "cell_shuffled.bam"
    order = rng.permutation(len(phase5))
    write_bgzf(shuffled, header + b"".join(struct.pack("<I", len(phase5[i])) + phase5[i] for i in order), bgzf)
    n = len(phase5)
    log(f"[sort] inputs: phase 5's {n} cell records in a shuffled order (BGZF level 1, "
        f"{shuffled.stat().st_size} bytes); made in {time.perf_counter() - start:.1f} s")

    # the fused pass: the native sort in partials on the host, its merge
    # through a pipe into the native decoder, frames to the card
    stem, sorted_bam = WORK / "fused_cell", WORK / "fused_sorted.bam"
    args = ["-i", str(shuffled), "-t", *SORT_TAGS, "--cell-metrics-output", str(stem),
            "-a", str(WORK / "mito.gtf"), "-o", str(sorted_bam)]
    write_mito_gtf(WORK / "mito.gtf")
    gatherers = []
    torch.cuda.synchronize()
    native.reset_calls()
    kernels.reset_launches()  # the main path's run starts here
    begin = time.perf_counter()
    with recording(port_platform, "GatherCellMetrics", gatherers), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc = port_platform.GenericPlatform.tag_sort_bam(args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - begin
    launches = dict(kernels.launches)  # ... and ends here
    busy_ms = device_busy_ms(prof)
    if rc != 0 or any(launches.values()):
        raise AssertionError(f"TagSortBam: rc {rc}; hand kernel launches {launches} (want none)")
    check_calls(native, "TagSortBam", tagsort_stream_frames=1, format_csv_block=None)
    gatherer = gatherers[0]
    gather_split, sort_split = gatherer.seconds, gatherer.source_stats
    # the ring's producer decodes the pipe on its thread (its seconds hold
    # its waits on the sort), the sort's phases run on the sort's thread,
    # and this thread waits on the ring (decode_wait)
    other = wall - sum(v for k, v in gather_split.items() if k != "decode")
    log(f"[sort] {stamp} | TagSortBam --cell-metrics-output -o on cuda: {n} records in {wall:.2f} s = "
        f"{n / wall:.0f} records/s; native sort ({native.default_threads()} threads, chunks of "
        f"{SORT_CHUNK}) on its thread: read {sort_split['read']:.2f} s, chunk sort {sort_split['sort']:.2f} s, "
        f"{sort_split['partial_files']} partial writes {sort_split['partials']:.2f} s, merge and BAM tee {sort_split['merge']:.2f} s; "
        f"ring: {gatherer.ring_batches} frames decoded from the pipe on its thread in "
        f"{gather_split['decode']:.2f} s; metrics pass: waiting on the ring {gather_split['decode_wait']:.2f} s, pack "
        f"{gather_split['pack']:.2f} s, upload+enqueue {gather_split['dispatch']:.2f} s, wait "
        f"{gather_split['wait']:.2f} s, CSV {gather_split['csv']:.2f} s, other {other:.2f} s; "
        f"{len(gatherer.batches)} device batches; device busy (torch.profiler, kernels and copies) "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / (wall * 1e3):.4f}; no hand kernel launched")
    if sort_split["partial_files"] != -(-n // SORT_CHUNK) or len(gatherer.batches) < 2:
        raise AssertionError(f"want {-(-n // SORT_CHUNK)} partials ({n} records in chunks of {SORT_CHUNK}) "
                             f"and >= 2 device batches, got {sort_split} and {len(gatherer.batches)}")
    fused = read_csv(stem.with_name(stem.name + ".csv.gz"))[0]
    want = read_csv(WORK / "cli_cell.csv.gz")[0]
    if fused != want:
        raise AssertionError("the fused CSV differs from phase 5's CalculateCellMetrics CSV")
    out_bodies = raw_bodies(sorted_bam, bgzf, sam)
    if sorted(out_bodies) != sorted(phase5):
        raise AssertionError("the sorted BAM's records are not the input's")
    if out_bodies != phase5:
        raise AssertionError("the sorted BAM's record order differs from phase 5's (CB, UB, GE) order")
    log(f"[sort] the fused CSV equals phase 5's CalculateCellMetrics CSV byte for byte ({len(fused)} bytes); "
        f"the sorted BAM holds the input's {n} record bodies, in phase 5's order")
    picked = order[:STREAM_RECORDS]
    jax_order_stream(native, bgzf, sam, header, [phase5[i] for i in picked],
                     [phase5[i] for i in np.sort(picked)], stamp)
    del out_bodies, phase5

    stdout = io.StringIO()
    begin = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = port_platform.GenericPlatform.verify_bam_sort(["-i", str(sorted_bam), "-t", *SORT_TAGS])
    verify_seconds = time.perf_counter() - begin
    if rc != 0 or stdout.getvalue() != f"{sorted_bam} is correctly sorted by {list(SORT_TAGS)} and query name\n":
        raise AssertionError(f"VerifyBamSort: rc {rc}, {stdout.getvalue()!r}")
    try:
        port_platform.GenericPlatform.verify_bam_sort(["-i", str(shuffled), "-t", *SORT_TAGS])
    except port_bam.SortError as error:
        refused = str(error).splitlines()[0]
    else:
        raise AssertionError("VerifyBamSort passed the shuffled BAM")
    log(f"[sort] VerifyBamSort: 0 on the sorted BAM ({n} records in {verify_seconds:.2f} s = "
        f"{n / verify_seconds:.0f} records/s), SortError on the shuffled one ({refused})")
    sorted_bam.unlink()  # the shuffled BAM stays for the mesh phase

    # SplitBam on phase 7's four shards, from inside the work directory: the
    # scratch directories go in the working directory. SplitBam re-encodes
    # each record, as the JAX package's does, and the BAM writer writes the
    # bin field (bytes 10-11, an index hint) as 0 where FastqProcess wrote
    # 4680, so records are compared without it
    def unbinned(paths):
        return collections.Counter(b[:10] + b[12:] for path in paths for b in raw_bodies(path, bgzf, sam))

    in_bodies = unbinned(shards)
    size_mb = sum(Path(p).stat().st_size for p in shards) * 1e-6
    before = set(WORK.iterdir())
    stdout = io.StringIO()
    with contextlib.chdir(WORK), contextlib.redirect_stdout(stdout):
        begin = time.perf_counter()
        rc = port_platform.GenericPlatform.split_bam(
            ["-b", *shards, "-p", "chunk", "-s", repr(size_mb / 3.5), "-t", "CB", "CR", "--num-processes", "4"])
        split_seconds = time.perf_counter() - begin
    chunks = stdout.getvalue().split()
    if rc != 0 or chunks != [str((WORK / f"chunk_{i}.bam").resolve()) for i in range(4)]:
        raise AssertionError(f"SplitBam: rc {rc}, printed {chunks}")
    if set(WORK.iterdir()) - before != {Path(c) for c in chunks}:
        raise AssertionError(f"SplitBam left {sorted(set(WORK.iterdir()) - before)}")
    out_bodies = unbinned(chunks)
    if out_bodies != in_bodies or max(out_bodies.values()) != 1:
        raise AssertionError("SplitBam: the chunks do not hold every input record exactly once "
                             f"(bin field aside): {sum(in_bodies.values())} in, {sum(out_bodies.values())} out, "
                             f"{len(in_bodies - out_bodies)} input records missing")
    partition = io.StringIO()
    with contextlib.redirect_stderr(partition):
        ok = port_platform.GenericPlatform.check_barcode_partition(["-b", *chunks])
    if ok != 0:
        raise AssertionError(f"CheckBarcodePartition on the SplitBam chunks: {partition.getvalue()[-300:]}")
    log(f"[sort] SplitBam -t CB CR --num-processes 4: {sum(in_bodies.values())} records of {len(shards)} BAMs "
        f"into {len(chunks)} chunks in {split_seconds:.2f} s; every record in exactly one chunk (its bytes but "
        f"the re-encoded bin field), no scratch "
        f"directory left, CheckBarcodePartition 0 ({partition.getvalue().strip()})")

    # GroupQCs: all five types, on files written here, without pandas
    qc = write_qc_inputs(WORK / "qc")
    checked = 0
    for metrics_type in ("Picard", "HISAT2", "RSEM"):
        files, written = qc[metrics_type]
        out = WORK / "qc" / metrics_type
        port_platform.GenericPlatform.group_qc_outputs(["-f", *files, "-o", str(out), "-t", metrics_type])
        checked += check_qc_csv(out.with_name(out.name + ".csv"), written)
    files, written = qc["PicardTable"]
    for path, cell in zip(files, ("cellA", "cellB")):
        # one CSV per input file, named by its class; a cell's first row is read
        out = WORK / "qc" / f"table_{cell}"
        port_platform.GenericPlatform.group_qc_outputs(["-f", path, "-o", str(out), "-t", "PicardTable"])
        checked += check_qc_csv(out.with_name(out.name + "_insert_size_metrics.csv"),
                                {k: v for k, v in written.items() if k[0] == cell}, "Sample")
    core = WORK / "qc" / "Core"
    port_platform.GenericPlatform.group_qc_outputs(
        ["-f", str(WORK / "qc" / "Picard.csv"), str(WORK / "qc" / "HISAT2.csv"), "-o", str(core), "-t", "Core"])
    checked += check_qc_csv(core.with_name("Core.csv"), {**qc["Picard"][1], **qc["HISAT2"][1]})
    log(f"[sort] GroupQCs Picard, PicardTable, HISAT2, RSEM and Core: {checked} cells read back as written")
    if any(kernels.launches.values()):
        raise AssertionError(f"a hand kernel launched in the sort phase: {kernels.launches}")
    clear_work()
    log(f"[sort] phase 8 took {time.perf_counter() - phase_start:.1f} s")


STREAM_RECORDS = 200_000  # the shuffled records phase 8's JAX-order stream sorts


def jax_order_stream(native, bgzf, sam, header: bytes, shuffled: list, want: list, stamp: str) -> None:
    """``native.tagsort_stream_frames`` over ``shuffled`` (raw record
    bodies; ``want`` is their sorted order), twice: with its defaults (a
    level-1 tee, no query names), and in JAX's positional order (input,
    tags, batch, sort batch, tee, level, scratch prefix, threads, qnames) at
    level 6 on 2 decoder threads with query names. Both tees hold ``want``,
    the level-6 one in fewer bytes; the level-6 frames carry every record's
    query name in that order; the default scratch prefix leaves no partial
    beside either tee."""
    source = WORK / "stream_shuffled.bam"
    write_bgzf(source, header + b"".join(struct.pack("<I", len(b)) + b for b in shuffled), bgzf)
    sort_batch = SORT_CHUNK // 5  # a few partials for the merge
    runs = {}
    for level in (1, 6):
        tee = WORK / f"stream_level{level}.bam"
        begin = time.perf_counter()
        if level == 1:
            frames = native.tagsort_stream_frames(str(source), SORT_TAGS, sort_batch_records=sort_batch,
                                                  bam_output=str(tee))
        else:
            frames = native.tagsort_stream_frames(str(source), SORT_TAGS, METRICS_BATCH, sort_batch, str(tee), 6,
                                                  None, 2, True)
        names, streamed = [], 0
        for frame in frames:
            names.extend(np.asarray(frame.qname_names, dtype=object)[frame.qname].tolist())
            streamed += frame.n_records
        runs[level] = dict(seconds=time.perf_counter() - begin, names=names, streamed=streamed,
                           bodies=raw_bodies(tee, bgzf, sam), size=tee.stat().st_size)
    partials = sorted(p.name for p in WORK.glob("*.tagsort_partial*"))
    # a record body's read name: l_read_name at byte 8, the name from byte 32
    if runs[6]["names"] != [b[32:32 + b[8] - 1].decode() for b in want] or set(runs[1]["names"]) != {""}:
        raise AssertionError("tagsort_stream_frames: the query names are not the sorted records' (want_qname=True) "
                             "or not empty (the default)")
    if not (runs[1]["bodies"] == runs[6]["bodies"] == want) or runs[1]["streamed"] != runs[6]["streamed"]:
        raise AssertionError("tagsort_stream_frames: the level-6 and level-1 tees do not both hold the sorted records")
    if runs[6]["size"] >= runs[1]["size"] or partials:
        raise AssertionError(f"tagsort_stream_frames: level 6 {runs[6]['size']} bytes against level 1's "
                             f"{runs[1]['size']}, partials left {partials}")
    for path in (source, WORK / "stream_level1.bam", WORK / "stream_level6.bam"):
        path.unlink()
    log(f"[sort] {stamp} | tagsort_stream_frames over {len(shuffled)} shuffled records ({sort_batch} a partial): "
        f"with its defaults {runs[1]['seconds']:.2f} s, a {runs[1]['size']}-byte level-1 tee; in JAX's order "
        f"(level 6, 2 decoder threads, query names) {runs[6]['seconds']:.2f} s, the same record bodies in "
        f"{runs[6]['size']} bytes and every query name in the sorted order; no partial left")


MESH_SHARDS = 2
# the distributed step's and the sample sort's input: the cell BAM's first
# records, at 2 shards of 2^17 (their CPU mesh run is the reference)
MESH_STEP_RECORDS = 1 << 18


@contextlib.contextmanager
def mesh_for_devices(port_platform, mesh):
    """Within the block, ``--devices N`` with N the mesh's size resolves to
    ``mesh`` (the one-card mesh, which no command line can ask for); every
    other value resolves as the command would."""
    real = port_platform._resolve_mesh

    def resolve(devices, backend, parser, device):
        if devices == mesh.size and backend != "cpu":
            return mesh
        return real(devices, backend, parser, device)

    port_platform._resolve_mesh = resolve
    try:
        yield
    finally:
        port_platform._resolve_mesh = real


def same_sharded(name: str, got: dict, want: dict) -> None:
    """Two stacked sharded results equal, float bits included."""
    if set(got) != set(want):
        raise AssertionError(f"{name}: columns {sorted(got)} != {sorted(want)}")
    for key in want:
        a, b = got[key], want[key]
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
            a.view(np.int32) if a.dtype == np.float32 else a, b.view(np.int32) if b.dtype == np.float32 else b
        ):
            raise AssertionError(f"{name}: {key} differs between the card mesh and the CPU mesh")


def phase_mesh(stamp: str, modules) -> None:
    """The six ``--devices`` commands on a 2-shard card mesh against their
    one-device outputs of phases 5, 6 and 8; the mesh functions on the card
    against a CPU mesh."""
    import torch

    kernels, port_platform, port_par, port_par_gatherer, port_gatherer, port_gtf, packed = modules
    phase_start = time.perf_counter()
    launches_before = dict(kernels.launches)
    n_cards = torch.cuda.device_count()
    if n_cards >= MESH_SHARDS:
        mesh = port_par.make_mesh(MESH_SHARDS)
        patch = contextlib.nullcontext()
        how = f"the commands' own --devices {MESH_SHARDS}"
    else:
        # the CLI's mesh needs as many cards as shards: JAX's parser error
        stderr = io.StringIO()
        with contextlib.redirect_stderr(stderr), contextlib.suppress(SystemExit):
            port_platform.GenericPlatform.calculate_cell_metrics(
                ["-i", str(WORK / "cell_sorted.bam"), "-o", str(WORK / "refused"), "--devices", str(MESH_SHARDS)])
        want = f"error: requested {MESH_SHARDS} devices, only {n_cards} available"
        if want not in stderr.getvalue() or list(WORK.glob("refused*")):
            raise AssertionError(f"--devices {MESH_SHARDS} on {n_cards} card: {stderr.getvalue()!r}")
        log(f"[mesh] --devices {MESH_SHARDS} on this {n_cards}-card machine stops at the parser: {want!r}")
        card = torch.device("cuda", 0)
        mesh = port_par.make_mesh(devices=[card] * MESH_SHARDS)
        patch = mesh_for_devices(port_platform, mesh)
        how = f"--devices {MESH_SHARDS} resolved to the one-card mesh"
    log(f"[mesh] {n_cards} card(s) of {torch.cuda.get_device_name(0)}: the commands run on {mesh!r} ({how}); "
        f"fingerprint {port_par.mesh_fingerprint(mesh)}")
    devices = ["--devices", str(MESH_SHARDS)]
    mito = str(WORK / "mito.gtf")
    commands = [
        ("calculate_cell_metrics", "ShardedCellMetrics",
         ["-i", str(WORK / "cell_sorted.bam"), "-o", str(WORK / "mesh_cell"), "-a", mito],
         "mesh_cell.csv.gz", "cli_cell.csv.gz"),
        ("calculate_gene_metrics", "ShardedGeneMetrics",
         ["-i", str(WORK / "gene_sorted.bam"), "-o", str(WORK / "mesh_gene")],
         "mesh_gene.csv.gz", "cli_gene.csv.gz"),
        ("bam_to_count_matrix", "CountMatrix",
         ["-b", str(WORK / "count.bam"), "-a", str(WORK / "genes.gtf"), "-o", str(WORK / "mesh_count")],
         "mesh_count", "cli_count"),
        ("merge_cell_metrics", None,
         [str(WORK / "cell_part0.csv.gz"), str(WORK / "cell_part1.csv.gz"), "-o", str(WORK / "mesh_merged_cell")],
         "mesh_merged_cell.csv.gz", "merged_cell.csv.gz"),
        ("merge_gene_metrics", None,
         [str(WORK / "cli_gene.csv.gz"), str(WORK / "cli_gene.csv.gz"), "-o", str(WORK / "mesh_merged_gene")],
         "mesh_merged_gene.csv.gz", "merged_gene.csv.gz"),
        ("tag_sort_bam", "ShardedCellMetrics",
         ["-i", str(WORK / "cell_shuffled.bam"), "-t", *SORT_TAGS, "--cell-metrics-output",
          str(WORK / "mesh_fused"), "-a", mito],
         "mesh_fused.csv.gz", "fused_cell.csv.gz"),
    ]
    with patch:
        for entry, recorded, args, got, want in commands:
            made = []
            module = port_platform if recorded == "CountMatrix" else port_par_gatherer
            torch.cuda.synchronize()
            begin = time.perf_counter()
            with recording(module, recorded, made) if recorded else contextlib.nullcontext():
                rc = getattr(port_platform.GenericPlatform, entry)(args + devices)
                torch.cuda.synchronize()
            wall = time.perf_counter() - begin
            if entry == "bam_to_count_matrix":
                equal = same_files(WORK / got, WORK / want)
            else:
                equal = read_csv(WORK / got)[0] == read_csv(WORK / want)[0]
            if rc != 0 or not equal:
                raise AssertionError(f"{entry} --devices {MESH_SHARDS}: rc {rc}, output equal to {want}: {equal}")
            detail = ""
            if made:
                runner = made[0]
                split = ", ".join(f"{k} {v:.2f}" for k, v in runner.seconds.items() if isinstance(v, float))
                shards = [b.get("shards", MESH_SHARDS) for b in runner.batches]
                detail = (f"; {len(runner.batches)} batches over {shards[0] if shards else MESH_SHARDS} shards, "
                          f"{sum(b['records'] for b in runner.batches)} records padded to "
                          f"{sum(b['padded'] for b in runner.batches)}; seconds: {split}")
                if getattr(runner, "source_stats", None):
                    detail += "; sort: " + ", ".join(
                        f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}" for k, v in runner.source_stats.items())
            log(f"[mesh] {stamp} | {entry} --devices {MESH_SHARDS}: {wall:.2f} s wall{detail}; "
                f"output equals {want} (one device)")

    cpu_mesh = port_par.make_mesh(MESH_SHARDS, device="cpu")
    begin = time.perf_counter()
    if port_par.collective_preflight(mesh) != port_par.collective_preflight(cpu_mesh):
        raise AssertionError("collective_preflight: the card mesh and the CPU mesh differ")
    frames = packed.iter_frames_from_bam(str(WORK / "cell_sorted.bam"), MESH_STEP_RECORDS, want_qname=False)
    frame = next(frames)
    frames.close()
    names = port_gtf.get_mitochondrial_gene_names(mito)
    is_mito = np.asarray([name in names for name in frame.gene_names], dtype=bool)
    cols = port_gatherer._pad_columns(frame, is_mito)[0]
    stacked = port_par.partition_columns(cols, MESH_SHARDS, key="cell")
    keys = {"k1": frame.cell.reshape(MESH_SHARDS, -1), "k2": frame.umi.reshape(MESH_SHARDS, -1),
            "payload": np.arange(frame.n_records, dtype=np.int32).reshape(MESH_SHARDS, -1),
            "valid": np.ones((MESH_SHARDS, frame.n_records // MESH_SHARDS), dtype=bool)}
    seconds = {}
    results = {}
    for name, on in (("card", mesh), ("cpu", cpu_mesh)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        cell, gene = port_par.distributed_metrics_step(stacked, on)
        step = (port_par.stack_to_host(cell), port_par.stack_to_host(gene))
        seconds[name, "step"] = time.perf_counter() - start
        start = time.perf_counter()
        ordered = port_par.stack_to_host(port_par.distributed_sort(keys, ["k1", "k2"], on))
        seconds[name, "sort"] = time.perf_counter() - start
        results[name] = step + (ordered,)
    for label, got, want in zip(("step cell", "step gene", "sort"), results["card"], results["cpu"]):
        same_sharded(label, got, want)
    flat = np.concatenate([results["card"][2]["k1"][s][results["card"][2]["valid"][s]] for s in range(MESH_SHARDS)])
    if flat.size != frame.n_records or np.any(np.diff(flat) < 0):
        raise AssertionError("distributed_sort: the flattened shards are not the records in order")
    log(f"[mesh] {stamp} | collective_preflight equal on the card and CPU meshes; distributed_metrics_step "
        f"({frame.n_records} records, {stacked['cell'].shape[1]} a shard) card {seconds['card', 'step']:.2f} s, "
        f"cpu {seconds['cpu', 'step']:.2f} s; distributed_sort (cell, umi) card {seconds['card', 'sort']:.2f} s, "
        f"cpu {seconds['cpu', 'sort']:.2f} s; every output equal bit for bit ({time.perf_counter() - begin:.1f} s)")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the mesh phase: {kernels.launches}")
    log("[mesh] no hand kernel launched (kernels.launches unchanged)")
    for path in WORK.iterdir():
        if path.name not in KEPT_FOR_SCHED:
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    log(f"[mesh] phase 9 took {time.perf_counter() - phase_start:.1f} s")


# phase 5's cell BAM, its GTF and its one-shot CSV, and phase 10's chunks:
# the distributed phase's inputs
# phase 5's cell BAM and GTF, phase 6's count BAM and GTF and phase 10's
# chunks: the tracing phase's inputs; phase 11's serve journal: the audit
# phase's
SERVE_AUDIT = "serve_audit"
KEPT_FOR_TRACING = ("cell_sorted.bam", "mito.gtf", "count.bam", "genes.gtf", "chunks", SERVE_AUDIT)
KEPT_FOR_DIST = ("cell_sorted.bam", "mito.gtf", "cli_cell.csv.gz", "chunks", *KEPT_FOR_TRACING)
# phase 5's cell BAM (the serve workers' calibration BAM) and phase 10's
# chunks (the serve phase's tenant jobs) are among them
KEPT_FOR_SERVE = KEPT_FOR_DIST
# phase 5's cell BAM, its GTF and its one-shot CSV, for the chunk queue
KEPT_FOR_SCHED = ("cell_sorted.bam", "mito.gtf", "cli_cell.csv.gz", CELL_CHUNKS, *KEPT_FOR_SERVE)
SCHED_CHUNKS = 4.5  # SplitBam's -s is its input's size over this: 5 chunks
SPLIT_INPUTS = 2  # phase 5's chunks SplitBam cuts: 2 of 5, 40% of the cell BAM
SCHED_TTL = 2.0  # seconds a dead worker's lease outlives its last heartbeat
SCHED_STRAGGLE = 0.5  # worker B's delay at each claim
WORKER_FLAG = "--sched-worker"


def sched_worker(argv) -> int:
    """One worker of phase 10, in its own process: the port's chunk queue on
    cuda over ``<workdir>/chunks/*.bam``, faults from the environment
    (``SCTOOLS_TPU_FAULTS``). Prints, as ``[worker] {json}`` lines, the hand
    kernel launches (a count a process) when its queue starts and, at its
    end, with its wall and its committed parts. Exit 0, or 86 on an injected
    crash, which leaves only the first line."""
    workdir, process_id, n_processes, gtf = Path(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    begin = time.perf_counter()
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import kernels, obs
    from sctools_tpu_torch.ingest import framedebug
    from sctools_tpu_torch.parallel import launch

    print("[worker] " + json.dumps({"launches": dict(kernels.launches)}), flush=True)
    committed = launch.run_process_cell_metrics(
        sorted(str(p) for p in (workdir / "chunks").glob("*.bam")), str(workdir / f"proc{process_id}"),
        n_processes, process_id, frozenset(port_gtf.get_mitochondrial_gene_names(gtf)),
        lease_ttl=SCHED_TTL, backoff_base=0.1,
    )
    # the guard's and the wire's counters (a traced worker's), and the frame
    # witness's stamps and stale reads (phase 18)
    counters = {k: v for k, v in obs.counters().items() if k.startswith(("guard_", "sched_fault_", "wire_"))}
    print("[worker] " + json.dumps({"wall": time.perf_counter() - begin, "committed": len(committed),
                                    "launches": dict(kernels.launches), "counters": counters,
                                    "stamped": framedebug.stamped_count(),
                                    "frame_violations": framedebug.violations()}), flush=True)
    return 0


def split_records(paths, packed) -> tuple:
    """The (query name, cell, UMI, gene, position) columns of every record of
    ``paths``, ordered by the query name (unique in the smoke's BAMs), and
    each file's set of cells; decoded by the native stream."""
    columns, cells = collections.defaultdict(list), []
    for path in paths:
        mine = set()
        for frame in packed.iter_frames_from_bam(str(path), METRICS_BATCH, want_qname=True):
            for field in ("qname", "cell", "umi", "gene"):
                names = np.array([*getattr(frame, f"{field}_names"), ""], dtype=object)  # code -1: ""
                columns[field].append(names[getattr(frame, field)])
            columns["pos"].append(frame.pos)
            mine.update(columns["cell"][-1].tolist())
        cells.append(mine)
    joined = {field: np.concatenate(parts) for field, parts in columns.items()}
    order = np.argsort(joined["qname"], kind="stable")
    return {field: column[order] for field, column in joined.items()}, cells


def phase_sched(stamp: str, modules) -> None:
    """SplitBam on two of phase 5's cell chunks (every record in exactly one
    output, no cell in two), then the chunk queue on the card over phase 5's
    five: two worker processes at once, one killed mid-chunk and the other a
    straggler that fails one chunk twice and steals the dead one's lease, a
    clean relaunch, ``sched status``, and both part merges against phase 5's
    one-shot CSV."""
    import os

    import torch

    from sctools_tpu_torch.io import packed

    port_platform, port_sched, port_launch, port_collective = modules
    phase_start = start = time.perf_counter()
    workdir = WORK / "sched"
    (workdir / "split").mkdir(parents=True)
    inputs = sorted((WORK / CELL_CHUNKS).glob("chunk*.bam"))[:SPLIT_INPUTS]
    size_mb = sum(p.stat().st_size for p in inputs) * 1e-6
    stdout = io.StringIO()
    with contextlib.chdir(workdir), contextlib.redirect_stdout(stdout):
        rc = port_platform.GenericPlatform.split_bam(
            ["-b", *map(str, inputs), "-p", str(workdir / "split" / "chunk"), "-s", repr(size_mb / SCHED_CHUNKS),
             "-t", "CB"])
    split_seconds = time.perf_counter() - start
    made = stdout.getvalue().split()
    if rc != 0 or len(made) < 4:
        raise AssertionError(f"SplitBam: rc {rc}, want >= 4 chunks, printed {made}")
    begin = time.perf_counter()
    want_rows, _ = split_records(inputs, packed)
    got_rows, cells = split_records(sorted((workdir / "split").glob("chunk_*.bam")), packed)
    n_records = len(want_rows["qname"])
    same = len(got_rows["qname"]) == n_records and all(np.array_equal(got_rows[f], want_rows[f]) for f in want_rows)
    if not same or sum(map(len, cells)) != len(set().union(*cells)) or \
            [p.name for p in workdir.iterdir()] != ["split"]:
        raise AssertionError(f"SplitBam: {len(got_rows['qname'])} records out of {n_records} (equal: {same}), cells "
                             f"{list(map(len, cells))} ({len(set().union(*cells))} distinct), left "
                             f"{[p.name for p in workdir.iterdir()]}")
    log(f"[sched] SplitBam -t CB -s {size_mb / SCHED_CHUNKS:.2f} on phase 5's chunks {[p.name for p in inputs]} "
        f"({size_mb:.1f} MB, {n_records} records): {len(made)} chunks in {split_seconds:.2f} s; every record "
        f"in one chunk (name, cell, UMI, gene, position), no cell in two, no scratch left "
        f"(checked in {time.perf_counter() - begin:.2f} s)")
    shutil.rmtree(workdir / "split")
    # phase 5's chunks, cell-disjoint cuts of its cell BAM, are the queue's
    # tasks: task chunkNNNN reads chunkNNNN.bam and a fault spec can name either
    shutil.move(str(WORK / CELL_CHUNKS), str(workdir / "chunks"))
    n_chunks = len(list((workdir / "chunks").glob("chunk*.bam")))

    journal_dir = workdir / "sched-journal"
    gtf = str(WORK / "mito.gtf")

    def launch(process_id: int, spec: str):
        env = {k: v for k, v in os.environ.items() if k != "SCTOOLS_TPU_FAULTS"}
        if spec:
            env["SCTOOLS_TPU_FAULTS"] = spec
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), WORKER_FLAG, str(workdir), str(process_id), "2", gtf],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        return proc, time.perf_counter()

    def finish(proc, began, timeout=300):
        out, _ = proc.communicate(timeout=timeout)
        return proc.returncode, out, time.perf_counter() - began

    def worker_id(proc, process_id):
        return f"proc{process_id}-of-2-{proc.pid}"

    spec_a = "crash@gatherer.batch:match=chunk0000,times=1"
    spec_b = f"delay@task.claimed:secs={SCHED_STRAGGLE};fail@task.claimed:match=chunk0002,times=2"
    procs = []
    try:
        # A first, so that it holds chunk0000 (the first task by name) when
        # B starts; B then finds it leased and takes the rest
        a, a_began = launch(0, spec_a)
        procs.append(a)
        probe = port_sched.Journal(str(journal_dir), worker_id="smoke-probe")
        deadline = time.perf_counter() + 120
        holder = None
        while holder is None and time.perf_counter() < deadline:
            exited = a.poll() is not None  # then this last look sees its final journal
            if journal_dir.is_dir():
                tasks, states = probe.replay()
                holder = next((st.worker for tid, st in states.items()
                               if tid in tasks and tasks[tid].name == "chunk0000" and st.state == "leased"), None)
            if exited:
                break
            time.sleep(0.05)
        if holder != worker_id(a, 0):
            raise AssertionError(f"worker A never leased chunk0000 (holder {holder}): {a.communicate()[0][-3000:]}")
        b, b_began = launch(1, spec_b)
        procs.append(b)
        runs = {"A": finish(a, a_began), "B": finish(b, b_began)}
        ids = {"A": worker_id(a, 0), "B": worker_id(b, 1)}
        before_relaunch = probe.replay()[1]
        r, r_began = launch(0, "")
        procs.append(r)
        runs["relaunch"] = finish(r, r_began)
        ids["relaunch"] = worker_id(r, 0)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if runs["A"][0] != 86 or "injected crash at gatherer.batch" not in runs["A"][1]:
        raise AssertionError(f"worker A should die at gatherer.batch with 86: rc {runs['A'][0]}\n{runs['A'][1][-3000:]}")
    for name in ("B", "relaunch"):
        if runs[name][0] != 0:
            raise AssertionError(f"worker {name}: rc {runs[name][0]}\n{runs[name][1][-3000:]}")

    tasks, states = probe.replay()
    by_name = {tasks[tid].name: st for tid, st in states.items()}
    if len(by_name) != n_chunks or any(st.state != port_sched.COMMITTED for st in by_name.values()):
        raise AssertionError(f"not every chunk committed: { {n: st.state for n, st in by_name.items()} }")
    want_attempts = {name: 1 for name in by_name}
    want_attempts.update(chunk0000=2, chunk0002=3)
    got = {name: (st.attempts, st.steals) for name, st in by_name.items()}
    if got != {name: (n, int(name == "chunk0000")) for name, n in want_attempts.items()}:
        raise AssertionError(f"(attempts, steals) per chunk: {got}")
    if by_name["chunk0000"].worker != ids["B"]:
        raise AssertionError(f"chunk0000 committed by {by_name['chunk0000'].worker}, not B ({ids['B']})")
    if {t: vars(st) for t, st in states.items()} != {t: vars(st) for t, st in before_relaunch.items()}:
        raise AssertionError("the relaunch changed the journal's task states")
    events = probe.events()
    for name, (rc, out, wall) in runs.items():
        leased = [e for e in events if e.get("worker") == ids[name] and e.get("event") == "leased"]
        reports = [json.loads(line[len("[worker] "):]) for line in out.splitlines() if line.startswith("[worker] ")]
        # A's crash (os._exit at the top of its first device batch) leaves
        # only its first report; the others report at their end too
        if len(reports) != (1 if name == "A" else 2) or any(any(r["launches"].values()) for r in reports):
            raise AssertionError(f"worker {name}: hand kernel launches {reports}")
        log(f"[sched] {stamp} | worker {name} ({ids[name]}): exit {rc} in {wall:.2f} s wall, "
            f"{len(leased)} attempts, {sum(int(e.get('stolen', 0)) for e in leased)} steals, "
            f"hand kernel launches 0 {'at its start' if name == 'A' else 'at its start and its end'}")
    if any(e.get("worker") == ids["relaunch"] and e.get("event") == "leased" for e in events):
        raise AssertionError("the clean relaunch made an attempt")

    status = subprocess.run(
        [sys.executable, "-m", "sctools_tpu_torch.sched", "status", str(journal_dir)],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    total = [line for line in status.stdout.splitlines() if line.startswith("total=")]
    if status.returncode != 0 or total != [f"total={n_chunks} (committed={n_chunks})"]:
        raise AssertionError(f"sched status: rc {status.returncode}\n{status.stdout}{status.stderr}")
    log(f"[sched] python -m sctools_tpu_torch.sched status: exit 0, {total[0]}; "
        f"{[line for line in status.stdout.splitlines() if line.startswith('mesh ')]}")

    pattern = str(workdir / "metrics.part*.csv.gz")
    want = read_csv(WORK / "cli_cell.csv.gz")[0]
    mesh = port_launch.local_mesh()
    merged = {}
    for name, merge, kwargs in (("merge_sorted_csv_parts", port_launch.merge_sorted_csv_parts, {}),
                                ("collective_merge_parts", port_collective.collective_merge_parts, {"mesh": mesh})):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        rows = merge(pattern, str(workdir / f"{name}.csv.gz"), journal_dir=str(journal_dir),
                     expected_parts=n_chunks, **kwargs)
        torch.cuda.synchronize()
        merged[name] = time.perf_counter() - begin
        if read_csv(workdir / f"{name}.csv.gz")[0] != want:
            raise AssertionError(f"{name}: the merged CSV differs from phase 5's CalculateCellMetrics CSV")
    log(f"[sched] {stamp} | merge_sorted_csv_parts {merged['merge_sorted_csv_parts']:.2f} s, "
        f"collective_merge_parts on {mesh!r} {merged['collective_merge_parts']:.2f} s: {rows} rows each, "
        f"both equal phase 5's CalculateCellMetrics CSV byte for byte ({len(want)} bytes)")
    # the chunks are the serve phase's tenant jobs
    shutil.move(str(workdir / "chunks"), str(WORK / "chunks"))
    for path in WORK.iterdir():
        if path.name not in KEPT_FOR_SERVE:
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    log(f"[sched] phase 10 took {time.perf_counter() - phase_start:.1f} s")



# phase 10's five chunks as three tenants' jobs
SERVE_TENANTS = (("t0", (0, 1)), ("t1", (2, 3)), ("t2", (4,)))
# and two small jobs a tenant, which the planner puts in the chunks' packs:
# its estimate (file size over 48 bytes, the JAX package's) reads each
# chunk (~160 bytes a record) as 790,000-910,000 records, so a chunk fills
# most of a 2^20 pack alone
SERVE_SMALL_JOBS = 2
SERVE_SMALL_RECORDS = 30_000
SERVE_TTL = 2.0  # seconds a dead worker's lease outlives its last heartbeat
SERVE_HOLD = 120.0  # the victim's delay at its first claim: it is killed inside it
SERVE_FLAG = "--serve-worker"


def serve_worker(argv) -> int:
    """One resident worker of phase 11, in its own process: ``python -m
    sctools_tpu_torch.serve worker`` with ``argv`` (on cuda, its default),
    faults from the environment. Prints the hand kernel launches as
    ``[worker] {json}`` lines when it starts and, after the CLI's own JSON
    summary line, at its end."""
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import kernels
    from sctools_tpu_torch.serve import cli

    print("[worker] " + json.dumps({"launches": dict(kernels.launches)}), flush=True)
    rc = cli.main(["worker", *argv])
    print("[worker] " + json.dumps({"launches": dict(kernels.launches)}), flush=True)
    return rc


def phase_serve(rng, stamp: str, modules) -> None:
    """The serving plane on the card: phase 10's five chunks and six small
    libraries submitted as three tenants' jobs with ``python -m
    sctools_tpu_torch.serve submit``; a victim worker that leases one job a
    tenant and is SIGTERM'd inside its pack, then a worker and its
    replacement, each warmed on phase 5's cell BAM, drain the journal at the
    2^20-record batch width in cross-tenant packs on CUDA graphs. Every
    artifact against its input's solo CalculateCellMetrics CSV, the chunks'
    merge against the one-shot CSV, ``sched status``'s serve view, and one
    full batch's device pass eager against graph replay."""
    import os
    import signal

    import torch

    (port_platform, port_sched, port_launch, port_gatherer, port_device, port_seg, port_graphs, packed,
     bgzf) = modules
    phase_start = time.perf_counter()
    workdir = WORK / "serve"
    journal_dir = workdir / "journal"
    chunks = sorted((WORK / "chunks").glob("chunk*.bam"))
    if len(chunks) != 5:
        raise AssertionError(f"phase 10 left {len(chunks)} chunks, want 5")
    # (tenant, input BAM, output stem) of every job
    jobs = [(tenant, chunks[i], workdir / "out" / f"metrics.part{i:04d}")
            for tenant, indices in SERVE_TENANTS for i in indices]
    begin = time.perf_counter()
    (workdir / "small").mkdir(parents=True)
    for tenant, _ in SERVE_TENANTS:
        for k in range(SERVE_SMALL_JOBS):
            bam = workdir / "small" / f"{tenant}.{k}.bam"
            write_tagged_bam(bam, rng, sort_reads(make_reads(rng, SERVE_SMALL_RECORDS), "cell"), bgzf)
            jobs.append((tenant, bam, workdir / "out" / f"small.{tenant}.{k}"))
    made = time.perf_counter() - begin
    submit = []
    for tenant, bam, stem in jobs:
        submit += ["--job", tenant, str(bam), str(stem)]
    begin = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.serve", "submit", str(journal_dir), *submit],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    if done.returncode != 0 or f"registered {len(jobs)} new job(s)" not in done.stdout:
        raise AssertionError(f"serve submit: rc {done.returncode}\n{done.stdout}{done.stderr}")
    log(f"[serve] python -m sctools_tpu_torch.serve submit: {len(jobs)} jobs of 3 tenants in "
        f"{time.perf_counter() - begin:.2f} s: {', '.join(f'{t} {b.name} {b.stat().st_size / 1e6:.1f} MB' for t, b, _ in jobs)} "
        f"(the small libraries, {SERVE_SMALL_RECORDS} records each, made in {made:.2f} s)")

    def launch(worker_id: str, spec: str, *extra):
        env = {k: v for k, v in os.environ.items() if k != "SCTOOLS_TPU_FAULTS"}
        if spec:
            env["SCTOOLS_TPU_FAULTS"] = spec
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), SERVE_FLAG, str(journal_dir), "--worker-id", worker_id,
             "--lease-ttl", repr(SERVE_TTL), "--poll-interval", "0.1", "--idle-timeout", "120", *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        return proc, time.perf_counter()

    probe = port_sched.Journal(str(journal_dir), worker_id="smoke-probe")
    procs = []
    runs = {}
    try:
        # the victim: one job a tenant (--max-depth 1), held inside the pack
        victim, began = launch("wA", f"delay@task.claimed:secs={SERVE_HOLD},times=1", "--max-depth", "1")
        procs.append(victim)
        deadline = time.perf_counter() + 120
        while not any(st.state == "leased" for st in probe.replay()[1].values()):
            if victim.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"the victim never leased a job: {victim.communicate()[0][-3000:]}")
            time.sleep(0.05)
        tasks, states = probe.replay()
        held = sorted(tasks[tid].name for tid, st in states.items() if st.state == "leased")
        calibration = ("--calibration-bam", str(WORK / "cell_sorted.bam"), "--drain")
        survivor, survivor_began = launch("wB", "", *calibration)
        procs.append(survivor)
        victim.send_signal(signal.SIGTERM)
        victim_out, _ = victim.communicate(timeout=60)
        runs["wA"] = (victim.returncode, victim_out, time.perf_counter() - began)
        replacement, replacement_began = launch("wC", "", *calibration)
        procs.append(replacement)
        for name, proc, start in (("wB", survivor, survivor_began), ("wC", replacement, replacement_began)):
            out, _ = proc.communicate(timeout=600)
            runs[name] = (proc.returncode, out, time.perf_counter() - start)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    serve_wall = time.perf_counter() - survivor_began
    if runs["wA"][0] != -signal.SIGTERM:
        raise AssertionError(f"the victim should die of SIGTERM: rc {runs['wA'][0]}\n{runs['wA'][1][-3000:]}")
    summaries = {}
    for name, (rc, out, wall) in runs.items():
        reports = [json.loads(line[len("[worker] "):]) for line in out.splitlines() if line.startswith("[worker] ")]
        if any(any(r["launches"].values()) for r in reports):
            raise AssertionError(f"worker {name}: hand kernel launches {reports}")
        if name == "wA":
            continue
        if rc != 0 or len(reports) != 2:
            raise AssertionError(f"worker {name}: rc {rc}\n{out[-3000:]}")
        summaries[name] = json.loads(next(line for line in out.splitlines() if line.startswith('{"worker"')))
    log(f"[serve] victim wA leased {held} at --max-depth 1, SIGTERM'd inside its pack "
        f"(delay@task.claimed): exit {runs['wA'][0]} after {runs['wA'][2]:.2f} s; no hand kernel at its start")

    tasks, states = probe.replay()
    events = probe.events()
    probe.close()
    if sorted(st.state for st in states.values()) != ["committed"] * len(jobs):
        raise AssertionError(f"not every job committed: { {tasks[t].name: st.state for t, st in states.items()} }")
    stolen = [e for e in events if e.get("event") == "leased" and e.get("stolen")]
    if not stolen:
        raise AssertionError("no lease was stolen from the victim")
    tenant_of = {tid: task.payload["tenant"] for tid, task in tasks.items()}
    cross = [e for e in events if e.get("event") == "committed"
             and len({tenant_of[t] for t in e["pack_members"]}) > 1]
    packs_run = sum(s["packs_run"] for s in summaries.values())
    if packs_run < 1 or not cross or any(s["packs_degraded"] for s in summaries.values()):
        raise AssertionError(f"packs: {summaries}; {len(cross)} jobs committed in cross-tenant packs")
    for name, summary in summaries.items():
        graphs = summary["graphs"]
        if graphs["keys"] != graphs["captures_warmup"] + graphs["captures_serving"]:
            raise AssertionError(f"worker {name}: a graph key captured twice: {graphs}")
        log(f"[serve] {stamp} | worker {name}: warmup {summary['warmup_s']:.2f} s "
            f"({graphs['captures_warmup']} graphs captured on the calibration BAM), first result "
            f"{summary['first_result_s'] if summary['first_result_s'] is None else round(summary['first_result_s'], 2)} "
            f"s after its start, {summary['jobs_committed']} jobs in {summary['packs_run']} packs "
            f"({summary['packs_degraded']} degraded); graphs: {graphs['captures_serving']} captured while "
            f"serving, {graphs['replays']} replays, {graphs['keys']} keys; exit 0 in {runs[name][2]:.2f} s wall; "
            f"no hand kernel at its start and its end")
    name_of = {tid: tasks[tid].name for tid in tasks}
    commits = [e for e in events if e.get("event") == "committed"]
    for plan in [e for e in events if e.get("event") == "worker" and e.get("pack_plan")]:
        log(f"[serve] pack plan of {plan['worker']}: {[name_of.get(t, t) for t in plan['pack_plan']['tids']]}")
    for commit in sorted(commits, key=lambda e: name_of[e["id"]]):
        log(f"[serve] {name_of[commit['id']]} committed by {commit['worker']}: pack of "
            f"{len(commit['pack_members'])}, {commit['pack_rows']} records by member, bucket "
            f"{commit['pack_bucket']}, audit {commit['audit']}")
    first = min(e["ts"] for e in events if e.get("event") == "leased" and e.get("worker") in summaries)
    last = max(e["ts"] for e in commits)
    records = sum(c["audit"]["records_streamed"] for c in commits)
    log(f"[serve] {stamp} | {len(jobs)} jobs ({records} records) in {last - first:.2f} s from the first lease "
        f"of wB or wC to the last commit = {len(jobs) / (last - first):.3f} jobs/s, "
        f"{records / (last - first):.0f} records/s; {len(cross)} jobs committed in cross-tenant packs; "
        f"{len(stolen)} leases stolen ({sorted(name_of[e['id']] for e in stolen)}); wB and wC started "
        f"{serve_wall:.2f} s before both exited")

    # each artifact against its input's solo CalculateCellMetrics on the card
    for i, (_, bam, stem) in enumerate(jobs):
        solo = workdir / f"solo{i}"
        if port_platform.GenericPlatform.calculate_cell_metrics(["-i", str(bam), "-o", str(solo)]) != 0:
            raise AssertionError(f"CalculateCellMetrics on {bam.name} failed")
        if read_csv(Path(str(stem) + ".csv.gz"))[0] != read_csv(Path(str(solo) + ".csv.gz"))[0]:
            raise AssertionError(f"{stem.name}: the served CSV differs from {bam.name}'s solo CSV")
    # the serve jobs carry no mitochondrial GTF (the JAX payload has none):
    # the one-shot reference is phase 5's command without -a
    one_shot = workdir / "one_shot"
    port_platform.GenericPlatform.calculate_cell_metrics(["-i", str(WORK / "cell_sorted.bam"), "-o", str(one_shot)])
    rows = port_launch.merge_sorted_csv_parts(str(workdir / "out" / "metrics.part*.csv.gz"),
                                              str(workdir / "merged.csv.gz"), expected_parts=5)
    want = read_csv(Path(str(one_shot) + ".csv.gz"))[0]
    if read_csv(workdir / "merged.csv.gz")[0] != want:
        raise AssertionError("the merged served CSVs differ from the one-shot CalculateCellMetrics CSV")
    log(f"[serve] every served CSV equals its input's solo CalculateCellMetrics CSV on the card; the chunks' "
        f"merge_sorted_csv_parts ({rows} rows) equals the one-shot CSV of phase 5's cell BAM byte for byte "
        f"({len(want)} bytes, decompressed)")

    status = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.sched", "status", str(journal_dir)],
                            capture_output=True, text=True, cwd=REPO, timeout=120)
    lines = [line for line in status.stdout.splitlines() if line.startswith("serve ")]
    wanted = ("serve tenant t0:", "serve tenant t1:", "serve tenant t2:", "serve admission wB:",
              "serve steer wB: mode=off", "serve rows: ")
    if status.returncode != 0 or not all(any(line.startswith(w) for line in lines) for w in wanted) \
            or not any(line.startswith("serve rows: ") and line.endswith("— balanced") for line in lines):
        raise AssertionError(f"sched status: rc {status.returncode}\n{status.stdout}{status.stderr}")
    for line in lines:
        log(f"[serve] status: {line}")

    # one full 2^20 batch's device pass, eager against graph replay
    frame = next(packed.iter_frames_from_bam(str(WORK / "cell_sorted.bam"), METRICS_BATCH, want_qname=False))
    cut = int(np.nonzero(frame.cell[1:] != frame.cell[:-1])[0][-1]) + 1
    batch = port_gatherer.slice_frame(frame, 0, cut)
    gatherer = port_gatherer.GatherCellMetrics(str(WORK / "cell_sorted.bam"), str(workdir / "unused"))
    gatherer.start_stream()
    int_names, float_names = port_gatherer.wire_result_names(gatherer.columns)
    k = port_seg.entity_bucket(int(np.count_nonzero(batch.cell[1:] != batch.cell[:-1])) + 1, METRICS_BATCH)
    graph_set = port_graphs.GraphSet("cuda")
    for presorted in (True, False):
        cols, kwargs, decisions = gatherer.pack_batch(batch, pad_to=METRICS_BATCH, presorted=presorted)
        # scx-lint: disable=SCX702 -- each upload is another column (the comprehension's variable), which the model reads as loop-invariant
        staged = {name: to_card(array, "cuda") for name, array in cols.items()}
        passes = {
            "eager": lambda: port_device.compute_entity_metrics(staged, **kwargs),
            "graph": lambda: graph_set.run(staged, **kwargs),
        }
        blocks, times, host = {}, {}, {}
        for name, engine in passes.items():
            def one_batch(engine=engine):
                return port_device.compact_results_wire(engine(), int_names, float_names, k)

            blocks[name] = one_batch().cpu().numpy()
            times[name] = cuda_ms(one_batch, repeats=5)
            torch.cuda.synchronize()
            begin = time.perf_counter()
            for _ in range(5):
                one_batch()
            torch.cuda.synchronize()
            host[name] = (time.perf_counter() - begin) / 5 * 1e3
        if not np.array_equal(blocks["eager"], blocks["graph"]):
            raise AssertionError(f"graph replay's block differs from the eager block (presorted={presorted})")
        log(f"[serve] {stamp} | one full batch ({decisions['records']} records padded to "
            f"{kwargs['num_segments']}, {'presorted, prepacked' if presorted else 'device-sorted, plain'}"
            f"{', run-keyed' if decisions['run_keyed'] else ''}) device pass + compaction: eager "
            f"{times['eager']:.3f} ms, graph replay {times['graph']:.3f} ms (CUDA events, 5 calls queued back "
            f"to back); host wall a call with a sync after 5: eager {host['eager']:.3f} ms, graph "
            f"{host['graph']:.3f} ms; blocks equal byte for byte")
    # its journal (commit events, pack executions and their audit ledgers)
    # stays for the audit phase, which folds it
    shutil.copytree(journal_dir, WORK / SERVE_AUDIT / "journal")
    for path in WORK.iterdir():
        if path.name not in KEPT_FOR_DIST:
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    log(f"[serve] phase 11 took {time.perf_counter() - phase_start:.1f} s")


DIST_FLAG = "--dist-worker"
DIST_PROCESSES = 2
DIST_STEPS = 3  # the step's runs a worker times: the first one cold


def dist_worker(argv) -> int:
    """One process of phase 12, in its own process: joins the group on
    ``cuda:<card>``, runs the chunk queue over ``<work>/chunks`` (rank 0
    merges the parts), then its shard of ``<workdir>/stacked.npz`` through
    ``host_local_to_global`` and ``distributed_metrics_step`` on the global
    mesh, writing its shard's outputs to ``out<p>.npz``. Prints one
    ``[worker] {json}`` line: the transport, the seconds of each stage, the
    step's wall and device milliseconds, the bytes it sent across the
    process boundary and the hand kernel launches at its start and end."""
    workdir, process_id, coordinator, card, gtf = Path(argv[0]), int(argv[1]), argv[2], int(argv[3]), argv[4]
    begin = time.perf_counter()
    sys.path.insert(0, str(REPO))
    import torch

    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import kernels
    from sctools_tpu_torch import parallel as par

    report = {"launches_start": dict(kernels.launches)}
    device = torch.device("cuda", card)
    start = time.perf_counter()
    report["transport"] = par.initialize_distributed(coordinator, DIST_PROCESSES, process_id, device=device,
                                                     timeout=300.0)
    report["init_s"] = time.perf_counter() - start

    start = time.perf_counter()
    chunks = sorted(str(p) for p in (WORK / "chunks").glob("*.bam"))
    committed = par.run_process_cell_metrics(
        chunks, str(workdir / f"proc{process_id}"), DIST_PROCESSES, process_id,
        frozenset(port_gtf.get_mitochondrial_gene_names(gtf)), mesh=par.make_mesh(devices=[device]))
    report["tier1_s"], report["committed"] = time.perf_counter() - start, len(committed)
    par.sync_processes("parts-written")
    if process_id == 0:
        start = time.perf_counter()
        report["rows"] = par.merge_sorted_csv_parts(str(workdir / "metrics.part*.csv.gz"),
                                                    str(workdir / "merged.csv.gz"), expected_parts=len(chunks))
        report["merge_s"] = time.perf_counter() - start

    mesh = par.global_mesh(devices=[device])
    with np.load(workdir / "stacked.npz") as f:
        local = {name: f[name][mesh.local_shards] for name in f.files}
    start = time.perf_counter()
    batch = par.host_local_to_global(local, mesh)
    torch.cuda.synchronize(device)
    report["upload_s"] = time.perf_counter() - start
    report["wall_ms"], report["device_ms"] = [], []
    for _ in range(DIST_STEPS):
        par.collective.crossed.clear()
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            start = time.perf_counter()
            events[0].record()
            cell, gene = par.distributed_metrics_step(batch, mesh)
            events[1].record()
            events[1].synchronize()
        report["wall_ms"].append((time.perf_counter() - start) * 1e3)
        report["device_ms"].append(events[0].elapsed_time(events[1]))
    report["crossed"] = dict(par.collective.crossed)
    out = {}
    for kind, result in (("cell", cell), ("gene", gene)):
        for row, columns in par.addressable_to_host(result).items():
            out.update({f"{kind}/{row}/{name}": value for name, value in columns.items()})
    np.savez(workdir / f"out{process_id}.npz", **out)
    par.sync_processes("outputs-written")
    par.distributed.shutdown()
    report["launches_end"] = dict(kernels.launches)
    report["wall_s"] = time.perf_counter() - begin
    print("[worker] " + json.dumps(report), flush=True)
    return 0


def phase_dist(stamp: str, modules) -> None:
    """Two processes joined into one mesh on the card: the chunk queue under
    the group with a rank-0 merge against phase 5's CSV, then the whole cell
    BAM's cross-process ``distributed_metrics_step`` against the in-process
    card mesh's, bit for bit."""
    import socket

    import torch

    kernels, port_par, port_gatherer, port_gtf, packed = modules
    phase_start = time.perf_counter()
    launches_before = dict(kernels.launches)
    workdir = WORK / "dist"
    workdir.mkdir()
    n_cards = torch.cuda.device_count()
    cards, want_transport = ((0, 1), "nccl") if n_cards >= DIST_PROCESSES else ((0, 0), "gloo")
    mito = str(WORK / "mito.gtf")
    start = time.perf_counter()
    frames = packed.iter_frames_from_bam(str(WORK / "cell_sorted.bam"), 2 * METRICS_BATCH, want_qname=False)
    frame = next(frames)
    frames.close()
    if frame.n_records != CELL_RECORDS:
        raise AssertionError(f"one frame of the cell BAM holds {frame.n_records} records, want {CELL_RECORDS}")
    names = port_gtf.get_mitochondrial_gene_names(mito)
    is_mito = np.asarray([name in names for name in frame.gene_names], dtype=bool)
    cols = port_gatherer._pad_columns(frame, is_mito)[0]
    stacked = port_par.partition_columns(cols, DIST_PROCESSES, key="cell", shard_size=METRICS_BATCH)
    np.savez(workdir / "stacked.npz", **stacked)
    log(f"[dist] phase 5's cell BAM ({frame.n_records} records) partitioned by cell into {DIST_PROCESSES} shards "
        f"of {METRICS_BATCH} ({', '.join(str(int(v.sum())) for v in stacked['valid'])} valid) in "
        f"{time.perf_counter() - start:.2f} s")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    begin = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), DIST_FLAG, str(workdir), str(p), coordinator, str(card), mito],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for p, card in enumerate(cards)]
    try:
        outputs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    workers_s = time.perf_counter() - begin
    reports = []
    for p, (proc, out) in enumerate(zip(procs, outputs)):
        lines = [line for line in out.splitlines() if line.startswith("[worker] ")]
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"dist worker {p}: rc {proc.returncode}\n{out[-4000:]}")
        reports.append(json.loads(lines[0][len("[worker] "):]))
    for p, report in enumerate(reports):
        if report["transport"] != want_transport:
            raise AssertionError(f"worker {p} took {report['transport']}, want {want_transport} on {n_cards} card(s)")
        if any(report["launches_start"].values()) or any(report["launches_end"].values()):
            raise AssertionError(f"worker {p}: hand kernel launches {report['launches_start']} -> "
                                 f"{report['launches_end']}")
    if read_csv(workdir / "merged.csv.gz")[0] != read_csv(WORK / "cli_cell.csv.gz")[0]:
        raise AssertionError("tier 1: the rank-0 merge differs from phase 5's CalculateCellMetrics CSV")
    log(f"[dist] {stamp} | {DIST_PROCESSES} workers on {['cuda:%d' % c for c in cards]} over {want_transport} "
        f"({n_cards} card(s)) in {workers_s:.2f} s; tier 1: "
        + "; ".join(f"worker {p} init {r['init_s']:.2f} s, {r['committed']} chunks in {r['tier1_s']:.2f} s"
                    for p, r in enumerate(reports))
        + f"; rank 0 merged {reports[0]['rows']} rows in {reports[0]['merge_s']:.2f} s, equal to phase 5's "
        f"CalculateCellMetrics CSV byte for byte (decompressed)")

    card = torch.device("cuda", 0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    want = [port_par.stack_to_host(result) for result in
            port_par.distributed_metrics_step(stacked, port_par.make_mesh(devices=[card, card]))]
    reference_s = time.perf_counter() - start
    for p in range(DIST_PROCESSES):
        with np.load(workdir / f"out{p}.npz") as got:
            for kind, result in zip(("cell", "gene"), want):
                same_sharded(f"worker {p} {kind}", {name: got[f"{kind}/{p}/{name}"] for name in result},
                             {name: value[p] for name, value in result.items()})
    for p, r in enumerate(reports):
        log(f"[dist] {stamp} | worker {p} on cuda:{cards[p]}: distributed_metrics_step on the global mesh, "
            f"{METRICS_BATCH} records a shard: wall {', '.join(f'{t:.3f}' for t in r['wall_ms'])} ms, device "
            f"(CUDA events) {', '.join(f'{t:.3f}' for t in r['device_ms'])} ms ({DIST_STEPS} runs, the first "
            f"cold); bytes sent across the process boundary a step: {r['crossed']}; upload {r['upload_s']:.2f} s; "
            f"hand kernel launches 0 at its start and its end; {r['wall_s']:.2f} s in all")
    log(f"[dist] every per-shard cell and gene output equals the in-process [cuda:0, cuda:0] step's bit for bit "
        f"(that step {reference_s:.2f} s with its pull)")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the dist phase: {kernels.launches}")
    for path in WORK.iterdir():
        if path.name not in KEPT_FOR_ANALYSIS:
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    log(f"[dist] phase 12 took {time.perf_counter() - phase_start:.1f} s")


# phase 10's chunks, phase 5's GTF and one-shot CSV: the witnessed sched
# worker's inputs and its reference
KEPT_FOR_ANALYSIS = ("mito.gtf", "cli_cell.csv.gz", "chunks", *KEPT_FOR_TRACING)
ANALYSIS_FLAG = "--analysis-worker"
ANALYSIS_READS = 2 * BATCH  # the witnessed attach: two kernel batches
# the witness's and the frame witness's variables, set on the witnessed
# worker only
WITNESS_VARS = ("SCTOOLS_TPU_LOCK_DEBUG", "SCTOOLS_TPU_LOCK_GRAPH", "SCTOOLS_TPU_FRAME_DEBUG",
                "SCTOOLS_TPU_TRACE", "SCTOOLS_TPU_TRACE_WORKER", "SCTOOLS_TPU_PULSE")


def analysis_worker(argv) -> int:
    """One worker of phase 13, in its own process, witnessed or not as its
    environment says: attach -w on ``<workdir>``'s inputs into
    ``<workdir>/<tag>.bam``, then one sched worker draining
    ``<work>/chunks`` into ``<workdir>/<tag>/``, on cuda. Prints one
    ``[worker] {json}`` line: each stage's seconds and the hand kernel
    launches, each counted from 0 at the stage's start. A witnessed worker
    leaves its lock and frame witnesses' dumps in its trace directory at
    exit."""
    workdir, tag = Path(argv[0]), argv[1]
    import torch

    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import kernels
    from sctools_tpu_torch import platform as port_platform
    from sctools_tpu_torch.analysis import witness
    from sctools_tpu_torch.ingest import framedebug
    from sctools_tpu_torch.parallel import launch

    report = {"witness": witness.enabled(), "frame_debug": framedebug.enabled()}
    kernels.reset_launches()  # this slice's path: the witnessed attach
    start = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rc = port_platform.TenXV2.attach_barcodes(attach_args(workdir, workdir / f"{tag}.bam"))
    torch.cuda.synchronize()
    report["attach"] = {"rc": rc, "seconds": time.perf_counter() - start, "launches": dict(kernels.launches)}
    kernels.reset_launches()
    start = time.perf_counter()
    committed = launch.run_process_cell_metrics(
        sorted(str(p) for p in (WORK / "chunks").glob("*.bam")), str(workdir / tag / "proc0"), 1, 0,
        frozenset(port_gtf.get_mitochondrial_gene_names(str(WORK / "mito.gtf"))), lease_ttl=SCHED_TTL,
        backoff_base=0.1,
    )
    torch.cuda.synchronize()
    report["sched"] = {"committed": len(committed), "seconds": time.perf_counter() - start,
                       "launches": dict(kernels.launches)}
    print("[worker] " + json.dumps(report), flush=True)
    return 0


def phase_analysis(rng, whitelist_ascii, stamp: str, modules) -> int:
    """The port's static checks on this machine, then attach and a sched
    worker under the runtime lock witness and the frame witness, each
    against the same run unwitnessed; every lock dump against the static
    lock graph. Returns the witnessed attach's kernel launches."""
    import os

    kernels, port_launch, bgzf = modules
    phase_start = time.perf_counter()
    workdir = WORK / "analysis"
    trace = workdir / "trace"
    trace.mkdir(parents=True)
    graph_path = workdir / "lock-graph.json"
    env = {k: v for k, v in os.environ.items() if k not in WITNESS_VARS}
    env["SCTOOLS_TPU_SCX_CACHE"] = "0"  # no parse store left in the checkout

    # (a) the passes, as a user runs them
    start = time.perf_counter()
    # its five passes: phase 19 runs the gate with every pass
    gate = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "sctools_tpu_torch", "chip_smoke.py",
                           "--json", "--no-shard", "--no-cost", "--no-mesh", "--no-aot"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    passes_s = time.perf_counter() - start
    if gate.returncode != 0:
        raise AssertionError(f"the static checks: rc {gate.returncode}\n{gate.stdout[-4000:]}{gate.stderr[-2000:]}")
    result = json.loads(gate.stdout)
    if result["findings"]:
        raise AssertionError(f"the static checks found {result['findings']}")
    start = time.perf_counter()
    emitted = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "--emit-lock-graph",
                              str(graph_path), "sctools_tpu_torch"],
                             cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    graph_s = time.perf_counter() - start
    if emitted.returncode != 0:
        raise AssertionError(f"--emit-lock-graph: rc {emitted.returncode}\n{emitted.stdout}{emitted.stderr}")
    graph = json.loads(graph_path.read_text())
    if len(graph["locks"]) != 17 or not {"obs.xprof", "obs.audit", "ingest.ring_state", *GUARD_LOCKS} <= \
            set(graph["locks"]):
        raise AssertionError(f"the static lock graph names {sorted(graph['locks'])}, want seventeen with obs.xprof, "
                             f"obs.audit, ingest.ring_state and {GUARD_LOCKS}")
    static_edges = {(e["from"], e["to"]) for e in graph["edges"]}
    log(f"[analysis] {stamp} | python -m sctools_tpu_torch.analysis sctools_tpu_torch chip_smoke.py --json "
        f"--no-shard --no-cost --no-mesh --no-aot: "
        f"exit 0, {len(result['findings'])} findings over {result['checked_files']} files in {passes_s:.2f} s "
        f"(lint with SCX113/SCX114, abi, supp, race, life; no parse store); --emit-lock-graph in {graph_s:.2f} s: "
        f"{len(graph['locks'])} locks {sorted(graph['locks'])}, {len(graph['edges'])} order edges, "
        f"{len(graph['entries'])} entries {[e['site'] for e in graph['entries']]}")

    # (b) + (c) the workers, unwitnessed then witnessed
    start = time.perf_counter()
    write_attach_inputs(rng, whitelist_ascii, ANALYSIS_READS, bgzf, workdir)
    log(f"[analysis] attach inputs: {ANALYSIS_READS} reads, whitelist {whitelist_ascii.shape[0]} x {CB_LEN}, "
        f"made in {time.perf_counter() - start:.1f} s")
    # tracing and pulse on, so the obs locks are taken too
    witnessed_env = dict(env, SCTOOLS_TPU_LOCK_DEBUG="1", SCTOOLS_TPU_LOCK_GRAPH=str(graph_path),
                         SCTOOLS_TPU_FRAME_DEBUG="1", SCTOOLS_TPU_TRACE=str(trace),
                         SCTOOLS_TPU_TRACE_WORKER="witnessed", SCTOOLS_TPU_PULSE="1")
    reports, walls = {}, {}
    for tag, worker_env in (("plain", env), ("witnessed", witnessed_env)):
        begin = time.perf_counter()
        proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), ANALYSIS_FLAG, str(workdir), tag],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=worker_env)
        try:
            out = proc.communicate(timeout=600)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        walls[tag] = time.perf_counter() - begin
        lines = [line for line in out.splitlines() if line.startswith("[worker] ")]
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"{tag} worker: rc {proc.returncode}\n{out[-4000:]}")
        reports[tag] = json.loads(lines[0][len("[worker] "):])
    batches = -(-ANALYSIS_READS // BATCH)
    n_chunks = len(list((WORK / "chunks").glob("*.bam")))
    for tag, report in reports.items():
        if report["witness"] != (tag == "witnessed") or report["frame_debug"] != (tag == "witnessed"):
            raise AssertionError(f"{tag} worker: witness {report['witness']}, frame witness {report['frame_debug']}")
        if report["attach"]["rc"] != 0 or report["attach"]["launches"] != {"whitelist_correct": batches}:
            raise AssertionError(f"{tag} attach: rc {report['attach']['rc']}, launches {report['attach']['launches']}, "
                                 f"want {batches} (one a batch)")
        if any(report["sched"]["launches"].values()):
            raise AssertionError(f"{tag} sched worker launched a hand kernel: {report['sched']['launches']}")
        if report["sched"]["committed"] != n_chunks:
            raise AssertionError(f"{tag} sched worker committed {report['sched']['committed']} of {n_chunks} chunks")
        merged = workdir / tag / "merged.csv.gz"
        port_launch.merge_sorted_csv_parts(str(workdir / tag / "metrics.part*.csv.gz"), str(merged),
                                           journal_dir=str(workdir / tag / "sched-journal"), expected_parts=n_chunks)
        if read_csv(merged)[0] != read_csv(WORK / "cli_cell.csv.gz")[0]:
            raise AssertionError(f"{tag} sched worker: the merged CSV differs from phase 5's CalculateCellMetrics CSV")
    if (workdir / "witnessed.bam").read_bytes() != (workdir / "plain.bam").read_bytes():
        raise AssertionError("the witnessed attach's BAM differs from the unwitnessed one's")
    witnessed = reports["witnessed"]

    # (d) the dumps: the witnessed worker's, at its exit, named by the obs
    # context's worker (the sched worker's journal id, which it set)
    frame_dumps = sorted(trace.glob("frames.*.json"))
    if len(frame_dumps) != 1 or not frame_dumps[0].name.startswith("frames.proc0-of-1-"):
        raise AssertionError(f"frame witness dumps: {[path.name for path in frame_dumps]}")
    frames = json.loads(frame_dumps[0].read_text())
    if not frames["enabled"] or not frames["stamped"] or frames["violations"]:
        raise AssertionError(f"frame witness dump: enabled {frames['enabled']}, {frames['stamped']} frames "
                             f"stamped, violations {frames['violations']}")
    dumps = sorted(trace.glob("locks.*.json"))
    if len(dumps) != 1 or not dumps[0].name.startswith("locks.proc0-of-1-"):
        raise AssertionError(f"lock dumps: {[path.name for path in dumps]}")
    dump = json.loads(dumps[0].read_text())
    if not dump["enabled"] or dump["violations"] or dump["static_graph"] != str(graph_path):
        raise AssertionError(f"lock dump: enabled {dump['enabled']}, static graph {dump['static_graph']}, "
                             f"violations {dump['violations']}")
    blocking = {(e["from"], e["to"]) for e in dump["edges"] if not e["bounded"]}
    if not blocking <= static_edges:
        raise AssertionError(f"observed edges {sorted(blocking - static_edges)} are not in the static graph")
    # the strike count's and the deadline's locks are taken on a fault path
    # only: phase 18's fault cocktail takes them under the witness
    missing = set(graph["locks"]) - set(dump["acquires"]) - GUARD_FAULT_LOCKS
    if missing:
        raise AssertionError(f"locks never acquired under the witness: {sorted(missing)}")
    log(f"[analysis] {stamp} | witnessed worker (SCTOOLS_TPU_LOCK_DEBUG=1 with the static graph, "
        f"SCTOOLS_TPU_FRAME_DEBUG=1): attach of {ANALYSIS_READS} reads {witnessed['attach']['seconds']:.2f} s "
        f"(unwitnessed {reports['plain']['attach']['seconds']:.2f} s), {witnessed['attach']['launches']} "
        f"launches = {batches} batches, BAM equal to the unwitnessed one's byte for byte; one sched worker "
        f"drained {witnessed['sched']['committed']} chunks in {witnessed['sched']['seconds']:.2f} s (unwitnessed "
        f"{reports['plain']['sched']['seconds']:.2f} s), merged CSV equal to phase 5's byte for byte "
        f"(decompressed), both runs; process walls: unwitnessed {walls['plain']:.2f} s, then witnessed "
        f"{walls['witnessed']:.2f} s")
    edges = [(e["from"], e["to"], "bounded" if e["bounded"] else "blocking") for e in dump["edges"]]
    log(f"[analysis] {stamp} | {dumps[0].name}: 0 violations; acquisitions {dict(sorted(dump['acquires'].items()))}; "
        f"observed edges {edges or 'none'} (every blocking one in the static graph); {frame_dumps[0].name}: "
        f"{frames['stamped']} frames stamped, 0 stale reads")
    # the attach inputs stay for phase 14
    for path in workdir.iterdir():
        if path.name not in ("r1.fastq.gz", "i1.fastq.gz", "u2.bam", "whitelist.txt"):
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    log(f"[analysis] phase 13 took {time.perf_counter() - phase_start:.1f} s")
    return witnessed["attach"]["launches"]["whitelist_correct"]


TRACE_FLAG = "--trace-worker"
TRACE_STEPS = ("attach", "cell", "count", "serve")
# the observability variables: set on the traced workers only
TRACE_VARS = ("SCTOOLS_TPU_TRACE", "SCTOOLS_TPU_TRACE_WORKER", "SCTOOLS_TPU_PULSE", "SCTOOLS_TPU_PULSE_CAPACITY",
              "SCTOOLS_TPU_PULSE_HTTP", "SCTOOLS_TPU_OBS", "SCTOOLS_TPU_SLO")
TRACE_SMALL_RECORDS = 30_000  # the serve step's small library: it joins a chunk's pack
TRACE_OVERHEAD_N = 20_000  # spans and heartbeats the overhead step times
# one Prometheus exposition line: a TYPE comment or a sample
PROM_LINE = re.compile(r"^(# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge)|"
                       r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\"\})? -?[0-9.e+\-]+|"
                       r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\"\})? (nan|inf))$")


def trace_jobs(base: Path):
    """The serve step's three jobs: (tenant, input BAM, output stem)."""
    chunks = sorted((WORK / "chunks").glob("chunk*.bam"))
    return [("t0", chunks[0], base / "out" / "chunk0"), ("t1", WORK / "tracing" / "small.bam", base / "out" / "small"),
            ("t2", chunks[1], base / "out" / "chunk1")]


def measure_overhead(obs, pulse) -> dict:
    """What one span (with its sink line), one heartbeat (with its ring
    record), one ``xprof.record_dispatch`` and one ``xprof.record_transfer``
    cost on this host, in microseconds: the no-op paths when this process
    records nothing."""
    from sctools_tpu_torch.obs import xprof

    begin = time.perf_counter()
    for _ in range(TRACE_OVERHEAD_N):
        xprof.record_dispatch("smoke.overhead", 1, 2)
    dispatch_us = (time.perf_counter() - begin) / TRACE_OVERHEAD_N * 1e6
    begin = time.perf_counter()
    for _ in range(TRACE_OVERHEAD_N):
        xprof.record_transfer("h2d", 4, site="smoke.overhead")
    transfer_us = (time.perf_counter() - begin) / TRACE_OVERHEAD_N * 1e6
    begin = time.perf_counter()
    for _ in range(TRACE_OVERHEAD_N):
        with obs.span("overhead", records=1):
            pass
    span_us = (time.perf_counter() - begin) / TRACE_OVERHEAD_N * 1e6
    begin = time.perf_counter()
    for _ in range(TRACE_OVERHEAD_N):
        beat = pulse.heartbeat("bench.pulse")
        beat.begin("compute")
        beat.end("compute")
        beat.add(real_rows=1, padded_rows=1)
        beat.emit()
    return {"span_us": span_us, "heartbeat_us": (time.perf_counter() - begin) / TRACE_OVERHEAD_N * 1e6,
            "dispatch_us": dispatch_us, "transfer_us": transfer_us}


def trace_worker(argv) -> int:
    """One of phase 14's workers, in its own process, traced or not as its
    environment says: each step of ``argv[2:]`` on cuda into
    ``<argv[0]>/<step>/`` (``argv[1]`` names the worker). Prints one ``[worker] {json}`` line: per step
    its seconds (after the CUDA context is up), its hand kernel launches
    (counted from 0 at the step's start) and its batches."""
    base, steps = Path(argv[0]), argv[2:]
    import torch

    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import kernels, obs
    from sctools_tpu_torch import platform as port_platform
    from sctools_tpu_torch.obs import pulse
    from sctools_tpu_torch.serve import cli as serve_cli
    from sctools_tpu_torch.serve.api import ServeJob

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    report = {"obs": obs.enabled(), "pulse": pulse.enabled(), "steps": {}}
    for step in steps:
        out = base / step
        out.mkdir(parents=True, exist_ok=True)
        made, info = [], {}
        kernels.reset_launches()  # a main path's run starts here
        start = time.perf_counter()
        if step == "attach":
            info["rc"] = port_platform.TenXV2.attach_barcodes(attach_args(WORK / "analysis", out / "attach.bam"))
        elif step == "cell":
            with recording(port_platform, "GatherCellMetrics", made):
                info["rc"] = port_platform.GenericPlatform.calculate_cell_metrics(
                    ["-i", str(WORK / "cell_sorted.bam"), "-o", str(out / "cell"), "-a", str(WORK / "mito.gtf")])
        elif step == "count":
            with recording(port_platform, "CountMatrix", made):
                info["rc"] = port_platform.GenericPlatform.bam_to_count_matrix(
                    ["-b", str(WORK / "count.bam"), "-a", str(WORK / "genes.gtf"), "-o", str(out / "count")])
        elif step == "overhead":
            info.update(measure_overhead(obs, pulse), rc=0)
        else:
            journal = out / "sched-journal"
            serve_cli.submit_jobs(str(journal), [ServeJob(t, str(bam), str(stem)) for t, bam, stem in
                                                 trace_jobs(out)])
            summary = io.StringIO()
            info["rc"] = serve_cli.main(["worker", str(journal), "--calibration-bam",
                                         str(WORK / "tracing" / "small.bam"), "--drain", "--worker-id",
                                         f"{argv[1]}-serve", "--poll-interval", "0.05"], out=summary)
            info["summary"] = json.loads(summary.getvalue().strip().splitlines()[-1])
        torch.cuda.synchronize()
        info["seconds"] = time.perf_counter() - start
        info["launches"] = dict(kernels.launches)  # ... and ends here
        if made:
            info["batches"] = len(made[0].batches)
        report["steps"][step] = info
    print("[worker] " + json.dumps(report), flush=True)
    return 0


def run_trace_worker(base: Path, tag: str, steps, env) -> dict:
    proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), TRACE_FLAG, str(base), tag, *steps],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=WORK)
    try:
        out = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [line for line in out.splitlines() if line.startswith("[worker] ")]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"trace worker {tag} {steps}: rc {proc.returncode}\n{out[-4000:]}")
    report = json.loads(lines[0][len("[worker] "):])
    for step, info in report["steps"].items():
        if info["rc"] != 0:
            raise AssertionError(f"trace worker {tag} {step}: rc {info['rc']}\n{out[-4000:]}")
    return report


def bam_records(path: Path) -> int:
    """The alignment records of a BAM, counted by the port's native decoder."""
    from sctools_tpu_torch import native

    return sum(frame.n_records for frame in native.stream_frames(str(path), 1 << 20))


def phase_tracing(rng, stamp: str, modules) -> int:
    """The port's observability layer on the card: attach -w, the cell
    metrics and the count at their full batch widths, and one serve worker,
    each run untraced and then traced (``SCTOOLS_TPU_TRACE``,
    ``SCTOOLS_TPU_PULSE=1``, a worker name of its own), each run in a
    worker process of its own. Outputs against the untraced ones, the captures against the
    inputs and the batches, the capture CLI on them. Returns the attach
    steps' kernel launches."""
    import os

    kernels, bgzf, port_obs, port_pulse, port_delta, port_slo = modules
    phase_start = time.perf_counter()
    root = WORK / "tracing"
    root.mkdir()
    write_tagged_bam(root / "small.bam", rng, sort_reads(make_reads(rng, TRACE_SMALL_RECORDS), "cell"), bgzf)
    plain_env = {k: v for k, v in os.environ.items() if k not in TRACE_VARS and k not in WITNESS_VARS}
    plain, traced = root / "plain", root / "traced"
    # the untraced steps in one process, in turn; each traced step in a
    # process of its own, under its own capture directory and worker name
    plain_run = run_trace_worker(plain, "plain", TRACE_STEPS, plain_env)
    steps = {}
    for step in TRACE_STEPS:
        traced_env = dict(plain_env, SCTOOLS_TPU_TRACE=str(traced / step), SCTOOLS_TPU_PULSE="1",
                          SCTOOLS_TPU_TRACE_WORKER=f"traced-{step}", SCTOOLS_TPU_SLO="1")
        pair = (plain_run, run_trace_worker(traced, f"traced-{step}", [step], traced_env))
        if (pair[0]["obs"], pair[0]["pulse"], pair[1]["obs"], pair[1]["pulse"]) != (False, False, True, True):
            raise AssertionError(f"{step}: obs and pulse untraced {pair[0]['obs']} {pair[0]['pulse']}, traced "
                                 f"{pair[1]['obs']} {pair[1]['pulse']}")
        steps[step] = tuple(report["steps"][step] for report in pair)
    # one span and one heartbeat: traced in a worker of their own, off here
    # (this process records nothing)
    if port_obs.enabled() or port_pulse.enabled():
        raise AssertionError("the smoke's own process records: unset SCTOOLS_TPU_TRACE / SCTOOLS_TPU_PULSE")
    overhead_env = dict(plain_env, SCTOOLS_TPU_TRACE=str(traced / "overhead"), SCTOOLS_TPU_PULSE="1",
                        SCTOOLS_TPU_TRACE_WORKER="traced-overhead")
    steps["overhead"] = (measure_overhead(port_obs, port_pulse),
                         run_trace_worker(traced, "traced-overhead", ["overhead"], overhead_env)["steps"]["overhead"])

    # outputs: the traced runs' equal the untraced ones'
    if (traced / "attach" / "attach.bam").read_bytes() != (plain / "attach" / "attach.bam").read_bytes():
        raise AssertionError("the traced attach's BAM differs from the untraced one's")
    if read_csv(traced / "cell" / "cell.csv.gz")[0] != read_csv(plain / "cell" / "cell.csv.gz")[0]:
        raise AssertionError("the traced CalculateCellMetrics CSV differs from the untraced one")
    if not same_files(traced / "count" / "count", plain / "count" / "count"):
        raise AssertionError("the traced CreateCountMatrix arrays differ from the untraced ones")
    for _, _, stem in trace_jobs(traced / "serve"):
        twin = plain / "serve" / stem.relative_to(traced / "serve")
        if read_csv(Path(f"{stem}.csv.gz"))[0] != read_csv(Path(f"{twin}.csv.gz"))[0]:
            raise AssertionError(f"the traced serve worker's {stem.name} CSV differs from the untraced one")

    # kernel launches: one a 65,536-read batch of attach, none elsewhere
    batches = -(-ANALYSIS_READS // BATCH)
    for step in TRACE_STEPS:
        want = {"whitelist_correct": batches} if step == "attach" else {}
        for tag, info in zip(("untraced", "traced"), steps[step]):
            if {k: v for k, v in info["launches"].items() if v} != want:
                raise AssertionError(f"{tag} {step}: launches {info['launches']}, want {want}")

    # the captures
    inputs = {"cell": bam_records(WORK / "cell_sorted.bam"), "count": bam_records(WORK / "count.bam")}
    jobs = trace_jobs(traced / "serve")
    small = bam_records(root / "small.bam")
    job_records = {stem.name: bam_records(bam) for _, bam, stem in jobs}
    serve = steps["serve"][1]["summary"]
    ledger = {}  # per step: spans, records per span name, heartbeats
    for step in TRACE_STEPS:
        run_dir = traced / step
        worker = f"traced-{step}"
        spans = []
        for line in (run_dir / f"trace.{worker}.jsonl").read_text().splitlines():
            record = json.loads(line)  # every line parses
            if "meta" not in record:
                spans.append(record)
        records = collections.Counter()
        for span in spans:
            records[span["name"]] += (span.get("attrs") or {}).get("records", 0)
        prom = (run_dir / f"metrics.{worker}.prom").read_text().splitlines()
        bad = [line for line in prom if not PROM_LINE.match(line)]
        if bad or not prom:
            raise AssertionError(f"{step}: metrics.{worker}.prom is not Prometheus exposition: {bad[:5]}")
        rings = port_pulse.load_rings(str(run_dir))
        beats = [r for ring in rings.values() for r in ring["records"]]
        if any(ring["torn"] for ring in rings.values()):
            raise AssertionError(f"{step}: torn ring records")
        for name, ring in rings.items():
            profile = port_delta.profile_from_records(ring["records"])
            legs = sum(row["exposed_s"] for row in profile["legs"].values())
            if abs(legs - profile["wall_s"]) > 1e-6:
                raise AssertionError(f"{step} ring {name}: legs sum to {legs} s, wall {profile['wall_s']} s")
        ledger[step] = (collections.Counter(s["name"] for s in spans), records, beats, rings)
    spans, records, beats, rings = ledger["cell"]
    for name in ("decode", "upload", "compute", "writeback"):
        if records[name] != inputs["cell"]:
            raise AssertionError(f"cell: the {name} spans hold {records[name]} records, the BAM {inputs['cell']}")
    if len(beats) != steps["cell"][1]["batches"] or spans["upload"] != len(beats):
        raise AssertionError(f"cell: {len(beats)} heartbeats, {steps['cell'][1]['batches']} batches")
    spans, records, beats, rings = ledger["count"]
    if records["decode"] != inputs["count"]:
        raise AssertionError(f"count: the decode spans hold {records['decode']} records, the BAM {inputs['count']}")
    if len(beats) != steps["count"][1]["batches"] or {b["stage"] for b in beats} != {"count"}:
        raise AssertionError(f"count: {len(beats)} heartbeats, {steps['count'][1]['batches']} batches")
    spans, records, beats, rings = ledger["serve"]
    streamed = small + sum(job_records.values())  # the calibration run, then the jobs
    packed = [e for e in port_slo.load_journal(str(traced / "serve" / "sched-journal"))[1]
              if e.get("event") == "committed"]
    members = {tuple(e["pack_members"]) for e in packed}
    pairs = [m for m in members if len(m) > 1]
    stem_of = {f"{stem}.csv.gz": stem.name for _, _, stem in jobs}
    twice = sum(job_records[stem_of[e["part"]]] for e in packed if len(e["pack_members"]) > 1)
    for name in ("upload", "compute", "writeback"):
        if records[name] != streamed:
            raise AssertionError(f"serve: the {name} spans hold {records[name]} records, want {streamed}")
    # a packed member is decoded by its own ring and again by the pack's
    if records["decode"] != streamed + twice:
        raise AssertionError(f"serve: the decode spans hold {records['decode']} records, want {streamed + twice}")
    if len(beats) != spans["upload"] or len(packed) != 3 or len(pairs) != 1 or serve["packs_run"] != 2:
        raise AssertionError(f"serve: {len(beats)} heartbeats for {spans['upload']} batches, {len(packed)} commits, "
                             f"packs {members}, summary {serve}")
    if {b["task_id"] for b in beats} != {"warmup", *(e["pack"] for e in packed)}:
        raise AssertionError(f"serve: heartbeat exec ids {sorted({b['task_id'] for b in beats})}")
    profile = json.loads(Path(serve["profile"]).read_text())
    if not profile["complete"] or port_delta.validate_profile(profile):
        raise AssertionError(f"serve: the worker's profile {serve['profile']}: complete {profile['complete']}, "
                             f"{port_delta.validate_profile(profile)}")
    view = port_slo.stitch_run(str(traced / "serve"))
    if view["fleet"]["committed"] != 3 or view["fleet"]["unattributed_device_s"] != 0 or \
            view["fleet"]["complete_fraction"] != 1:
        raise AssertionError(f"serve: slo fleet {view['fleet']}")

    # the capture CLI, as a user runs it; delta on two profile files (a run
    # dir operand would make the CLI import torch for this host's platform)
    cell_profile = port_delta.write_profile(
        port_delta.profile_from_run_dir(str(traced / "cell"), platform=profile["platform"]),
        str(traced / "cell" / "profile.traced-cell.json"))
    cli_runs = {}
    for name, args in (("summarize", [str(traced / "*" / "trace.*.jsonl")]), ("pulse", [str(traced)]),
                       ("slo", [str(traced / "serve")]), ("delta", [cell_profile, serve["profile"]])):
        begin = time.perf_counter()
        done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.obs", name, *args], cwd=REPO,
                              env=plain_env, capture_output=True, text=True, timeout=120)
        cli_runs[name] = time.perf_counter() - begin
        if done.returncode != 0:
            raise AssertionError(f"python -m sctools_tpu_torch.obs {name}: rc {done.returncode}\n"
                                 f"{done.stdout[-3000:]}{done.stderr[-2000:]}")
        if name == "summarize":
            summary_table = done.stdout

    # what it shows
    off, on = steps["overhead"]
    log(f"[tracing] {stamp} | one span {on['span_us']:.2f} us traced ({off['span_us']:.3f} us off), one heartbeat "
        f"{on['heartbeat_us']:.2f} us ({off['heartbeat_us']:.3f} us off), {TRACE_OVERHEAD_N} of each on this host")
    for step in TRACE_STEPS:
        untraced, traced_info = steps[step]
        n_spans, n_beats = sum(ledger[step][0].values()), len(ledger[step][2])
        cost_ms = (n_spans * on["span_us"] + n_beats * on["heartbeat_us"]) / 1e3
        log(f"[tracing] {stamp} | {step}: untraced {untraced['seconds']:.3f} s (the untraced steps share one "
            f"process), traced {traced_info['seconds']:.3f} s (a fresh process); {n_spans} spans and {n_beats} "
            f"heartbeats, at the rates above {cost_ms:.3f} ms; launches {traced_info['launches'] or 0}")
    by_stage = collections.defaultdict(list)
    for step in TRACE_STEPS:
        for beat in ledger[step][2]:
            by_stage[beat["stage"]].append(beat)
    for stage, beats in sorted(by_stage.items()):
        bubble = port_pulse.attribute_bubbles(beats)
        log(f"[tracing] {stamp} | stage {stage}: {len(beats)} heartbeats, bubble_fraction "
            f"{bubble['bubble_fraction']}, limiting_stage {bubble['limiting_stage']}, busy_s {bubble['busy_s']}, "
            f"exposed_s {bubble['exposed_s']}")
    log(f"[tracing] outputs of the traced runs equal the untraced ones (attach BAM bytes, cell CSV and serve "
        f"CSVs decompressed, count arrays); trace lines parse; decode/upload/compute/writeback records equal the "
        f"inputs' ({inputs['cell']} cell, {inputs['count']} count, {streamed} served); metrics.*.prom valid; rings "
        f"parse untorn, legs + overlap + idle = wall for every worker; heartbeats = batches; serve profile "
        f"{Path(serve['profile']).name} complete and schema-valid, slo trace 100% complete, 0 s unattributed")
    log(f"[tracing] python -m sctools_tpu_torch.obs summarize / pulse / slo / delta: exit 0 each, "
        f"{', '.join(f'{k} {v:.2f} s' for k, v in cli_runs.items())}")
    for line in summary_table.splitlines()[:14]:
        log(f"[tracing]   {line}")
    log(f"[tracing] phase 14 took {time.perf_counter() - phase_start:.1f} s")
    # its inputs and traced runs stay for phase 15
    launches = sum(pair[i]["launches"].get("whitelist_correct", 0) for pair in (steps["attach"],) for i in (0, 1))
    return launches, {**{step: steps[step][1] for step in TRACE_STEPS}, "overhead": steps["overhead"]}


EFFICIENCY_ROOT = "efficiency"
EFFICIENCY_STEPS = ("attach", "count", "serve")  # phase 14's traced runs, read here


def efficiency_env(base_env: dict, run_dir: Path, worker: str) -> dict:
    """A traced worker's variables: its captures go in ``run_dir``, beside
    the journal, where ``obs timeline`` and ``sched status`` look."""
    return dict(base_env, SCTOOLS_TPU_TRACE=str(run_dir), SCTOOLS_TPU_PULSE="1",
                SCTOOLS_TPU_TRACE_WORKER=worker)


def efficiency_sched(run_dir: Path, base_env: dict, crash: bool, port_sched) -> dict:
    """Two traced sched workers (phase 10's ``--sched-worker``) over phase
    10's five chunks into ``run_dir``, each claim delayed by
    ``SCHED_STRAGGLE`` so that both take chunks. With ``crash``, A dies at
    its first batch of chunk0000 (exit 86) once it holds the lease, and B
    steals it. Returns each worker's (exit code, output, journal id)."""
    run_dir.mkdir(parents=True)
    (run_dir / "chunks").symlink_to(WORK / "chunks")
    delay = f"delay@task.claimed:secs={SCHED_STRAGGLE}"
    specs = {"A": f"crash@gatherer.batch:match=chunk0000,times=1;{delay}" if crash else delay, "B": delay}
    journal_dir = run_dir / "sched-journal"
    procs, runs = {}, {}

    def launch(name: str, process_id: int):
        env = dict(efficiency_env(base_env, run_dir, name), SCTOOLS_TPU_FAULTS=specs[name])
        procs[name] = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), WORKER_FLAG, str(run_dir), str(process_id), "2",
             str(WORK / "mito.gtf")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)

    try:
        launch("A", 0)
        if crash:
            # B starts once A holds chunk0000, so that A dies holding it
            probe = port_sched.Journal(str(journal_dir), worker_id="smoke-probe")
            deadline = time.perf_counter() + 120
            while time.perf_counter() < deadline and procs["A"].poll() is None:
                if journal_dir.is_dir():
                    tasks, states = probe.replay()
                    if any(tasks[t].name == "chunk0000" and st.state == "leased"
                           for t, st in states.items() if t in tasks):
                        break
                time.sleep(0.05)
        launch("B", 1)
        for name, proc in procs.items():
            out = proc.communicate(timeout=300)[0]
            runs[name] = (proc.returncode, out, f"proc{0 if name == 'A' else 1}-of-2-{proc.pid}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    want = {"A": 86 if crash else 0, "B": 0}
    for name, (rc, out, _) in runs.items():
        if rc != want[name]:
            raise AssertionError(f"{'crash' if crash else 'clean'} run, worker {name}: rc {rc}, want {want[name]}\n"
                                 f"{out[-3000:]}")
    tasks, states = port_sched.Journal(str(journal_dir), worker_id="smoke-probe2").replay()
    if len(tasks) != len(list((WORK / "chunks").glob("*.bam"))) or any(st.state != port_sched.COMMITTED for st in states.values()):
        raise AssertionError(f"not every chunk committed: { {tasks[t].name: st.state for t, st in states.items()} }")
    return runs


def ledger_against_captures(run_dir: Path, worker: str, xprof_data: dict, reads: int) -> dict:
    """One worker's transfer ledger against its own spans' and heartbeats'
    bytes, per site and direction (and the whitelist's against its reads);
    returns the ledger's bytes by (direction, site)."""
    from sctools_tpu_torch.obs import pulse

    ledger = {(d, site): entry["bytes"] for d, total in xprof_data["ledger"].items()
              for site, entry in total["by_site"].items()}
    spans = [json.loads(line) for line in (run_dir / f"trace.{worker}.jsonl").read_text().splitlines()]
    span_bytes = collections.Counter()
    for span in spans:
        if span.get("name") in ("upload", "writeback"):
            span_bytes[span["name"]] += (span.get("attrs") or {}).get("bytes", 0)
    # the ring is named by the worker the obs context held at the first
    # heartbeat: a scheduler's journal id (the registry's own name), else
    # the trace's
    rings = [ring for name, ring in pulse.load_rings(str(run_dir)).items()
             if name in (worker, xprof_data.get("worker"))]
    if len(rings) > 1:
        raise AssertionError(f"{worker}: rings {[r['worker'] for r in rings]}")
    beats = collections.defaultdict(lambda: [0, 0])
    for beat in (rings[0]["records"] if rings else ()):  # attach beats none
        family = "count" if beat["stage"].startswith("count") else "gatherer"
        beats[family][0] += beat["bytes_h2d"]
        beats[family][1] += beat["bytes_d2h"]
    want = {}
    if span_bytes:
        want[("h2d", "gatherer.upload")] = span_bytes["upload"]
        want[("d2h", "gatherer.writeback")] = span_bytes["writeback"]
        if (span_bytes["upload"], span_bytes["writeback"]) != tuple(beats["gatherer"]):
            raise AssertionError(f"{worker}: spans' bytes {dict(span_bytes)}, heartbeats' {beats['gatherer']}")
    if "count" in beats:
        want[("h2d", "count.upload")], want[("d2h", "count.writeback")] = beats["count"]
    if reads:
        want[("h2d", "whitelist.queries")] = reads * CB_LEN
        want[("d2h", "whitelist.queries")] = reads * 4
    got = {key: value for key, value in ledger.items() if key[1] != "whitelist.table"}
    if got != want:
        raise AssertionError(f"{worker}: the ledger {got} is not the captures' bytes {want}")
    return ledger


def phase_efficiency(stamp: str, modules, traced: dict) -> dict:
    """The device half of the observability layer on the card: traced sched
    workers (clean, and with a crash and a steal), each in a process of its
    own, and phase 14's traced attach -w, count and serve worker (``traced``:
    their worker reports and the overhead pair), read back through ``obs
    efficiency`` / ``obs timeline`` / ``sched status`` / ``obs delta``.
    Returns the merged transfer ledger of every traced worker (attach, cell,
    count, serve, sched), ``{direction: {"by_site": {site: {"bytes"}}}}``,
    and their xprof registries (each worker's dump, by name)."""
    import os

    import torch

    kernels, port_obs, port_pulse, port_delta, port_sched, port_fleet = modules
    phase_start = time.perf_counter()
    root = WORK / EFFICIENCY_ROOT
    base_env = {k: v for k, v in os.environ.items() if k not in TRACE_VARS and k not in WITNESS_VARS}

    # (a) the chunk queue: two workers, then the crash and the steal
    sched_runs = {}
    for name, crash in (("sched", False), ("sched_crash", True)):
        begin = time.perf_counter()
        sched_runs[name] = (efficiency_sched(root / name, base_env, crash, port_sched), time.perf_counter() - begin)
    # (b)-(d) attach -w, the count and a serve worker warmed on its CUDA
    # graphs: phase 14's traced runs, one process each (phase 14 checked
    # their outputs against the untraced runs', the attach BAM byte for byte)
    for step in EFFICIENCY_STEPS:
        (root / step).symlink_to(WORK / "tracing" / "traced" / step)
    batches = -(-ANALYSIS_READS // BATCH)
    attach_launches = traced["attach"]["launches"].get("whitelist_correct", 0)

    # every worker's registry against its captures
    registries = {}
    for run_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        for path in sorted(run_dir.glob("xprof.*.json")):
            worker = path.name[len("xprof."):-len(".json")]
            data = json.loads(path.read_text())
            registries[run_dir.name, worker] = (run_dir, data, ledger_against_captures(
                run_dir, worker, data, ANALYSIS_READS if run_dir.name == "attach" else 0))
    # the crashed worker dumps none at exit: its registry is the one its
    # flight record carries, which the merged report reads (from_flight)
    want = {("sched", "A"), ("sched", "B"), ("sched_crash", "B"), ("attach", "traced-attach"),
            ("count", "traced-count"), ("serve", "traced-serve")}
    if set(registries) != want:
        raise AssertionError(f"registries {sorted(registries)}, want {sorted(want)}")
    crashed_id = sched_runs["sched_crash"][0]["A"][2]

    # the merged report, as a user asks for it
    done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.obs", "efficiency", str(root), "--json"],
                          cwd=REPO, env=base_env, capture_output=True, text=True, timeout=120)
    if done.returncode != 0:
        raise AssertionError(f"obs efficiency --json: rc {done.returncode}\n{done.stdout[-2000:]}{done.stderr[-2000:]}")
    report = json.loads(done.stdout)
    text = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.obs", "efficiency", str(root)], cwd=REPO,
                          env=base_env, capture_output=True, text=True, timeout=120)
    if text.returncode != 0 or "transfer ledger:" not in text.stdout:
        raise AssertionError(f"obs efficiency: rc {text.returncode}\n{text.stdout[-2000:]}{text.stderr[-2000:]}")
    sites = report["sites"]
    declared = {name for _, data, _ in registries.values() for name in data["declared_sites"]}
    if not declared or not declared <= set(sites) or len(report["registries"]) != len(registries) + 1:
        raise AssertionError(f"declared sites {sorted(declared)} against the report's {sorted(sites)}")
    from_flight = [r["worker"] for r in report["registries"] if r.get("from_flight")]
    if from_flight != [crashed_id]:
        raise AssertionError(f"registries read from flight records: {from_flight}, want A's ({crashed_id})")
    if report["totals"]["retraces"] != 0 or any(row["retraces"] for row in sites.values()):
        raise AssertionError(f"retraces: {report['totals']['retraces']}")
    serve_site = registries["serve", "traced-serve"][1]["sites"]["metrics.compute_entity_metrics"]
    if serve_site["compiles"] < 1 or serve_site["compile_s"] <= 0:
        raise AssertionError(f"the serve worker's graph captures: {serve_site}")
    records = {"cell": bam_records(WORK / "cell_sorted.bam"), "count": bam_records(WORK / "count.bam")}
    serve_records = bam_records(WORK / "tracing" / "small.bam") + sum(
        bam_records(bam) for _, bam, _ in trace_jobs(WORK / "tracing" / "traced" / "serve"))
    want_rows = {"parallel.sharded_metrics": 2 * records["cell"], "ops.count_molecules": records["count"],
                 "whitelist.correct_pallas": ANALYSIS_READS, "metrics.compute_entity_metrics": serve_records}
    got_rows = {name: sites[name]["real_rows"] for name in want_rows}
    if got_rows != want_rows:
        raise AssertionError(f"real rows per site {got_rows}, want the inputs' records times the passes {want_rows}")
    pallas = sites["whitelist.correct_pallas"]
    if not pallas["dispatches"] == attach_launches == batches:
        raise AssertionError(f"whitelist.correct_pallas: {pallas['dispatches']} dispatches, {attach_launches} "
                             f"launches, {batches} batches")
    memory = report["memory"]
    total_memory = torch.cuda.mem_get_info()[1]
    if not (0 < memory["peak_bytes"] <= total_memory and memory["peak_stage"]):
        raise AssertionError(f"memory: {memory}, the card holds {total_memory} bytes")

    # the timeline of each sched run, as a user asks for it
    timelines = {}
    for name in sched_runs:
        run_dir = root / name
        done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.obs", "timeline", str(run_dir), "--json"],
                              cwd=REPO, env=base_env, capture_output=True, text=True, timeout=120)
        if done.returncode != 0:
            raise AssertionError(f"obs timeline {name}: rc {done.returncode}\n{done.stderr[-2000:]}")
        analysis = json.loads(done.stdout)
        rendered = port_fleet.render_timeline(port_fleet.discover(str(run_dir)), analysis)
        journal_ids = {ident for _, _, ident in sched_runs[name][0].values()}
        for task, row in analysis["tasks"].items():
            if row["state"] != "committed" or row["worker"] not in row["span_workers"] or \
                    not row["duration"] or not (row["occupancy"] and 0 < row["occupancy"] <= 1) or \
                    row["transfer_bytes"] <= 0:
                raise AssertionError(f"timeline {name}: task {task} {row}")
        if not analysis["critical_path"] or "occ%" not in rendered:
            raise AssertionError(f"timeline {name}: critical path {analysis['critical_path']}")
        anchored = {c["worker"]: c["offset_source"] for c in analysis["captures"] if c["spans"]}
        steals = sum(lane["steals"] for lane in analysis["workers"].values())
        if name == "sched":
            if set(anchored.values()) != {"journal"} or len(anchored) != 2 or \
                    not journal_ids <= set(analysis["workers"]):
                raise AssertionError(f"timeline {name}: captures {anchored}, lanes {sorted(analysis['workers'])}")
        elif steals < 1:
            raise AssertionError(f"timeline {name}: the steal is not visible: {analysis['workers']}")
        timelines[name] = (analysis, steals, anchored)

    # sched status's device line, and obs delta's sites and transfers
    status = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.sched", "status",
                             str(root / "sched" / "sched-journal")], cwd=REPO, env=base_env, capture_output=True,
                            text=True, timeout=120)
    device_line = [line for line in status.stdout.splitlines() if line.startswith("device: ")]
    if status.returncode != 0 or len(device_line) != 1:
        raise AssertionError(f"sched status: rc {status.returncode}\n{status.stdout}{status.stderr}")
    platform = {"backend": "torch-cuda", "device_kind": torch.cuda.get_device_name(0), "device_count": 1}
    profiles = {}
    for name, run_dir in (("cell", WORK / "tracing" / "traced" / "cell"), ("sched", root / "sched")):
        profile = port_delta.profile_from_run_dir(str(run_dir), platform=platform)
        if not profile["sites"] or not profile["transfers"] or port_delta.validate_profile(profile):
            raise AssertionError(f"{name} profile: sites {profile['sites']}, transfers {profile['transfers']}")
        profiles[name] = port_delta.write_profile(profile, str(root / f"profile.{name}.json"))
    done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.obs", "delta", profiles["cell"],
                           profiles["sched"], "--json"], cwd=REPO, env=base_env, capture_output=True, text=True,
                          timeout=120)
    if done.returncode != 0:
        raise AssertionError(f"obs delta: rc {done.returncode}\n{done.stdout[-2000:]}{done.stderr[-2000:]}")
    structural = json.loads(done.stdout)["structural"]
    if not (structural["sites_only_a"] and structural["sites_only_b"]):
        raise AssertionError(f"obs delta: {structural}")

    # what it shows
    for name, (runs, wall) in sched_runs.items():
        analysis, steals, anchored = timelines[name]
        log(f"[efficiency] {stamp} | {name}: workers {', '.join(f'{w} exit {rc}' for w, (rc, _, _) in runs.items())} "
            f"in {wall:.2f} s; timeline: {len(analysis['tasks'])} tasks committed, lanes "
            f"{sorted(analysis['workers'])}, clocks {anchored}, critical path of {len(analysis['critical_path'])}, "
            f"{steals} steal(s)")
    for name in sorted(sites):
        row = sites[name]
        if row["dispatches"] or row["calls"] or row["compiles"]:
            occupancy = "-" if row["occupancy"] is None else f"{100 * row['occupancy']:.2f}%"
            log(f"[efficiency] {stamp} | site {name}: {row['calls']} calls, {row['compiles']} compiles "
                f"({row['compile_s']:.3f} s), {row['retraces']} retraces, {row['dispatches']} dispatches, "
                f"{row['real_rows']} real of {row['padded_rows']} rows, occupancy {occupancy}")
    for direction, total in sorted(report["ledger"].items()):
        log(f"[efficiency] {stamp} | {direction}: {total['bytes']} bytes in {total['events']} transfers, "
            f"{total['wasted']} pad; " + ", ".join(f"{site} {entry['bytes']}"
                                                 for site, entry in sorted(total["by_site"].items())))
    log(f"[efficiency] {stamp} | device memory peak {memory['peak_bytes']} bytes in stage {memory['peak_stage']} "
        f"(worker {memory['peak_worker']}, {memory['samples']} samples, torch.cuda.memory_allocated; the card "
        f"holds {total_memory})")
    off, on = traced["overhead"]
    log(f"[efficiency] {stamp} | one record_dispatch {on['dispatch_us']:.3f} us traced ({off['dispatch_us']:.3f} us "
        f"off), one record_transfer {on['transfer_us']:.3f} us ({off['transfer_us']:.3f} us off), "
        f"{TRACE_OVERHEAD_N} of each on this host")
    log(f"[efficiency] {device_line[0]}")
    log(f"[efficiency] every declared site in the merged report ({len(declared)}), 0 retraces, the serve site "
        f"{serve_site['compiles']} compile(s), real rows = the inputs' records x passes {want_rows}, "
        f"whitelist.correct_pallas {pallas['dispatches']} dispatches = launches = batches, every worker's ledger = "
        f"its spans' and heartbeats' bytes; obs delta: sites only in the "
        f"cell run {structural['sites_only_a']}, only in the sched run {structural['sites_only_b']}")
    # the ledgers of every traced worker (the merged report's, and phase 14's
    # traced cell run's): what phase 19 checks against the static inventory
    ledgers = [report["ledger"]] + [json.loads(path.read_text())["ledger"]
                                    for path in (WORK / "tracing" / "traced" / "cell").glob("xprof.*.json")]
    # and their registries: what phase 19 checks against the shape contract
    # and hands the autotuner
    dumps = {f"{run_dir}-{worker}": data for (run_dir, worker), (_, data, _) in registries.items()}
    for path in (WORK / "tracing" / "traced" / "cell").glob("xprof.*.json"):
        dumps[f"cell-{path.name[len('xprof.'):-len('.json')]}"] = json.loads(path.read_text())
    merged = {}
    for ledger in ledgers:
        for direction, total in ledger.items():
            by_site = merged.setdefault(direction, {"by_site": {}})["by_site"]
            for site, entry in total["by_site"].items():
                by_site.setdefault(site, {"bytes": 0})["bytes"] += entry["bytes"]
    # phase 10's chunks, phase 5's GTF and CSV and phase 11's serve journal
    # stay for the audit phase
    shutil.rmtree(root)
    # phase 14's untraced attach BAM is what phase 18's guarded attach must equal
    (WORK / GUARD_IN).mkdir()
    shutil.move(str(WORK / "tracing" / "plain" / "attach" / "attach.bam"), str(WORK / GUARD_IN / "attach_plain.bam"))
    shutil.rmtree(WORK / "tracing")
    log(f"[efficiency] phase 15 took {time.perf_counter() - phase_start:.1f} s")
    return merged, dumps


AUDIT_ROOT = "audit"
AUDIT_CRASH = "chunk0001"  # A commits chunk0000, then dies at chunk0001's first batch
AUDIT_HOLD = 120.0  # the SIGTERM'd worker's delay in its ring's second decode: it is killed inside it
AUDIT_ADD_N = 200_000  # audit.add calls the cost line times
AUDIT_TAPS = 5  # ledger adds a sharded chunk batch makes: ingested, decoded, computed, rows computed, emitted
FLIGHT_SPANS = 1_000  # spans in the ring of the timed flight dump
FLIGHT_DUMPS = 20
# a child process that provokes an ABBA cycle under the lock witness
CYCLE_CHILD = """
from sctools_tpu_torch.analysis import witness

a, b = witness.make_lock("smoke.cycle_a"), witness.make_lock("smoke.cycle_b")
with a:
    with b:
        pass
with b:
    with a:
        pass
print([v["kind"] for v in witness.violations()])
"""


def obs_cli(env: dict, *args) -> subprocess.CompletedProcess:
    """``python -m sctools_tpu_torch.obs <args>``, as a user runs it."""
    return subprocess.run([sys.executable, "-m", "sctools_tpu_torch.obs", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def audit_worker(run_dir: Path, name: str, process_id: int, n_processes: int, env: dict, spec: str):
    """One traced sched worker (phase 10's ``--sched-worker``) into
    ``run_dir``, faults from ``spec``."""
    env = dict(efficiency_env(env, run_dir, name), SCTOOLS_TPU_FAULTS=spec)
    return subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), WORKER_FLAG, str(run_dir), str(process_id), str(n_processes),
         str(WORK / "mito.gtf")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


def worker_reports(name: str, out: str, want: int) -> list:
    """A sched worker's ``[worker]`` lines: ``want`` of them, none with a
    hand kernel launch."""
    reports = [json.loads(line[len("[worker] "):]) for line in out.splitlines() if line.startswith("[worker] ")]
    if len(reports) != want or any(any(r["launches"].values()) for r in reports):
        raise AssertionError(f"worker {name}: reports {reports}, want {want} without a hand kernel launch\n"
                             f"{out[-3000:]}")
    return reports


def decoded_a_batch(sink: Path) -> bool:
    """Whether a traced worker's sink holds a ``decode`` span with records."""
    if not sink.is_file():
        return False
    for line in sink.read_text().splitlines():
        try:
            record = json.loads(line)
        except ValueError:  # a line being written
            continue
        if record.get("name") == "decode" and (record.get("attrs") or {}).get("records"):
            return True
    return False


def flight_meta(path: Path) -> dict:
    """A flight record's meta line; every later line must parse too."""
    lines = path.read_text().splitlines()
    meta = json.loads(lines[0])
    for line in lines[1:]:
        json.loads(line)
    if meta.get("meta") != "flight":
        raise AssertionError(f"{path.name}: not a flight record: {lines[0][:200]}")
    return meta


def phase_audit(stamp: str, modules) -> None:
    """The flight recorder and the record-conservation ledger on the card:
    a traced sched worker crashed mid-chunk and its chunk stolen, the merge,
    ``obs audit`` / ``obs explain`` on the run and a negative control, a
    SIGTERM'd worker and its rerun, phase 11's serve journal and the
    exporter's audit gauges, and a lock-witness cycle in a child process."""
    import os
    import signal

    from sctools_tpu_torch.obs.serve import PulseExporter

    kernels, port_obs, port_audit, port_sched, port_launch, port_gtf = modules
    phase_start = time.perf_counter()
    root = WORK / AUDIT_ROOT
    base_env = {k: v for k, v in os.environ.items()
                if k not in TRACE_VARS and k not in WITNESS_VARS and k != "SCTOOLS_TPU_FAULTS"}
    launches_before = dict(kernels.launches)
    chunks = sorted((WORK / "chunks").glob("chunk*.bam"))
    n_records = bam_records(WORK / "cell_sorted.bam")

    # (a) A commits chunk0000 and dies at chunk0001's first batch, holding
    # its lease; B waits out the TTL, steals chunk0001 and drains the queue
    run = root / "run"
    run.mkdir(parents=True)
    (run / "chunks").symlink_to(WORK / "chunks")
    workers = {}
    procs = []
    try:
        for name, process_id, spec in (("A", 0, f"crash@gatherer.batch:match={AUDIT_CRASH},times=1"),
                                       ("B", 1, "")):
            begin = time.perf_counter()
            proc = audit_worker(run, name, process_id, 2, base_env, spec)
            procs.append(proc)
            out = proc.communicate(timeout=300)[0]
            workers[name] = (proc.returncode, out, f"proc{process_id}-of-2-{proc.pid}", time.perf_counter() - begin)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if workers["A"][0] != 86 or workers["B"][0] != 0:
        raise AssertionError(f"worker A: rc {workers['A'][0]} (want 86)\n{workers['A'][1][-2000:]}\n"
                             f"worker B: rc {workers['B'][0]} (want 0)\n{workers['B'][1][-2000:]}")
    worker_reports("A", workers["A"][1], 1)
    b_end = worker_reports("B", workers["B"][1], 2)[1]
    tasks, states = port_sched.Journal(str(run / "sched-journal"), worker_id="smoke-probe").replay()
    by_name = {tasks[tid].name: st for tid, st in states.items()}
    if len(by_name) != len(chunks) or any(st.state != port_sched.COMMITTED for st in by_name.values()) or \
            (by_name[AUDIT_CRASH].attempts, by_name[AUDIT_CRASH].steals) != (2, 1) or \
            by_name[AUDIT_CRASH].worker != workers["B"][2] or by_name["chunk0000"].worker != workers["A"][2]:
        raise AssertionError(f"the crash run's journal: { {n: vars(st) for n, st in by_name.items()} }")

    # (b) A's flight record: where it died, its pulse, its ring, its registry
    flight_path = run / f"flight.{workers['A'][2]}.jsonl"
    meta = flight_meta(flight_path)
    sections = meta.get("sections") or {}
    pulse_section, rings = sections.get("pulse") or {}, sections.get("ring_slots") or []
    sharded = ((meta.get("xprof") or {}).get("sites") or {}).get("parallel.sharded_metrics") or {}
    # (the ring of chunk0001 may have reached its end before the crash: its
    # slots are the SIGTERM case's to show)
    if not (meta["reason"].startswith("crash@gatherer.batch:") and AUDIT_CRASH in meta["reason"]) or \
            "sched:task" not in meta["open_spans"] or not pulse_section.get("recent") or \
            "ring_slots" not in sections or not all("phase" in ring for ring in rings) or \
            sharded.get("dispatches", 0) < 1:
        raise AssertionError(f"A's flight record: reason {meta['reason']!r}, open spans {meta['open_spans']}, "
                             f"sections {sorted(sections)} (pulse {pulse_section}, rings {rings}), "
                             f"parallel.sharded_metrics {sharded}")
    timeline = obs_cli(base_env, "timeline", str(run), "--json")
    efficiency = obs_cli(base_env, "efficiency", str(run), "--json")
    if timeline.returncode != 0 or efficiency.returncode != 0:
        raise AssertionError(f"obs timeline / efficiency: rc {timeline.returncode} / {efficiency.returncode}\n"
                             f"{timeline.stderr[-2000:]}{efficiency.stderr[-2000:]}")
    flights = [(f["worker"], f["reason"]) for f in json.loads(timeline.stdout)["flight_records"]]
    from_flight = [r["worker"] for r in json.loads(efficiency.stdout)["registries"] if r["from_flight"]]
    if flights != [(workers["A"][2], meta["reason"])] or from_flight != [workers["A"][2]]:
        raise AssertionError(f"obs timeline's flight records {flights}, efficiency's from_flight {from_flight}")

    # (c) the journal-checked merge, against phase 5's one-shot CSV
    merged = run / "merged.csv.gz"
    n_rows = port_launch.merge_sorted_csv_parts(str(run / "metrics.part*.csv.gz"), str(merged),
                                                journal_dir=str(run / "sched-journal"), expected_parts=len(chunks))
    if read_csv(merged)[0] != read_csv(WORK / "cli_cell.csv.gz")[0]:
        raise AssertionError("the crash run's merged CSV differs from phase 5's CalculateCellMetrics CSV")

    # (d) obs audit: EXACT, every record counted once over the committed attempts
    audit_text, audit_json = obs_cli(base_env, "audit", str(run)), obs_cli(base_env, "audit", str(run), "--json")
    if audit_text.returncode != 0 or "RESULT: EXACT — 0 unexplained records" not in audit_text.stdout or \
            audit_json.returncode != 0:
        raise AssertionError(f"obs audit: rc {audit_text.returncode}\n{audit_text.stdout}{audit_text.stderr}")
    report = json.loads(audit_json.stdout)
    fleet, (merge_entry,) = report["fleet"], report["merges"]
    records, rows = fleet["records"], fleet["rows"]
    if not (records["ingested"] == records["decoded"] == records["computed"] == n_records) or \
            records["quarantined"] or rows["computed"] != rows["emitted"] + rows["filtered"] or \
            rows["emitted"] != n_rows or fleet["tasks_audited"] != len(chunks) or \
            not (merge_entry["rows_in"] == merge_entry["rows_out"] == n_rows) or merge_entry["merged:collision"]:
        raise AssertionError(f"obs audit: fleet {fleet}, merge {merge_entry}, want {n_records} records and "
                             f"{n_rows} rows")

    # (e) the explains: the stolen task's story, one emitted cell's rows
    job = obs_cli(base_env, "explain", str(run), "--job", AUDIT_CRASH)
    story = job.stdout
    if job.returncode != 0 or f"task {AUDIT_CRASH}" not in story or "2 attempt(s), 1 steal(s)" not in story or \
            "(stolen)" not in story or "committed on" not in story or "artifact:" not in story or \
            "ledger:" not in story:
        raise AssertionError(f"obs explain --job {AUDIT_CRASH}: rc {job.returncode}\n{story}{job.stderr}")
    merged_names = list(read_csv(merged)[2])
    barcode = next(name for name in merged_names[len(merged_names) // 2:] if set(name) <= set("ACGT"))
    want = [f"-> {run / 'merged.csv.gz'}:row {merged_names.index(barcode) + 1}"]
    for part in sorted(run.glob("metrics.part*.csv.gz")):
        names = list(read_csv(part)[2])
        if barcode in names:
            want.append(f"-> {part}:row {names.index(barcode) + 1}")
    found = obs_cli(base_env, "explain", str(run), "--barcode", barcode)
    if found.returncode != 0 or len(want) != 2 or not all(line in found.stdout for line in want):
        raise AssertionError(f"obs explain --barcode {barcode}: rc {found.returncode}, want {want}\n{found.stdout}")

    # (f) negative control: a sidecar range the ledger never counted
    negative = root / "negative"
    shutil.copytree(run / "sched-journal", negative / "sched-journal")
    (negative / "sched-journal" / "quarantine").mkdir(exist_ok=True)
    victim = next(tid for tid, task in tasks.items() if task.name == "chunk0002")
    with open(negative / "sched-journal" / "quarantine" / "records-fabricated.jsonl", "a") as f:
        f.write(json.dumps({"task": "chunk0002", "task_id": victim, "worker": "fabricated",
                            "site": "gatherer.dispatch", "name": "chunk0002.bam", "record_start": 0,
                            "record_stop": 7, "reason": "Fabricated", "ts": 0.0}) + "\n")
    unbalanced = obs_cli(base_env, "audit", str(negative))
    if unbalanced.returncode != 1 or "RESULT: UNBALANCED — 7 unexplained record(s)" not in unbalanced.stdout:
        raise AssertionError(f"the negative control: rc {unbalanced.returncode}\n{unbalanced.stdout}")

    # (g) SIGTERM inside a task: a flight record, and the process still dies
    # of the signal; an in-process rerun steals and commits the chunk
    term = root / "term"
    (term / "chunks").mkdir(parents=True)
    (term / "chunks" / chunks[0].name).symlink_to(chunks[0])
    begin = time.perf_counter()
    # the ring's producer holds in its second decode (``ingest.decode``,
    # batch 1: the chunk's end-of-stream poll) with its slots live, while
    # this thread waits on the queue inside the task
    proc = audit_worker(term, "T", 0, 1, base_env, f"delay@ingest.decode:match=1,secs={AUDIT_HOLD},times=1")
    try:
        deadline = time.perf_counter() + 120
        while not decoded_a_batch(term / "trace.T.jsonl"):
            if proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"the SIGTERM worker never decoded a batch: {proc.communicate()[0][-3000:]}")
            time.sleep(0.05)
        time.sleep(0.5)  # into the injected delay of the next decode
        proc.send_signal(signal.SIGTERM)
        term_out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    term_wall = time.perf_counter() - begin
    (term_flight,) = term.glob("flight.*.jsonl")
    term_meta = flight_meta(term_flight)
    if proc.returncode != -signal.SIGTERM or term_meta["reason"] != "signal:SIGTERM" or \
            not (term_meta.get("sections") or {}).get("ring_slots") or "sched:task" not in term_meta["open_spans"]:
        raise AssertionError(f"the SIGTERM worker: rc {proc.returncode}, flight {term_meta['reason']!r}, open spans "
                             f"{term_meta['open_spans']}, sections {term_meta.get('sections')}\n{term_out[-2000:]}")
    worker_reports("T", term_out, 1)
    begin = time.perf_counter()
    committed = port_launch.run_process_cell_metrics(
        [str(term / "chunks" / chunks[0].name)], str(term / "proc0"), 1, 0,
        frozenset(port_gtf.get_mitochondrial_gene_names(str(WORK / "mito.gtf"))), lease_ttl=SCHED_TTL,
        backoff_base=0.1,
    )
    rerun_wall = time.perf_counter() - begin
    term_audit = obs_cli(base_env, "audit", str(term), "--json")
    term_fleet = json.loads(term_audit.stdout)["fleet"] if term_audit.returncode == 0 else {}
    if len(committed) != 1 or not term_fleet.get("exact") or term_fleet["tasks_audited"] != 1 or \
            term_fleet["records"]["decoded"] != bam_records(chunks[0]):
        raise AssertionError(f"the SIGTERM rerun: committed {committed}, audit rc {term_audit.returncode} "
                             f"{term_fleet}{term_audit.stderr}")

    # (h) phase 11's serve journal: EXACT, each pack's routed rows its
    # emitted rows, and the exporter's per-tenant audit gauges
    serve_run = WORK / SERVE_AUDIT
    served = obs_cli(base_env, "audit", str(serve_run), "--json")
    serve_report = json.loads(served.stdout) if served.returncode == 0 else {"fleet": {}}
    if served.returncode != 0 or not serve_report["fleet"].get("exact"):
        raise AssertionError(f"obs audit of phase 11's journal: rc {served.returncode}\n{served.stdout[-3000:]}")
    journal = port_sched.Journal(str(serve_run / "journal"), worker_id="smoke-probe")
    try:
        serve_tasks = journal.replay()[0]
        segments = {}
        for event in journal.events():
            if event.get("event") == "committed":
                for segment in event.get("pack_execs") or ():
                    if not segment.get("aborted") and segment.get("ledger") is not None:
                        segments[segment["exec_id"]] = segment
    finally:
        journal.close()
    packs = [seg for seg in segments.values() if seg.get("rows_routed") is not None]
    for segment in packs:
        if sum(segment["rows_routed"]) != segment["ledger"]["rows.emitted"] or \
                segment["rows_routed"] != segment["rows_claimed"]:
            raise AssertionError(f"pack {segment['exec_id']}: routed {segment['rows_routed']}, claimed "
                                 f"{segment['rows_claimed']}, ledger {segment['ledger']}")
    tenants = sorted({task.payload["tenant"] for task in serve_tasks.values()})
    body = PulseExporter(run_dir=str(serve_run)).render()
    missing = [f'sctools_tpu_audit_rows_emitted_total{{tenant="{t}"}}' for t in tenants
               if f'sctools_tpu_audit_rows_emitted_total{{tenant="{t}"}}' not in body]
    if not packs or len(serve_report["serve_jobs"]) != len(serve_tasks) or missing or \
            "sctools_tpu_audit_unexplained_records 0" not in body:
        raise AssertionError(f"serve audit: {len(packs)} packs, {len(serve_report['serve_jobs'])} jobs of "
                             f"{len(serve_tasks)}, gauges missing {missing}\n{body[-2000:]}")

    # (i) a lock-witness cycle in a child process: a flight record
    witness_dir = root / "witness"
    done = subprocess.run([sys.executable, "-c", CYCLE_CHILD], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(base_env, PYTHONPATH=str(REPO), SCTOOLS_TPU_LOCK_DEBUG="1",
                                   SCTOOLS_TPU_TRACE=str(witness_dir), SCTOOLS_TPU_TRACE_WORKER="cycle"))
    cycle_meta = flight_meta(witness_dir / "flight.cycle.jsonl") if done.returncode == 0 else {}
    snapshot = json.loads((witness_dir / "locks.cycle.json").read_text()) if done.returncode == 0 else {}
    if done.returncode != 0 or cycle_meta.get("reason") != "lock-witness:cycle" or \
            [v["kind"] for v in snapshot.get("violations", ())] != ["cycle"]:
        raise AssertionError(f"the witness child: rc {done.returncode}, flight {cycle_meta.get('reason')!r}, "
                             f"snapshot violations {snapshot.get('violations')}\n{done.stdout}{done.stderr}")

    # (j) what a dump and a ledger add cost on this host
    port_obs.reset()
    port_obs.enable()
    try:
        for _ in range(FLIGHT_SPANS):
            with port_obs.span("timing"):
                pass
        target = root / "timing.flight.jsonl"
        begin = time.perf_counter()
        for _ in range(FLIGHT_DUMPS):
            port_obs.flight_dump(reason="timing", path=str(target))
        dump_ms = (time.perf_counter() - begin) / FLIGHT_DUMPS * 1e3
    finally:
        port_obs.disable()
        port_obs.reset()
    begin = time.perf_counter()
    for _ in range(AUDIT_ADD_N):
        port_audit.add("records.decoded", 1, task_id="smoke-timing")
    add_us = (time.perf_counter() - begin) / AUDIT_ADD_N * 1e6
    port_audit.discard("smoke-timing")
    chunk_s = b_end["wall"] / max(b_end["committed"], 1)
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the audit phase: {kernels.launches}")

    log(f"[audit] {stamp} | crash run: A ({workers['A'][2]}) exit 86 in {workers['A'][3]:.2f} s, B "
        f"({workers['B'][2]}) exit 0 in {workers['B'][3]:.2f} s, {AUDIT_CRASH} stolen (2 attempts); hand kernel "
        f"launches 0 in every worker")
    log(f"[audit] {stamp} | A's flight record {flight_path.name}: {flight_path.stat().st_size} bytes, reason "
        f"{meta['reason'].rsplit('/', 1)[-1]!r}, open spans {meta['open_spans']}, pulse seq "
        f"{pulse_section.get('seq')} with {len(pulse_section['recent'])} recent heartbeat(s), ring_slots "
        f"{[(r.get('phase'), r.get('batches')) for r in rings]}, parallel.sharded_metrics {sharded['dispatches']} "
        f"dispatch(es); obs timeline and obs efficiency read it (from_flight)")
    log(f"[audit] {stamp} | obs audit: EXACT, {records['decoded']} records ingested = decoded = computed, "
        f"{rows['computed']} rows computed = {rows['emitted']} emitted + {rows['filtered']} filtered over "
        f"{fleet['tasks_audited']} committed tasks; merge {merge_entry['rows_in']} rows in = "
        f"{merge_entry['rows_out']} out, merged CSV equal to phase 5's byte for byte (decompressed); the "
        f"fabricated sidecar line: UNBALANCED, exit 1")
    log(f"[audit] {stamp} | obs explain --job {AUDIT_CRASH}: both attempts, the steal and its part; --barcode "
        f"{barcode}: {'; '.join(line[3:] for line in want)}")
    log(f"[audit] {stamp} | SIGTERM: worker T died of the signal (rc {proc.returncode}) after {term_wall:.2f} s with "
        f"flight record {term_flight.name} (signal:SIGTERM, open spans {term_meta['open_spans']}, ring_slots "
        f"{[(r.get('phase'), r.get('batches')) for r in term_meta['sections']['ring_slots']]}); the rerun in "
        f"this process stole and committed its chunk in {rerun_wall:.2f} s, obs audit EXACT")
    log(f"[audit] {stamp} | phase 11's serve journal: EXACT, {len(serve_report['serve_jobs'])} jobs, "
        f"{len(packs)} pack(s) with routed rows = emitted rows; the exporter's audit gauges for {tenants}")
    log(f"[audit] {stamp} | the witness child's ABBA cycle: flight record reason lock-witness:cycle, "
        f"locks.cycle.json with the cycle violation")
    log(f"[audit] {stamp} | one flight_dump {dump_ms:.3f} ms ({FLIGHT_SPANS} spans in the ring, fsync included, "
        f"mean of {FLIGHT_DUMPS}); one audit.add {add_us:.3f} us (mean of {AUDIT_ADD_N}): {AUDIT_TAPS} a chunk batch "
        f"= {AUDIT_TAPS * add_us:.3f} us against B's {chunk_s:.3f} s a chunk "
        f"({100 * AUDIT_TAPS * add_us * 1e-6 / chunk_s:.6f}%)")
    clear_work_for_guard()
    log(f"[audit] phase 16 took {time.perf_counter() - phase_start:.1f} s")


STEER_ROOT = "steer"
STEER_TENANTS = 4
STEER_JOBS = 6  # a tenant
# a job: 675 cells x 2 molecules x 2 reads = 2,700 records of 48 bases on a
# disjoint barcode range, whose file-size estimate (~2,200 records at 48
# bytes a record) packs one job into the static 4,096 bucket and three into
# the 8,192 rung the armed controller coalesces to
STEER_CELLS = 675
STEER_SEQ_LEN = 48
STEER_BATCH = 4096
# the calibration library: 1,280 cells x 4 molecules x 2 reads = 10,240
# records, past the ladder's top rung (8,192), so every rung's graphs are
# captured at warmup
STEER_CALIBRATION_CELLS = 1280
STEER_EPOCH = 0.1  # seconds between decisions: the drain is short
STEER_GENES = 256
XF_ROLL = ((230, b"CODING"), (243, b"INTRONIC"), (251, b"UTR"), (256, b"INTERGENIC"))


def write_steer_bam(path: Path, bgzf, n_cells: int, molecules: int, reads: int, seed: int,
                    cell_offset: int = 0) -> int:
    """A cell-sorted, fully tagged library of ``n_cells`` x ``molecules`` x
    ``reads`` records of ``STEER_SEQ_LEN`` bases on one reference, BGZF level
    1: CB (= CR) the 16-base base-4 code of ``cell_offset + cell``, UB (= UR)
    the 10-base code of the molecule, one ``GENE<n>`` of 256 a molecule, XF
    mostly CODING, NH 1, ~25% of later reads duplicates, a quality ramp and
    random bases. Returns the records written."""
    rng = np.random.default_rng(seed)
    codes = np.frombuffer(b"ACGT", dtype=np.uint8)

    def base4(value: int, width: int) -> bytes:
        return codes[(value >> (2 * np.arange(width - 1, -1, -1))) & 3].tobytes()

    nt16 = np.zeros(256, dtype=np.uint8)
    nt16[list(b"ACGT")] = (1, 2, 4, 8)
    text = b"@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chr1\tLN:248956422\n"
    header = (b"BAM\1" + struct.pack("<I", len(text)) + text + struct.pack("<I", 1)
              + struct.pack("<I", 5) + b"chr1\0" + struct.pack("<I", 248956422))
    rows = []
    for cell in range(n_cells):
        cb = base4(cell_offset + cell, CB_LEN)
        for mol in range(molecules):
            ub = base4(mol, UMI_LEN)
            ge = b"GENE%d" % rng.integers(STEER_GENES)
            anchor = int(rng.integers(100_000_000))
            for r in range(reads):
                bits = int(rng.integers(1 << 62))
                flag = (0x400 if r and (bits & 0xFF) < 64 else 0) | (0x10 if (bits >> 8) & 1 else 0)
                pos = anchor if (bits >> 9) & 3 else anchor + ((bits >> 11) & 0xFFFF)
                xf = next(value for bound, value in XF_ROLL if (bits >> 32) & 0xFF < bound)
                qname = b"q%d_%d_%d\0" % (cell, mol, r)
                seq = codes[rng.integers(0, 4, STEER_SEQ_LEN)]
                q = 20 + ((bits >> 40) & 0x13)
                qual = bytes(q + ((i * 7 + (bits & 7)) % 17) for i in range(STEER_SEQ_LEN))
                body = (struct.pack("<iiBBHHHIiii", 0, pos, len(qname), 255, 0, 1, flag, STEER_SEQ_LEN, -1, -1, 0)
                        + qname + struct.pack("<I", STEER_SEQ_LEN << 4)
                        + ((nt16[seq[0::2]] << 4) | nt16[seq[1::2]]).tobytes() + qual
                        + b"CBZ" + cb + b"\0CRZ" + cb + b"\0CYZ" + b"I" * CB_LEN + b"\0UBZ" + ub + b"\0URZ" + ub
                        + b"\0UYZ" + b"I" * UMI_LEN + b"\0GEZ" + ge + b"\0XFZ" + xf + b"\0NHC\1")
                rows.append(struct.pack("<I", len(body)) + body)
    with bgzf.BgzfWriter(str(path), level=1) as out:
        out.write(header)
        out.write(b"".join(rows))
    return len(rows)


def steer_leg(root: Path, leg: str, armed: bool, jobs, calibration: Path, modules) -> dict:
    """One leg of phase 17: the jobs submitted to a fresh journal and
    drained by two traced serve workers (``--serve-worker``) with
    ``SCTOOLS_TPU_STEER`` at 1 or 0; returns what the gates read."""
    import os

    pulse, xprof, steer, manifest, sched, serve_cli, shardcheck = modules
    leg_dir = root / leg
    obs_dir = leg_dir / "obs"
    journal_dir = leg_dir / "journal"
    obs_dir.mkdir(parents=True)
    out_of = {}
    serve_jobs = []
    for tenant, index, bam in jobs:
        stem = leg_dir / "out" / f"{tenant}-{index}"
        out_of[(tenant, index)] = stem
        serve_jobs.append(serve_cli.ServeJob(tenant, str(bam), str(stem)))
    if serve_cli.submit_jobs(str(journal_dir), serve_jobs) != len(jobs):
        raise AssertionError(f"{leg}: not every job registered")
    procs = {}
    began = time.perf_counter()
    try:
        for worker in ("w0", "w1"):
            env = {k: v for k, v in os.environ.items() if not k.startswith("SCTOOLS_TPU_")}
            env.update(SCTOOLS_TPU_STEER="1" if armed else "0", SCTOOLS_TPU_TRACE=str(obs_dir),
                       SCTOOLS_TPU_TRACE_WORKER=worker, SCTOOLS_TPU_PULSE="1")
            procs[worker] = subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), SERVE_FLAG, str(journal_dir), "--worker-id", worker,
                 "--calibration-bam", str(calibration), "--batch-records", str(STEER_BATCH),
                 "--steer-epoch", repr(STEER_EPOCH), "--idle-timeout", "120", "--poll-interval", "0.05", "--drain"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            )
        runs = {}
        for worker, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            runs[worker] = (proc.returncode, out)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - began
    summaries = {}
    for worker, (rc, out) in runs.items():
        reports = [json.loads(line[len("[worker] "):]) for line in out.splitlines() if line.startswith("[worker] ")]
        if rc != 0 or len(reports) != 2:
            raise AssertionError(f"{leg} worker {worker}: rc {rc}\n{out[-3000:]}")
        if any(any(r["launches"].values()) for r in reports):
            raise AssertionError(f"{leg} worker {worker}: hand kernel launches {reports}")
        summaries[worker] = json.loads(next(line for line in out.splitlines() if line.startswith('{"worker"')))
    probe = sched.Journal(str(journal_dir), worker_id="smoke-probe")
    tasks, states = probe.replay()
    events = probe.events()
    probe.close()
    committed = sum(st.state == "committed" for st in states.values())
    real = padded = 0
    for ring in pulse.load_rings(str(obs_dir)).values():
        if ring.get("torn"):
            raise AssertionError(f"{leg}: a torn ring: {ring.get('path')}")
        for record in ring["records"]:
            if record.get("task_id") != "warmup":
                real += int(record.get("real_rows") or 0)
                padded += int(record.get("padded_rows") or 0)
    if not padded:
        raise AssertionError(f"{leg}: no tenant heartbeats in the pulse rings")
    registries = xprof.load_registries(str(obs_dir))
    merged = xprof.merge_registries(registries)
    contract = manifest.load_manifest()["contract"]
    announced = [e for e in events if e.get("event") == "worker"]
    decisions = steer.load_decisions(str(leg_dir))
    return {
        "jobs": len(jobs), "committed": committed, "wall": wall, "summaries": summaries,
        "occupancy": real / padded, "real": real, "padded": padded,
        "retraces": sum(int(site.get("retraces") or 0) for site in merged["sites"].values()),
        "violations": shardcheck.check_signatures(contract, merged["sites"]),
        "signatures": sum(len(site.get("signatures") or {}) for site in merged["sites"].values()),
        "contract": contract, "registries": registries,
        "announced": announced, "decisions": decisions, "snapshots": steer.latest_snapshots(str(leg_dir)),
        "buckets": collections.Counter(e["pack_bucket"] for e in events if e.get("event") == "committed"),
        "out": out_of,
    }


def phase_steer(stamp: str, modules) -> dict:
    """Online steering on the card: the same 24 jobs of 4 tenants drained by
    a 2-worker fleet twice, with ``SCTOOLS_TPU_STEER=0`` and then armed with
    a short ``--steer-epoch``; see the module docstring, phase 17. Returns
    the serve workers' xprof registries, by name."""
    phase_start = time.perf_counter()
    import os

    kernels, bgzf, pulse, xprof, steer, manifest, sched, serve_cli, port_platform, shardcheck = modules
    launches_before = dict(kernels.launches)
    root = WORK / STEER_ROOT
    (root / "in").mkdir(parents=True)
    # the committed manifest against the AOT pass's fresh contract: the
    # staleness gate, as a user runs it
    begin = time.perf_counter()
    gate = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "--aot-only", "--aot-manifest",
                           "sctools_tpu_torch/serve/graph_manifest.json", "sctools_tpu_torch"], cwd=REPO,
                          env=dict(os.environ, SCTOOLS_TPU_SCX_CACHE="0"), capture_output=True, text=True,
                          timeout=300)
    if gate.returncode != 0 or "matches the fresh shape contract" not in gate.stdout:
        raise AssertionError(f"the manifest's staleness gate: rc {gate.returncode}\n{gate.stdout}{gate.stderr}")
    committed = manifest.load_manifest()
    reachable = sorted(name for name, site in committed["sites"].items() if site["serve_reachable"])
    log(f"[steer] {stamp} | the committed graph manifest passes the AOT staleness gate in "
        f"{time.perf_counter() - begin:.2f} s (contract {committed['contract_hash'][:12]}, "
        f"{len(committed['sites'])} sites, serve-reachable {reachable})")
    begin = time.perf_counter()
    calibration = root / "in" / "calibration.bam"
    write_steer_bam(calibration, bgzf, STEER_CALIBRATION_CELLS, 4, 2, seed=4242)
    jobs = []
    for t in range(STEER_TENANTS):
        for j in range(STEER_JOBS):
            index = t * STEER_JOBS + j
            bam = root / "in" / f"tenant{t:02d}-job{j}.bam"
            write_steer_bam(bam, bgzf, STEER_CELLS, 2, 2, seed=5000 + index, cell_offset=index * STEER_CELLS)
            jobs.append((f"tenant{t:02d}", j, bam))
    estimates = [bam.stat().st_size // 48 for _, _, bam in jobs]
    log(f"[steer] {len(jobs)} jobs of {STEER_TENANTS} tenants ({STEER_CELLS * 4} records each, file-size "
        f"estimates {min(estimates)}-{max(estimates)} records) and a {STEER_CALIBRATION_CELLS * 8}-record "
        f"calibration library made in {time.perf_counter() - begin:.2f} s")
    if not 2 * min(estimates) > STEER_BATCH or not 3 * max(estimates) <= 2 * STEER_BATCH:
        raise AssertionError(f"the estimates {estimates} do not pack one job a static bucket and three a rung up")
    # each job's solo CalculateCellMetrics on the card: what every artifact must equal
    begin = time.perf_counter()
    solo = {}
    for tenant, index, bam in jobs:
        stem = root / "solo" / f"{tenant}-{index}"
        stem.parent.mkdir(exist_ok=True)
        if port_platform.GenericPlatform.calculate_cell_metrics(["-i", str(bam), "-o", str(stem)]) != 0:
            raise AssertionError(f"CalculateCellMetrics on {bam.name} failed")
        solo[(tenant, index)] = read_csv(Path(str(stem) + ".csv.gz"))[0]
    solo_s = time.perf_counter() - begin
    leg_modules = (pulse, xprof, steer, manifest, sched, serve_cli, shardcheck)
    legs = {"static": steer_leg(root, "static", False, jobs, calibration, leg_modules),
            "steered": steer_leg(root, "steered", True, jobs, calibration, leg_modules)}
    for name, leg in legs.items():
        if leg["committed"] != leg["jobs"]:
            raise AssertionError(f"{name}: {leg['committed']} of {leg['jobs']} jobs committed")
        for key, stem in leg["out"].items():
            if read_csv(Path(str(stem) + ".csv.gz"))[0] != solo[key]:
                raise AssertionError(f"{name}: {stem.name}'s served CSV differs from its solo run")
        if leg["retraces"] or leg["violations"]:
            raise AssertionError(f"{name}: retraces {leg['retraces']}, outside the contract {leg['violations']}")
        for worker, summary in leg["summaries"].items():
            graphs = summary["graphs"]
            if graphs["keys"] != graphs["captures_warmup"] + graphs["captures_serving"]:
                raise AssertionError(f"{name} worker {worker}: a graph key captured twice: {graphs}")
            if graphs["captures_serving"]:
                raise AssertionError(f"{name} worker {worker}: a graph captured while serving: {graphs}")
        # every bucket a controller held resident or applied is one the
        # regenerated contract admits
        buckets = {b for snap in leg["snapshots"].values() for b in snap.get("resident") or ()}
        buckets |= {d["proposal"]["to"] for d in leg["decisions"]
                    if d["verdict"] == "applied" and d["proposal"]["knob"] == "bucket"}
        outside = sorted(b for b in buckets if not shardcheck.dim_admissible(b, leg["contract"]))
        if outside:
            raise AssertionError(f"{name}: buckets outside the contract: {outside}")
        leg["admitted"] = sorted(buckets)
    if any(e["steer"] != {"mode": "off"} for e in legs["static"]["announced"]) or legs["static"]["decisions"]:
        raise AssertionError("the static leg announced a steering controller")
    steered = legs["steered"]
    if not steered["occupancy"] > legs["static"]["occupancy"]:
        raise AssertionError(f"steered occupancy {steered['occupancy']:.4f} did not beat static "
                             f"{legs['static']['occupancy']:.4f}")
    applied = [d for d in steered["decisions"] if d["verdict"] == "applied"]
    if not applied:
        raise AssertionError("the armed leg journaled no applied decision")
    for decision in applied:
        proposal = decision["proposal"]
        resident = steered["snapshots"][decision["worker"]]["resident"]
        if proposal["knob"] == "bucket" and proposal["to"] not in resident:
            raise AssertionError(f"an applied bucket outside {decision['worker']}'s ladder {resident}: {decision}")
    for name, leg in legs.items():
        verdicts = collections.Counter(d["verdict"] for d in leg["decisions"])
        graphs = {w: s["graphs"] for w, s in sorted(leg["summaries"].items())}
        log(f"[steer] {stamp} | {name}: {leg['committed']}/{leg['jobs']} jobs in {leg['wall']:.2f} s wall (2 workers, "
            f"start to exit); occupancy {leg['occupancy']:.4f} ({leg['real']} real of {leg['padded']} padded rows, "
            f"warmup beats excluded); packs by bucket {dict(sorted(leg['buckets'].items()))}; decisions "
            f"{dict(sorted(verdicts.items()))}; retraces {leg['retraces']}, {leg['signatures']} signatures all inside "
            f"the contract; buckets resident or applied {leg['admitted']}, all admitted by the contract")
        for worker, g in graphs.items():
            summary = leg["summaries"][worker]
            log(f"[steer] {stamp} | {name} {worker}: warmup {summary['warmup_s']:.2f} s, graphs captured "
                f"{g['captures_warmup']} at warmup and {g['captures_serving']} while serving, {g['replays']} replays, "
                f"{g['keys']} keys; {summary['jobs_committed']} jobs in {summary['packs_run']} packs; steer "
                f"{leg['snapshots'].get(worker, {'mode': 'off'})}; no hand kernel at its start and its end")
    for decision in applied:
        log(f"[steer] applied by {decision['worker']}: {decision['proposal']} at occupancy "
            f"{decision['inputs']['occupancy']:.4f} over {decision['inputs']['heartbeats']} heartbeats")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the steering phase: {kernels.launches}")
    log(f"[steer] every served CSV of both legs equals its job's solo CalculateCellMetrics CSV on the card "
        f"(decompressed; the solo runs took {solo_s:.2f} s); no hand kernel launched in this process")
    clear_work_for_guard()
    log(f"[steer] phase 17 took {time.perf_counter() - phase_start:.1f} s")
    return {f"steer-{name}-{i}": registry for name, leg in legs.items()
            for i, registry in enumerate(leg["registries"])}


GUARD_ROOT = "guard"
GUARD_IN = "guard_in"  # phase 14's untraced attach BAM, kept from phase 15
# phase 18's inputs, which phases 16 and 17 leave in place
KEPT_FOR_GUARD = ("cell_sorted.bam", "mito.gtf", "cli_cell.csv.gz", "chunks", "analysis", GUARD_IN)
# the guard's five named locks; the strike count's and the deadline's are
# taken on a fault path only
GUARD_LOCKS = ("guard.open_retries", "guard.degrade", "guard.quarantine", "guard.watchdog.deadline",
               "ingest.wire_state")
GUARD_FAULT_LOCKS = frozenset({"guard.degrade", "guard.watchdog.deadline"})
GUARD_POISON = (3, 10)  # the records of chunk0000 the cocktail poisons
GUARD_TIMEOUT_COMPUTE = "20"  # the JAX guard smoke's compute deadline (tests/guard_smoke.py:122-127)
GUARD_SYNTH_CELLS = 1000
GUARD_OVERHEAD_N = 20_000
GUARD_FLAG = "--guard-worker"


def clear_work_for_guard() -> None:
    """Remove the work files but phase 18's inputs (``KEPT_FOR_GUARD``)."""
    for path in WORK.iterdir():
        if path.name not in KEPT_FOR_GUARD:
            shutil.rmtree(path) if path.is_dir() and not path.is_symlink() else path.unlink()


def guard_worker(argv) -> int:
    """One of phase 18's child processes, on cuda: ``oom <out>`` measures
    the peak device memory of one full 2^20 batch of phase 5's cell BAM and
    of one 2^19 batch, caps the process's memory between them and runs
    CalculateCellMetrics under the cap; ``attach <out>`` runs attach -w on
    phase 13's reads under the environment's faults. Prints one ``[worker]
    {json}`` line: the guard's counters, what it classified, the hand kernel
    launches and the step's own numbers."""
    mode, out = argv[0], Path(argv[1])
    import torch

    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import guard, ingest, kernels, native, obs
    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import platform as port_platform
    from sctools_tpu_torch.metrics import gatherer as port_gatherer

    obs.enable()  # the guard's counters, in this process only
    classified = []
    classify = guard.classify

    def recorded(error):
        kind = classify(error)
        classified.append((f"{type(error).__module__}.{type(error).__name__}", kind))
        return kind

    guard.classify = recorded  # what the ladder's attempt loops call
    out.mkdir(parents=True, exist_ok=True)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    report = {}
    kernels.reset_launches()
    if mode == "oom":
        bam, gtf = str(WORK / "cell_sorted.bam"), str(WORK / "mito.gtf")
        from sctools_tpu_torch.io.packed import copy_frame

        stream = native.stream_frames(bam, METRICS_BATCH)
        frame = copy_frame(next(stream))
        stream.close()
        changes = np.nonzero(frame.cell[1:] != frame.cell[:-1])[0]
        full = int(changes[changes < METRICS_BATCH][-1]) + 1
        half = int(changes[changes < METRICS_BATCH // 2][-1]) + 1
        gatherer = port_gatherer.GatherCellMetrics(
            bam, str(out / "peak"), frozenset(port_gtf.get_mitochondrial_gene_names(gtf)), device="cuda")
        gatherer.start_stream()
        gatherer._writeback = ingest.WritebackRing(name="peak")

        def peak(records: int, pad_to: int) -> int:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            pending = gatherer._dispatch_device_batch(port_gatherer.slice_frame(frame, 0, records), pad_to=pad_to)
            gatherer._writeback.collect(pending[1], site="smoke.peak")
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated()

        peaks = {"full": peak(full, METRICS_BATCH), "half": peak(half, 0)}
        gatherer._writeback.close()
        del frame, gatherer
        total = torch.cuda.get_device_properties(0).total_memory
        cap = (peaks["full"] + peaks["half"]) // 2
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(cap / total)
        obs.reset()
        start = time.perf_counter()
        rc = port_platform.GenericPlatform.calculate_cell_metrics(
            ["-i", bam, "-o", str(out / "oom_cell"), "-a", gtf])
        torch.cuda.synchronize()
        report.update(rc=rc, seconds=time.perf_counter() - start, peaks=peaks, records={"full": full, "half": half},
                      cap=cap, total=total, max_allocated=torch.cuda.max_memory_allocated())
    else:
        start = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = port_platform.TenXV2.attach_barcodes(attach_args(WORK / "analysis", out / "attach.bam"))
        torch.cuda.synchronize()
        report.update(rc=rc, seconds=time.perf_counter() - start)
    report["launches"] = dict(kernels.launches)
    report["counters"] = {k: v for k, v in obs.counters().items() if k.startswith(("guard_", "sched_fault_"))}
    report["classified"] = classified
    print("[worker] " + json.dumps(report), flush=True)
    return 0


def run_guard_worker(mode: str, out: Path, env: dict) -> dict:
    proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), GUARD_FLAG, mode, str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=WORK)
    try:
        text = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [line for line in text.splitlines() if line.startswith("[worker] ")]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"guard worker {mode}: rc {proc.returncode}\n{text[-4000:]}")
    report = json.loads(lines[0][len("[worker] "):])
    if report["rc"] != 0:
        raise AssertionError(f"guard worker {mode}: the command's rc {report['rc']}\n{text[-4000:]}")
    return report


def drop_records(src: Path, dst: Path, drop, sam) -> int:
    """``src`` without the records at the indices ``drop``, by the port's
    reader and writer; returns the records kept."""
    kept = 0
    with sam.AlignmentReader(str(src)) as reader:
        with sam.AlignmentWriter(str(dst), reader.header) as writer:
            for index, record in enumerate(reader):
                if index not in drop:
                    writer.write(record)
                    kept += 1
    return kept


def phase_guard(stamp: str, modules) -> None:
    """The guard ladder on the card; see the module docstring, phase 18."""
    import os

    import torch

    kernels, native, ingest, guard, sched, faults, launch, sam, xprof = modules
    phase_start = time.perf_counter()
    launches_before = dict(kernels.launches)
    root = WORK / GUARD_ROOT
    root.mkdir()
    base_env = {k: v for k, v in os.environ.items()
                if k not in TRACE_VARS and k not in WITNESS_VARS and k != "SCTOOLS_TPU_FAULTS"
                and not k.startswith("SCTOOLS_TPU_GUARD_") and k != "SCTOOLS_TPU_WIRE_OVERLAP"}
    steps = {}

    # (a) the fault cocktail, against a fault-free twin over the same chunks
    # less the two poisoned records, run on the blocking writeback
    begin = time.perf_counter()
    graph_path = root / "lock_graph.json"
    emitted = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "--emit-lock-graph",
                              str(graph_path), "sctools_tpu_torch"], cwd=REPO,
                             env=dict(base_env, SCTOOLS_TPU_SCX_CACHE="0"), capture_output=True, text=True,
                             timeout=300)
    if emitted.returncode != 0:
        raise AssertionError(f"--emit-lock-graph: rc {emitted.returncode}\n{emitted.stdout}{emitted.stderr}")
    graph = json.loads(graph_path.read_text())
    static_edges = {(e["from"], e["to"]) for e in graph["edges"]}
    chunks = sorted((WORK / "chunks").glob("chunk*.bam"))
    faulted, twin = root / "faulted", root / "twin"
    faulted.mkdir()
    (faulted / "chunks").symlink_to(WORK / "chunks")
    (twin / "chunks").mkdir(parents=True)
    for chunk in chunks[1:]:
        (twin / "chunks" / chunk.name).symlink_to(chunk)
    kept = drop_records(chunks[0], twin / "chunks" / chunks[0].name, set(GUARD_POISON), sam)
    steps["twin chunk"] = time.perf_counter() - begin
    spec = ";".join([f"device_oom@gatherer.dispatch:match={chunks[1].stem},times=1",
                     "xla_transient@gatherer.dispatch:times=1",
                     "xla_transient@gatherer.writeback:times=1",
                     f"stall@gatherer.dispatch:match={chunks[2].stem},times=1,secs=60"]
                    + [f"corrupt_record@gatherer.dispatch:match={chunks[0].stem},record={r}" for r in GUARD_POISON])
    gtf = str(WORK / "mito.gtf")

    def run_pair(workdir: Path, extra: dict) -> list:
        env = dict(base_env, SCTOOLS_TPU_TRACE=str(workdir), SCTOOLS_TPU_PULSE="1", SCTOOLS_TPU_LOCK_DEBUG="1",
                   SCTOOLS_TPU_LOCK_GRAPH=str(graph_path), SCTOOLS_TPU_FRAME_DEBUG="1",
                   SCTOOLS_TPU_GUARD_TIMEOUT_COMPUTE=GUARD_TIMEOUT_COMPUTE, **extra)
        procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), WORKER_FLAG, str(workdir), str(i),
                                   "2", gtf], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
                 for i in (0, 1)]
        reports = []
        try:
            for proc in procs:
                text = proc.communicate(timeout=600)[0]
                if proc.returncode != 0:
                    raise AssertionError(f"{workdir.name} worker: rc {proc.returncode}\n{text[-4000:]}")
                reports.append(worker_reports(workdir.name, text, 2)[1])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return reports

    begin = time.perf_counter()
    twin_reports = run_pair(twin, {"SCTOOLS_TPU_WIRE_OVERLAP": "0"})
    steps["twin run"] = time.perf_counter() - begin
    begin = time.perf_counter()
    reports = run_pair(faulted, {"SCTOOLS_TPU_FAULTS": spec})
    steps["faulted run"] = time.perf_counter() - begin

    begin = time.perf_counter()
    journal_dir = faulted / "sched-journal"
    journal = sched.Journal(str(journal_dir), worker_id="smoke-probe")
    tasks, states = journal.replay()
    by_name = {tasks[tid].name: st for tid, st in states.items()}
    if len(by_name) != len(chunks) or any(st.state != sched.COMMITTED for st in by_name.values()):
        raise AssertionError(f"not every chunk committed: { {n: st.state for n, st in by_name.items()} }")
    failed = [e for e in journal.events() if e.get("event") == "failed"]
    if failed or any(st.attempts != 1 for st in by_name.values()):
        raise AssertionError(f"the faults reached the scheduler: failed events {failed}, attempts "
                             f"{ {n: st.attempts for n, st in by_name.items()} }")
    from sctools_tpu_torch.guard.quarantine import load_quarantine

    entries = load_quarantine(str(journal_dir / "quarantine"))
    got = sorted((e["task"], e["record_start"], e["record_stop"]) for e in entries)
    if got != [(chunks[0].stem, r, r + 1) for r in GUARD_POISON] or \
            any(e["site"] != "gatherer.dispatch" or chunks[0].name not in e["name"] or not e["task_id"]
                for e in entries):
        raise AssertionError(f"the quarantine sidecars: {entries}")
    merged = {}
    for name, workdir in (("faulted", faulted), ("twin", twin)):
        merged[name] = workdir / "merged.csv.gz"
        launch.merge_sorted_csv_parts(str(workdir / "metrics.part*.csv.gz"), str(merged[name]),
                                      journal_dir=str(workdir / "sched-journal"), expected_parts=len(chunks))
    if read_csv(merged["faulted"])[0] != read_csv(merged["twin"])[0]:
        raise AssertionError("the faulted run's merged CSV differs from the fault-free twin's")
    registry = xprof.merge_registries(xprof.load_registries(str(faulted)))
    retraces = sum(row["retraces"] for row in registry["sites"].values())
    counters = collections.Counter()
    for report in reports:
        counters.update(report["counters"])
    if retraces or counters["guard_oom_bisections"] < 1 or counters["guard_transient_retries"] < 2 or \
            counters["guard_stalls"] < 1 or counters["guard_poison_records"] != len(GUARD_POISON):
        raise AssertionError(f"the ladder: {retraces} retraces, counters {dict(counters)}")
    dumps = sorted(faulted.glob("locks.*.json"))
    acquired, violations, blocking = set(), [], set()
    for path in dumps:
        dump = json.loads(path.read_text())
        acquired |= set(dump["acquires"])
        violations += dump["violations"]
        blocking |= {(e["from"], e["to"]) for e in dump["edges"] if not e["bounded"]}
    if len(dumps) != 2 or violations or not set(GUARD_LOCKS) <= acquired or not blocking <= static_edges:
        raise AssertionError(f"lock witness: {len(dumps)} dumps, violations {violations}, guard locks never "
                             f"acquired {sorted(set(GUARD_LOCKS) - acquired)}, edges outside the static graph "
                             f"{sorted(blocking - static_edges)}")
    stamped = sum(report["stamped"] for report in reports)
    if not stamped or any(report["frame_violations"] for report in reports):
        raise AssertionError(f"frame witness: {stamped} frames stamped, "
                             f"violations {[r['frame_violations'] for r in reports]}")
    audit_text = obs_cli(base_env, "audit", str(faulted))
    audit_json = obs_cli(base_env, "audit", str(faulted), "--json")
    if audit_text.returncode != 0 or "RESULT: EXACT" not in audit_text.stdout or audit_json.returncode != 0:
        raise AssertionError(f"obs audit: rc {audit_text.returncode}\n{audit_text.stdout}{audit_text.stderr}")
    records = json.loads(audit_json.stdout)["fleet"]["records"]
    if records["quarantined"] != len(GUARD_POISON) or \
            records["quarantined_reasons"] != {"PoisonData": len(GUARD_POISON)} or \
            records["decoded"] != records["computed"] + len(GUARD_POISON):
        raise AssertionError(f"obs audit's records: {records}")
    status = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.sched", "status", str(journal_dir)],
                            capture_output=True, text=True, cwd=REPO, env=base_env, timeout=120)
    if status.returncode != 0 or "poisoned record(s) quarantined" not in status.stdout:
        raise AssertionError(f"sched status: rc {status.returncode}\n{status.stdout}{status.stderr}")
    stalls = [flight_meta(path) for path in sorted(faulted.glob("flight.*.jsonl"))]
    stalls = [meta for meta in stalls if meta["reason"].startswith("stall@compute:gatherer.dispatch")]
    sections = stalls[0].get("sections") or {} if stalls else {}
    if not stalls or "gatherer.dispatch" not in (sections.get("guard_retries") or {}) or \
            sections.get("guard_degraded") != {} or "writeback_slots" not in sections:
        raise AssertionError(f"the stall's flight record: {len(stalls)} found, sections {sections}")
    launched = [r["launches"] for r in reports + twin_reports if any(r["launches"].values())]
    if launched:
        raise AssertionError(f"a sched worker launched a hand kernel: {launched}")
    steps["cocktail checks"] = time.perf_counter() - begin
    log(f"[guard] {stamp} | fault cocktail over phase 10's {len(chunks)} chunks, two witnessed traced workers "
        f"(SCTOOLS_TPU_GUARD_TIMEOUT_COMPUTE={GUARD_TIMEOUT_COMPUTE}): every task committed once, 0 failed events, "
        f"sidecars {got}, merged CSV = the fault-free twin's ({kept} records in its chunk0, blocking writeback), "
        f"{retraces} retraces, counters {dict(sorted(counters.items()))}")
    log(f"[guard] lock witness: 2 dumps, 0 violations, the guard's locks acquired {sorted(GUARD_LOCKS)}; frame "
        f"witness: {stamped} frames stamped, 0 stale reads; obs audit EXACT with records.quarantined:PoisonData = "
        f"{records['quarantined_reasons']['PoisonData']}; sched status names the quarantined records; the stall's "
        f"flight record carries guard_retries {sorted(sections['guard_retries'])}, guard_degraded {{}} and "
        f"{len(sections['writeback_slots'])} writeback ring(s); no hand kernel launched")

    # (b) a real out-of-memory, not an injected one
    begin = time.perf_counter()
    oom = run_guard_worker("oom", root / "oom", base_env)
    steps["real OOM"] = time.perf_counter() - begin
    genuine = [kind for name, kind in oom["classified"] if name == "torch.OutOfMemoryError"]
    if not genuine or set(genuine) != {"resource_exhausted"} or oom["counters"].get("sched_fault_device_oom") or \
            oom["counters"].get("guard_oom_bisections", 0) < 1 or any(oom["launches"].values()):
        raise AssertionError(f"the real OOM: classified {oom['classified']}, counters {oom['counters']}, "
                             f"launches {oom['launches']}")
    if read_csv(root / "oom" / "oom_cell.csv.gz")[0] != read_csv(WORK / "cli_cell.csv.gz")[0]:
        raise AssertionError("the capped CalculateCellMetrics CSV differs from phase 5's")
    log(f"[guard] {stamp} | real OOM: peak {oom['peaks']['full']} B for one full batch ({oom['records']['full']} "
        f"records padded to {METRICS_BATCH}), {oom['peaks']['half']} B for one 2^19 batch "
        f"({oom['records']['half']} records); cap {oom['cap']} B of {oom['total']} "
        f"(set_per_process_memory_fraction); CalculateCellMetrics under it in {oom['seconds']:.2f} s: "
        f"{len(genuine)} torch.OutOfMemoryError classified resource_exhausted, "
        f"{oom['counters'].get('guard_oom_bisections', 0)} bisection(s), max allocated {oom['max_allocated']} B, "
        f"the CSV equals phase 5's")

    # (c) the guarded kernel
    begin = time.perf_counter()
    attach = run_guard_worker("attach", root / "attach",
                              dict(base_env, SCTOOLS_TPU_FAULTS="xla_transient@whitelist.correct:times=1"))
    steps["guarded kernel"] = time.perf_counter() - begin
    batches = -(-ANALYSIS_READS // BATCH)
    if attach["counters"].get("guard_transient_retries") != 1 or \
            attach["launches"] != {"whitelist_correct": batches}:
        raise AssertionError(f"the guarded kernel: counters {attach['counters']}, launches {attach['launches']}, "
                             f"want 1 retry and {batches} launches")
    if (root / "attach" / "attach.bam").read_bytes() != (WORK / GUARD_IN / "attach_plain.bam").read_bytes():
        raise AssertionError("the guarded attach's BAM differs from phase 14's untraced one")
    log(f"[guard] {stamp} | attach -w of {ANALYSIS_READS} reads under xla_transient@whitelist.correct:times=1: "
        f"{attach['seconds']:.2f} s, 1 transient retry, {batches} kernel launches = batches, the BAM equals phase "
        f"14's untraced one byte for byte")

    # (d) the synthetic BAM generator, decoded by the ring
    begin = time.perf_counter()
    synth = root / "synth.bam"
    calls = native.calls["synth_bam"]
    written = native.synth_bam_native(str(synth), GUARD_SYNTH_CELLS)
    synth_s = time.perf_counter() - begin
    frames = ingest.ring_frames(str(synth), METRICS_BATCH)
    decoded, small = 0, None
    try:
        for frame in frames:
            decoded += frame.n_records
            if small is None:
                from sctools_tpu_torch.io.packed import copy_frame, slice_frame

                small = copy_frame(slice_frame(frame, 0, 64))
    finally:
        frames.close()
    if native.calls["synth_bam"] != calls + 1 or decoded != written or written != GUARD_SYNTH_CELLS * 32:
        raise AssertionError(f"synth_bam_native: {written} written, {decoded} decoded")
    steps["synth"] = time.perf_counter() - begin
    log(f"[guard] {stamp} | native.synth_bam_native: {GUARD_SYNTH_CELLS} cells, {written} records in "
        f"{synth_s:.3f} s, decoded by the ring: {decoded} records")

    # (e) what the ladder costs on the host when nothing fails
    faults.reset()
    if faults.armed():
        raise AssertionError("faults are armed in the smoke's own process")
    begin = time.perf_counter()
    for _ in range(GUARD_OVERHEAD_N):
        guard.run_batch(lambda sub, offset: None, small, site="smoke.overhead")
    run_batch_us = (time.perf_counter() - begin) / GUARD_OVERHEAD_N * 1e6
    begin = time.perf_counter()
    for _ in range(GUARD_OVERHEAD_N):
        guard.retrying(lambda: None, site="smoke.overhead")
    retrying_us = (time.perf_counter() - begin) / GUARD_OVERHEAD_N * 1e6
    from sctools_tpu_torch.obs import audit

    audit.reset()
    log(f"[guard] {stamp} | fault-free, faults unarmed, on this host: one guard.run_batch {run_batch_us:.3f} us, "
        f"one guard.retrying {retrying_us:.3f} us (mean of {GUARD_OVERHEAD_N} each)")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in this process: {kernels.launches}")
    torch.cuda.synchronize()
    log(f"[guard] {stamp} | step walls: " + ", ".join(f"{name} {s:.2f} s" for name, s in steps.items()))
    shutil.rmtree(WORK)
    log(f"[guard] phase 18 took {time.perf_counter() - phase_start:.1f} s")
    return attach["launches"]["whitelist_correct"]


DISCIPLINE_ROOT = "discipline"
DISCIPLINE_FLAG = "--discipline-worker"
DISCIPLINE_RECORDS = 1 << 17  # the witnessed reruns' library: phases 9 and 12 at a smaller depth
# the runs of each witness worker: a warm pass, then timed unwitnessed and
# witnessed passes in turns (plain, witnessed, witnessed, plain), the
# witness armed and disarmed in the process between them
DISCIPLINE_ARMS = ("warm", "plain", "witnessed", "witnessed2", "plain2")
MESH_VARS = ("SCTOOLS_TPU_MESH_DEBUG", "SCTOOLS_TPU_MESH_SCHEDULE")


def discipline_worker(argv) -> int:
    """One process of phase 19: ``mesh <workdir>`` runs phase 9's
    ``CalculateGeneMetrics --devices 2``, the preflight and the sample sort on
    a 2-shard card mesh; ``dist <workdir> <p> <coordinator> <card>`` joins
    the group on ``cuda:<card>`` and runs the preflight and phase 12's
    ``distributed_metrics_step`` on the global mesh. Each runs its work once
    per arm of ``DISCIPLINE_ARMS``, with ``SCTOOLS_TPU_MESH_DEBUG=1`` for the
    witnessed ones, and writes every arm's outputs. Its witness dumps
    ``mesh.<worker>.json`` into the trace dir at exit. Prints one ``[worker]
    {json}`` line: each arm's wall and preflight, the transport, the hand
    kernel launches at its start and end."""
    import os

    mode, workdir = argv[0], Path(argv[1])
    sys.path.insert(0, str(REPO))
    import torch

    from sctools_tpu_torch import kernels
    from sctools_tpu_torch import parallel as par
    from sctools_tpu_torch.analysis import meshwitness

    report = {"launches_start": dict(kernels.launches), "walls": {}, "preflight": {}}
    if mode == "mesh":
        from sctools_tpu_torch import platform as port_platform

        n_cards = torch.cuda.device_count()
        mesh = par.make_mesh(devices=[torch.device("cuda", i % n_cards) for i in range(MESH_SHARDS)])
        with np.load(workdir / "keys.npz") as f:
            keys = {name: f[name] for name in f.files}

        def run(arm):
            with mesh_for_devices(port_platform, mesh):
                rc = port_platform.GenericPlatform.calculate_gene_metrics(
                    ["-i", str(workdir / "gene.bam"), "-o", str(workdir / f"gene_{arm}"), "--devices",
                     str(MESH_SHARDS)])
            if rc != 0:
                raise AssertionError(f"calculate_gene_metrics --devices {MESH_SHARDS}: rc {rc}")
            preflight = par.collective_preflight(mesh)
            np.savez(workdir / f"sort_{arm}.npz", **par.stack_to_host(par.distributed_sort(keys, ["k1", "k2"], mesh)))
            return preflight
    else:
        process_id, coordinator, card = int(argv[2]), argv[3], int(argv[4])
        device = torch.device("cuda", card)
        report["transport"] = par.initialize_distributed(coordinator, DIST_PROCESSES, process_id, device=device,
                                                         timeout=300.0)
        mesh = par.global_mesh(devices=[device])
        with np.load(workdir / "stacked.npz") as f:
            local = {name: f[name][mesh.local_shards] for name in f.files}
        batch = par.host_local_to_global(local, mesh)

        def run(arm):
            preflight = par.collective_preflight(mesh)
            out = {}
            for kind, result in zip(("cell", "gene"), par.distributed_metrics_step(batch, mesh)):
                for row, columns in par.addressable_to_host(result).items():
                    out.update({f"{kind}/{row}/{name}": value for name, value in columns.items()})
            np.savez(workdir / f"dist{process_id}_{arm}.npz", **out)
            return preflight

    for arm in DISCIPLINE_ARMS:
        os.environ[meshwitness.ENV_FLAG] = "1" if arm.startswith("witnessed") else "0"
        torch.cuda.synchronize()
        begin = time.perf_counter()
        report["preflight"][arm] = run(arm)
        torch.cuda.synchronize()
        report["walls"][arm] = time.perf_counter() - begin
    if mode == "dist":
        par.sync_processes("discipline-done")
        par.distributed.shutdown()
    report["launches_end"] = dict(kernels.launches)
    print("[worker] " + json.dumps(report), flush=True)
    return 0


def run_discipline_workers(jobs, env: dict) -> dict:
    """Start the ``(name, argv)`` workers together, wait for them, and
    return each one's report; any failure or leftover process fails."""
    procs = {name: subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), DISCIPLINE_FLAG, *args],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                    env=dict(env, SCTOOLS_TPU_TRACE_WORKER=name))
             for name, args in jobs}
    try:
        outputs = {name: proc.communicate(timeout=600)[0] for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    reports = {}
    for name, proc in procs.items():
        lines = [line for line in outputs[name].splitlines() if line.startswith("[worker] ")]
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"discipline worker {name}: rc {proc.returncode}\n{outputs[name][-4000:]}")
        reports[name] = json.loads(lines[0][len("[worker] "):])
        if any(reports[name]["launches_start"].values()) or any(reports[name]["launches_end"].values()):
            raise AssertionError(f"discipline worker {name} launched a hand kernel: {reports[name]}")
    return reports


def same_arrays(name: str, a: Path, b: Path) -> None:
    with np.load(a) as left, np.load(b) as right:
        if sorted(left.files) != sorted(right.files) or not all(
                left[k].dtype == right[k].dtype and left[k].tobytes() == right[k].tobytes() for k in left.files):
            raise AssertionError(f"{name}: {a.name} and {b.name} differ")


def retune_copy(run_dir: Path, tree: Path, env: dict) -> dict:
    """``--retune run_dir`` against the copy of the port under ``tree``: a
    dry run, then an applied one (exit 0, or 5 with the copy's segments file
    restored byte for byte). Returns each run's exit, seconds and lines, the
    dry run's derived moves and the copy's pins after the applied run."""
    segments = tree / "sctools_tpu_torch" / "ops" / "segments.py"
    before = segments.read_bytes()
    runs = {}
    for arm, extra in (("dry run", ["--retune-dry-run"]), ("applied", [])):
        begin = time.perf_counter()
        done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "--retune", str(run_dir), *extra,
                               str(tree / "sctools_tpu_torch")], cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        runs[arm] = (done.returncode, time.perf_counter() - begin,
                     [line for line in done.stdout.splitlines() if line.startswith("scx-cost --retune:")])
        if done.returncode not in ((0,) if extra else (0, 5)):
            raise AssertionError(f"--retune ({arm}): rc {done.returncode}\n{done.stdout[-3000:]}{done.stderr[-2000:]}")
    derived = dict(re.findall(r"(RECORD_BUCKET_MIN|ENTITY_BUCKET_MIN): (\d+ -> \d+|\d+ \(unchanged\))",
                              "\n".join(runs["dry run"][2])))
    pinned = dict(re.findall(r"^(RECORD_BUCKET_MIN|ENTITY_BUCKET_MIN) = (\d+)$", segments.read_text(), re.M))
    if runs["applied"][0] == 5:
        if segments.read_bytes() != before:
            raise AssertionError("--retune: a gate rejected the edit and the copy was not restored")
    elif {name: move.split(" -> ")[-1].split()[0] for name, move in derived.items()} != pinned:
        raise AssertionError(f"--retune: pinned {pinned}, the dry run derived {derived}")
    return {"runs": runs, "derived": derived, "pinned": pinned}


def shape_check(root: Path, registries: dict, contract: dict, env: dict, stamp: str, port_xprof, shardcheck) -> None:
    """Phase 19 (b) and (b'): every signature in ``registries`` inside
    ``contract``; then ``--retune`` against a copy of the port, over all of
    them and over phase 17's static serve fleet's alone, the repository's
    own ``ops/segments.py`` untouched."""
    # every signature the traced workers recorded is inside the contract
    sites = port_xprof.merge_registries(list(registries.values()))["sites"]
    observed = {name: len(row.get("signatures") or {}) for name, row in sites.items() if row.get("signatures")}
    violations = shardcheck.check_signatures(contract, sites)
    want = {"metrics.compute_entity_metrics", "metrics.compact_results_wire", "ops.count_molecules",
            "whitelist.correct_pallas", "parallel.sharded_metrics"}
    if violations or not want <= set(observed):
        raise AssertionError(f"the shape contract: {violations}; observed {observed}")
    log(f"[discipline] {stamp} | phases 14-15's and 17's traced registries ({len(registries)} workers): "
        f"{sum(observed.values())} signatures at {len(observed)} sites, 0 outside the shape contract: "
        + ", ".join(f"{name} {n}" for name, n in sorted(observed.items())))

    # (b') the autotuner against a copy of the port: over every traced
    # registry, then over the static serve fleet's, whose small packs pad
    # 4,096 rows for ~1,350 real (phase 17)
    tree = root / "retune_tree"
    shutil.copytree(REPO / "sctools_tpu_torch", tree / "sctools_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so", "*.o"))
    own = (REPO / "sctools_tpu_torch" / "ops" / "segments.py").read_bytes()
    sets = {"all": registries, "static serve fleet": {k: v for k, v in registries.items()
                                                       if k.startswith("steer-static-")}}
    for label, chosen in sets.items():
        run_dir = root / f"registries-{len(label)}"
        run_dir.mkdir()
        for name, data in chosen.items():
            (run_dir / f"xprof.{name}.json").write_text(json.dumps(data))
        result = retune_copy(run_dir, tree, env)
        for arm, (rc, seconds, lines) in result["runs"].items():
            log(f"[discipline] {stamp} | --retune ({arm}) over {label} ({len(chosen)} registries) against a copy "
                f"of sctools_tpu_torch: exit {rc} in {seconds:.2f} s")
            for line in lines:
                log(f"[discipline]   {line}")
        log(f"[discipline] {stamp} | {label}: derived constants {result['derived']}; the copy's segments.py then "
            f"pins {result['pinned']}")
    if (REPO / "sctools_tpu_torch" / "ops" / "segments.py").read_bytes() != own:
        raise AssertionError("--retune touched the repository's own ops/segments.py")
    log(f"[discipline] {stamp} | the repository's own ops/segments.py is unchanged")
    shutil.rmtree(tree)


SEEDED_LINT = {
    "boundary.py": "from sctools_tpu_torch import ingest\n\n\ndef stage(cols, device):\n    try:\n"
                   "        return ingest.upload(cols, device, site=\"seeded.stage\")\n    except Exception:\n"
                   "        return None\n",
    "pull.py": "from sctools_tpu_torch.ops.whitelist import correct_codes\n\n\ndef pull(queries, table):\n"
               "    codes = correct_codes(queries, table)\n    return codes.cpu()\n",
}


def rule_checks(root: Path, env: dict) -> tuple:
    """``--list-rules`` against the passes' own rule tables, and the lint's
    SCX113 and SCX114 and the tsan.supp audit firing on a seeded corpus: a
    swallowed upload (SCX113), a bare pull of a kernel's result (SCX114) and
    a stale tsan.supp entry (SCX302). Prints whether this host's g++ resolves the
    sanitizer runtimes (information: no sanitizer leg runs here). Returns
    the seconds and the seeded findings' rules."""
    from sctools_tpu_torch.analysis import (ABI_RULES, AOT_RULES, COST_RULES, LIFE_RULES, MESH_RULES,
                                            RACE_RULES, SHARD_RULES, SUPP_RULES, TORCH_RULES)
    from sctools_tpu_torch.native import sanitize

    begin = time.perf_counter()
    listed = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "--list-rules"], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    catalog = {line.split()[0] for line in listed.stdout.splitlines() if line.startswith("    SCX")}
    tables = set().union(TORCH_RULES, ABI_RULES, SUPP_RULES, RACE_RULES, SHARD_RULES, LIFE_RULES, COST_RULES,
                         MESH_RULES, AOT_RULES)
    if listed.returncode != 0 or catalog != tables:
        raise AssertionError(f"--list-rules: rc {listed.returncode}, listed {sorted(catalog ^ tables)} apart from "
                             f"the passes' tables\n{listed.stdout[-2000:]}{listed.stderr[-2000:]}")
    corpus = root / "seeded"
    (corpus / "native").mkdir(parents=True)
    for name, text in SEEDED_LINT.items():
        (corpus / name).write_text(text)
    (corpus / "native" / "lib.cpp").write_text('extern "C" long scx_seeded(long n) { return n; }\n')
    (corpus / "native" / "tsan.supp").write_text("race:scx_seeded\nrace:scx_long_gone\n")
    done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "--json", "--no-abi", "--no-race",
                           "--no-shard", "--no-life", "--no-cost", "--no-mesh", "--no-aot", "--native-dir",
                           str(corpus / "native"), str(corpus)], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    found = sorted((f["rule"], Path(f["path"]).name, f["line"]) for f in json.loads(done.stdout or "{}").get(
        "findings", []))
    if done.returncode != 1 or found != [("SCX113", "boundary.py", 7), ("SCX114", "pull.py", 6),
                                         ("SCX302", "tsan.supp", 2)]:
        raise AssertionError(f"the seeded corpus: rc {done.returncode}, {found}\n{done.stderr[-2000:]}")
    runtimes = {name: sanitize.runtime(name) for name in ("libtsan.so", "libasan.so", "libubsan.so")}
    log("[discipline] sanitizer runtimes (information; the legs, python -m sctools_tpu_torch.native.sanitize, "
        "do not run here): " + ", ".join(f"{name} {path or 'not resolved'}" for name, path in runtimes.items()))
    return time.perf_counter() - begin, [rule for rule, _, _ in found]


def phase_discipline(rng, stamp: str, modules, ledger: dict, registries: dict) -> None:
    """The static checks' runtime halves and the collective witness on the card.

    (a) The gate (``python -m sctools_tpu_torch.analysis --json``, every pass
    with scx-shard, scx-cost, scx-mesh and scx-aot) over the port and this
    script, and the three emitters into the run directory. (b) The transfer
    inventory against ``ledger``, the merged ledgers of phases 14-15's
    traced workers: no phantom site, no wrong direction; the shape contract
    against ``registries``, their xprof registries and phase 17's serve
    workers': every signature admitted. (b') The autotuner against a copy
    of the port, over those registries and over phase 17's static fleet's:
    a dry run, then an applied run whose gates pass or restore the copy's
    segments file byte for byte. (c) Phase 9's ``--devices 2`` gene
    command, preflight and sample sort in one worker, and phase 12's two
    joined processes, at a smaller depth, each unwitnessed then under
    ``SCTOOLS_TPU_MESH_DEBUG=1`` with the emitted schedule and a trace dir:
    every dump non-empty with 0 violations, the two processes' schedules
    identical, every observed pair inside the static schedule, every
    witnessed output byte-equal to the unwitnessed one, and ``obs
    efficiency`` printing the collectives section from the port's dumps."""
    import os
    import socket

    import torch

    kernels, bgzf, packed, port_gatherer, port_par, port_xprof = modules
    from sctools_tpu_torch.analysis import costcheck, meshwitness, shardcheck

    phase_start = time.perf_counter()
    launches_before = dict(kernels.launches)
    root = WORK / DISCIPLINE_ROOT
    root.mkdir(parents=True)
    base_env = {k: v for k, v in os.environ.items() if k not in TRACE_VARS + WITNESS_VARS + MESH_VARS}
    base_env["SCTOOLS_TPU_SCX_CACHE"] = str(root / "scx_cache")

    # (a) the gate and the emitters, as a user runs them
    begin = time.perf_counter()
    gate = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "--json", "sctools_tpu_torch",
                           "chip_smoke.py"], cwd=REPO, env=base_env, capture_output=True, text=True, timeout=300)
    gate_s = time.perf_counter() - begin
    if gate.returncode != 0 or json.loads(gate.stdout)["findings"]:
        raise AssertionError(f"the gate: rc {gate.returncode}\n{gate.stdout[-3000:]}{gate.stderr[-2000:]}")
    checked = json.loads(gate.stdout)["checked_files"]
    rules_s, seeded = rule_checks(root, base_env)
    emitted = {}
    # the shape contract is the package's, the one its manifest holds
    for flag, name, paths in (("--emit-transfer-inventory", "transfer_inventory.json", ["chip_smoke.py"]),
                              ("--emit-collective-schedule", "collective_schedule.json", ["chip_smoke.py"]),
                              ("--emit-shape-contract", "shape_contract.json", [])):
        done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", flag, str(root / name),
                               "sctools_tpu_torch", *paths], cwd=REPO, env=base_env, capture_output=True,
                              text=True, timeout=300)
        if done.returncode != 0:
            raise AssertionError(f"{flag}: rc {done.returncode}\n{done.stdout[-2000:]}{done.stderr[-2000:]}")
        emitted[name] = json.loads((root / name).read_text())
    inventory, schedule = emitted["transfer_inventory.json"], emitted["collective_schedule.json"]
    contract = emitted["shape_contract.json"]
    with open(REPO / "sctools_tpu_torch" / "serve" / "graph_manifest.json", encoding="utf-8") as f:
        if json.load(f)["contract"] != contract:
            raise AssertionError("the emitted shape contract is not the committed graph manifest's")
    log(f"[discipline] {stamp} | the gate (lint, abi, supp, race, shard, life, cost, mesh, aot) over {checked} "
        f"files: 0 findings in {gate_s:.2f} s; --list-rules names the passes' tables and a seeded corpus gives "
        f"{seeded} ({rules_s:.2f} s); "
        f"{len(inventory['sites'])} transfer sites inventoried, {len(schedule['collectives'])} collective pairs "
        f"over {len(schedule['regions'])} mapped regions, {len(contract['sites'])} sites in the shape contract (the "
        f"committed manifest's) "
        f"({sum(s['dims'] == 'bucketed' for s in contract['sites'].values())} bucketed, "
        f"{sum(s['sharded'] for s in contract['sites'].values())} sharded)")

    # (b) every site the traced workers' ledgers saw is in the inventory
    seen = {(direction, site) for direction, total in ledger.items() for site in total["by_site"]}
    violations = costcheck.check_transfer_sites(inventory, ledger)
    want_sites = {("h2d", "gatherer.upload"), ("d2h", "gatherer.writeback"), ("h2d", "count.upload"),
                  ("d2h", "count.writeback"), ("h2d", "whitelist.queries"), ("d2h", "whitelist.queries"),
                  ("h2d", "whitelist.table")}
    if violations or not want_sites <= seen:
        raise AssertionError(f"transfer sites: {violations}; seen {sorted(seen)}")
    log(f"[discipline] {stamp} | phases 14-15's traced ledgers (attach, cell, count, serve, sched): "
        f"{len(seen)} (direction, site) pairs, 0 phantom sites, 0 wrong directions: "
        + ", ".join(f"{d} {site}" for d, site in sorted(seen)))
    shape_check(root, registries, contract, base_env, stamp, port_xprof, shardcheck)

    # (c) the inputs of the witnessed reruns
    begin = time.perf_counter()
    reads = make_reads(rng, DISCIPLINE_RECORDS)
    write_tagged_bam(root / "gene.bam", rng, sort_reads(reads, "gene"), bgzf)
    write_tagged_bam(root / "cell.bam", rng, sort_reads(reads, "cell"), bgzf)
    frames = packed.iter_frames_from_bam(str(root / "cell.bam"), 2 * DISCIPLINE_RECORDS, want_qname=False)
    frame = next(frames)
    frames.close()
    cols = port_gatherer._pad_columns(frame, np.zeros(len(frame.gene_names), dtype=bool))[0]
    np.savez(root / "stacked.npz", **port_par.partition_columns(cols, DIST_PROCESSES, key="cell",
                                                                shard_size=DISCIPLINE_RECORDS))
    n = frame.n_records - frame.n_records % MESH_SHARDS
    np.savez(root / "keys.npz", k1=frame.cell[:n].reshape(MESH_SHARDS, -1),
             k2=frame.umi[:n].reshape(MESH_SHARDS, -1),
             payload=np.arange(n, dtype=np.int32).reshape(MESH_SHARDS, -1),
             valid=np.ones((MESH_SHARDS, n // MESH_SHARDS), dtype=bool))
    inputs_s = time.perf_counter() - begin

    # (d) the reruns, each worker in a process of its own
    trace = root / "trace"
    env = dict(base_env, SCTOOLS_TPU_TRACE=str(trace),
               SCTOOLS_TPU_MESH_SCHEDULE=str(root / "collective_schedule.json"))
    n_cards = torch.cuda.device_count()
    cards, transport = ((0, 1), "nccl") if n_cards >= DIST_PROCESSES else ((0, 0), "gloo")
    begin = time.perf_counter()
    reports = run_discipline_workers([("mesh", ["mesh", str(root)])], env)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    reports.update(run_discipline_workers(
        [(f"dist{p}", ["dist", str(root), str(p), coordinator, str(card)]) for p, card in enumerate(cards)], env))
    workers_s = time.perf_counter() - begin
    if any(reports[f"dist{p}"]["transport"] != transport for p in range(DIST_PROCESSES)):
        raise AssertionError(f"dist workers' transports, want {transport}: {reports}")

    # the dumps: non-empty, 0 violations, inside the static schedule, the
    # two processes' schedules identical
    dumps = meshwitness.load_dumps(str(trace))
    if set(dumps) != {"mesh", "dist0", "dist1"}:
        raise AssertionError(f"mesh dumps {sorted(dumps)}")
    static = {tuple(pair) for pair in schedule["collectives"]}
    want_regions = {
        "mesh": ("parallel.metrics._build_sharded_metrics.run", "parallel.mesh.collective_preflight.preflight",
                 "parallel.sort._build_sample_sort.run"),
        "dist0": ("parallel.mesh.collective_preflight.preflight", "parallel.metrics._build_distributed_step.step"),
    }
    want_regions["dist1"] = want_regions["dist0"]
    issued = {}
    for worker, dump in dumps.items():
        if dump["violations"] or not dump["schedules"] or not dump["sequence"]:
            raise AssertionError(f"{worker}: violations {dump['violations']}, schedules {sorted(dump['schedules'])}")
        labels = {"sctools_tpu_torch." + label for label in want_regions[worker]}
        if not labels <= set(dump["schedules"]) or not set(dump["schedules"]) <= set(schedule["regions"]):
            raise AssertionError(f"{worker}: regions {sorted(dump['schedules'])}, static {schedule['regions']}")
        pairs = {(e["name"], e["axis"]) for rows in dump["schedules"].values() for row in rows for e in row["entries"]}
        outside = {pair for pair in pairs if pair not in static and (pair[0], "*") not in static}
        if outside or not pairs:
            raise AssertionError(f"{worker}: observed pairs {sorted(pairs)} outside the static schedule: {outside}")
        issued[worker] = sum(dump["counts"].values())
    per_region = {worker: {label: sorted(json.dumps(row["entries"], sort_keys=True) for row in rows)
                           for label, rows in dumps[worker]["schedules"].items()} for worker in ("dist0", "dist1")}
    if per_region["dist0"] != per_region["dist1"]:
        raise AssertionError(f"the two processes' schedules differ: {per_region}")

    # witnessed outputs = unwitnessed outputs, byte for byte
    gene = {arm: gzip.decompress((root / f"gene_{arm}.csv.gz").read_bytes()) for arm in DISCIPLINE_ARMS}
    if len(set(gene.values())) != 1:
        raise AssertionError("calculate_gene_metrics --devices 2: the arms' CSVs differ")
    for arm in DISCIPLINE_ARMS[1:]:
        same_arrays("distributed_sort", root / "sort_warm.npz", root / f"sort_{arm}.npz")
        for p in range(DIST_PROCESSES):
            same_arrays(f"dist worker {p}", root / f"dist{p}_warm.npz", root / f"dist{p}_{arm}.npz")
    for worker, report in reports.items():
        if len({json.dumps(v, sort_keys=True) for v in report["preflight"].values()}) != 1:
            raise AssertionError(f"{worker}: preflights {report['preflight']}")

    # obs efficiency reads the port's dumps
    done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.obs", "efficiency", str(trace), "--json"],
                          cwd=REPO, env=base_env, capture_output=True, text=True, timeout=120)
    text = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.obs", "efficiency", str(trace)], cwd=REPO,
                          env=base_env, capture_output=True, text=True, timeout=120)
    section = json.loads(done.stdout)["collectives"] if done.returncode == 0 else None
    if not section or section["violations"] or set(section["workers"]) != set(dumps) or \
            text.returncode != 0 or "collectives (mesh witness" not in text.stdout:
        raise AssertionError(f"obs efficiency: {done.returncode} {section}\n{text.stdout[-2000:]}")
    line = next(row for row in text.stdout.splitlines() if "collectives (mesh witness" in row)

    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the discipline phase: {kernels.launches}")
    log(f"[discipline] {stamp} | witnessed reruns of {frame.n_records} records (inputs {inputs_s:.2f} s): "
        f"'mesh' (--devices {MESH_SHARDS} gene, preflight, sample sort on {MESH_SHARDS} shards) and 'dist0'/'dist1' "
        f"(preflight and distributed_metrics_step, {DIST_PROCESSES} processes on {['cuda:%d' % c for c in cards]} "
        f"over {transport}) in {workers_s:.2f} s; dumps non-empty, 0 violations, every pair inside the static "
        f"schedule, the two processes' per-region schedules identical, witnessed outputs byte-equal to unwitnessed; "
        f"collectives issued a worker {issued}")
    for worker, report in sorted(reports.items()):
        walls = report["walls"]
        plain, witnessed = walls["plain"] + walls["plain2"], walls["witnessed"] + walls["witnessed2"]
        log(f"[discipline] {stamp} | {worker}: walls in turns, unwitnessed {walls['plain']:.3f} s, witnessed "
            f"{walls['witnessed']:.3f} s, witnessed {walls['witnessed2']:.3f} s, unwitnessed {walls['plain2']:.3f} s "
            f"(witnessed {100 * (witnessed / plain - 1):+.1f}% over the pairs), warm pass {walls['warm']:.3f} s")
    log(f"[discipline] obs efficiency: {line.strip()}")
    shutil.rmtree(WORK)
    log(f"[discipline] phase 19 took {time.perf_counter() - phase_start:.1f} s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reads", type=int, default=4 * BATCH)
    args = parser.parse_args(argv)

    import torch

    smoke_start = time.perf_counter()
    sms, clock_hz = phase_device()
    stamp = nvidia_smi("name,power.limit")
    if not (REPO / "sctools_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no sctools_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import count as port_count
    from sctools_tpu_torch import fastqprocess as port_fqp
    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import kernels, native
    from sctools_tpu_torch import platform as port_platform
    from sctools_tpu_torch import bam as port_bam
    from sctools_tpu_torch import fastq as port_fastq
    from sctools_tpu_torch import samplefastq as port_sample
    from sctools_tpu_torch.io import bgzf, packed, sam
    from sctools_tpu_torch.metrics import device as port_device
    from sctools_tpu_torch.metrics import gatherer as port_gatherer
    from sctools_tpu_torch.metrics import merge as port_merge
    from sctools_tpu_torch.ops import counting as port_counting
    from sctools_tpu_torch.ops import segments as port_seg
    from sctools_tpu_torch.ops import whitelist as wl_ops
    from sctools_tpu_torch import parallel as port_par
    from sctools_tpu_torch.parallel import gatherer as port_par_gatherer
    from sctools_tpu_torch.parallel import launch as port_launch
    from sctools_tpu_torch import sched as port_sched
    from sctools_tpu_torch.metrics import collective as port_collective
    from sctools_tpu_torch.serve import graphs as port_graphs

    phase_build(kernels, native)
    rng = np.random.default_rng(args.seed)
    whitelist_ascii = make_whitelist(rng, WHITELIST_SIZE, CB_LEN)
    table, measured = phase_kernel(rng, whitelist_ascii, sms, clock_hz, wl_ops)
    launches = phase_attach(
        rng, whitelist_ascii, args.reads, table, measured["ms"], stamp,
        (kernels, native, wl_ops, port_platform, port_bam, port_fastq, bgzf, sam),
    )
    csvs = phase_metrics(
        np.random.default_rng(args.seed + 1), stamp,
        (kernels, native, port_platform, port_gatherer, port_device, port_gtf, port_seg, bgzf, packed, sam),
    )
    phase_count(
        np.random.default_rng(args.seed + 2), stamp,
        (kernels, native, port_platform, port_count, port_counting, port_merge, port_gtf, bgzf, packed), csvs,
    )
    fastq_launches, bam_shards = phase_fastq(
        np.random.default_rng(args.seed + 3), whitelist_ascii, table, stamp,
        (kernels, native, wl_ops, port_platform, port_fqp, port_sample, bgzf, sam),
    )
    phase_sort(
        np.random.default_rng(args.seed + 4), stamp,
        (kernels, native, port_platform, port_bam, bgzf, sam), bam_shards,
    )
    phase_mesh(stamp, (kernels, port_platform, port_par, port_par_gatherer, port_gatherer, port_gtf, packed))
    phase_sched(stamp, (port_platform, port_sched, port_launch, port_collective))
    phase_serve(np.random.default_rng(args.seed + 5), stamp,
                (port_platform, port_sched, port_launch, port_gatherer, port_device, port_seg, port_graphs, packed,
                 bgzf))
    phase_dist(stamp, (kernels, port_par, port_gatherer, port_gtf, packed))
    analysis_launches = phase_analysis(np.random.default_rng(args.seed + 6), whitelist_ascii, stamp,
                                       (kernels, port_launch, bgzf))
    from sctools_tpu_torch import obs as port_obs
    from sctools_tpu_torch.obs import delta as port_delta
    from sctools_tpu_torch.obs import pulse as port_pulse
    from sctools_tpu_torch.obs import slo as port_slo

    tracing_launches, traced = phase_tracing(np.random.default_rng(args.seed + 7), stamp,
                                             (kernels, bgzf, port_obs, port_pulse, port_delta, port_slo))
    from sctools_tpu_torch.obs import fleet as port_fleet

    traced_ledger, traced_registries = phase_efficiency(
        stamp, (kernels, port_obs, port_pulse, port_delta, port_sched, port_fleet), traced)
    from sctools_tpu_torch.obs import audit as port_audit

    phase_audit(stamp, (kernels, port_obs, port_audit, port_sched, port_launch, port_gtf))
    from sctools_tpu_torch import steer as port_steer
    from sctools_tpu_torch.obs import xprof as port_xprof
    from sctools_tpu_torch.serve import cli as port_serve_cli
    from sctools_tpu_torch.serve import manifest as port_manifest

    from sctools_tpu_torch.analysis import shardcheck as port_shardcheck

    steer_registries = phase_steer(stamp, (kernels, bgzf, port_pulse, port_xprof, port_steer, port_manifest,
                                           port_sched, port_serve_cli, port_platform, port_shardcheck))
    from sctools_tpu_torch import guard as port_guard
    from sctools_tpu_torch import ingest as port_ingest
    from sctools_tpu_torch.sched import faults as port_faults

    guard_launches = phase_guard(stamp, (kernels, native, port_ingest, port_guard, port_sched, port_faults, port_launch,
                                         sam, port_xprof))
    phase_discipline(np.random.default_rng(args.seed + 8), stamp,
                     (kernels, bgzf, packed, port_gatherer, port_par, port_xprof), traced_ledger,
                     {**traced_registries, **steer_registries})
    record = {
        "name": "whitelist_correct",
        "route": "cuda",
        "source": "sctools_tpu_torch/csrc/whitelist_correct.cu",
        "replaces": "sctools_tpu/ops/whitelist.py:125",
        # every main-path run of the smoke: attach and its library leg's
        # attach (the library route itself launches none), FastqProcess in both
        # formats, SampleFastq, the analysis phase's witnessed attach, the
        # tracing phase's two, which the efficiency phase reads, and the
        # guard phase's attach under a transient (the metrics, count, sort,
        # mesh, sched, serve, dist and discipline paths launch none)
        "launches": launches["whitelist_correct"] + fastq_launches + analysis_launches + tracing_launches
        + guard_launches,
        "verdict": "exact",
        **measured,
    }
    log(f"[smoke] phases 1-19 took {time.perf_counter() - smoke_start:.1f} s")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [WORKER_FLAG]:  # one of phase 10's worker processes
        sys.exit(sched_worker(sys.argv[2:]))
    if sys.argv[1:2] == [SERVE_FLAG]:  # one of phase 11's worker processes
        sys.exit(serve_worker(sys.argv[2:]))
    if sys.argv[1:2] == [DIST_FLAG]:  # one of phase 12's worker processes
        sys.exit(dist_worker(sys.argv[2:]))
    if sys.argv[1:2] == [ANALYSIS_FLAG]:  # one of phase 13's worker processes
        sys.exit(analysis_worker(sys.argv[2:]))
    if sys.argv[1:2] == [TRACE_FLAG]:  # one of phase 14's worker processes
        sys.exit(trace_worker(sys.argv[2:]))
    if sys.argv[1:2] == [GUARD_FLAG]:  # one of phase 18's worker processes
        sys.exit(guard_worker(sys.argv[2:]))
    if sys.argv[1:2] == [DISCIPLINE_FLAG]:  # one of phase 19's worker processes
        sys.exit(discipline_worker(sys.argv[2:]))
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException as error:  # any failed phase: report it, print no result
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {error}", file=sys.stderr)
        sys.exit(1)
