#!/usr/bin/env python3
"""Time variants of the port's whitelist kernel on one NVIDIA GPU.

Run from the root of a checkout:

    python3 whitelist_variants.py [NAME ...]

Each variant is ``sctools_tpu_torch/csrc/whitelist_correct.cu`` with a few
text substitutions (the script stops if one no longer applies):

- ``kernel``: the source as it is;
- ``no_epilogue``: the accumulators are never read out (only the product
  and the TMA pipeline run; the answers are wrong);
- ``no_wgmma``: the product is never issued (only the epilogue and the
  pipeline run, on stale accumulators; the answers are wrong);
- ``rows256`` / ``rows128``: query stages of at most 256 / of 128 rows;
- ``stages3``: at most 3 stages in the ring;
- ``max_chain``: two-input ``max`` in place of ``__vimax3_s32``;
- ``fold_chains``: the fold as eight chains over all 64 scores, then a
  tail and a tree (37 instructions instead of 32).

All are built with nvcc in parallel into ``sctools_tpu_torch/_build/variants``
(the build prints each variant's ptxas registers and any C7514 warning, which
says ptxas serialized the ``wgmma`` s). Each then runs in its own process
under a 60 s timeout, in two rounds, forward and reverse: its C entry point
on a pre-expanded query block at the 10x v2 shape (65,536 queries x a
737,280-barcode synthetic whitelist, L = 16), 20 launches timed twice with
CUDA events, then the index block compared with the plain version there and
on ragged cases at L = 1, 17 and 64. The SM clock and power after each run
come from nvidia-smi.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SOURCE = REPO / "sctools_tpu_torch" / "csrc" / "whitelist_correct.cu"
BUILD = REPO / "sctools_tpu_torch" / "_build" / "variants"
FOLD = """\
  for (int k = 0; k < 8; ++k) {
    part[k] = __vimax3_s32(d[k], d[8 + k], d[16 + k]);
    part[k] = __vimax3_s32(part[k], d[24 + k], d[32 + k]);
    part[k] = __vimax3_s32(part[k], d[40 + k], d[48 + k]);
  }
  const int a0 = __vimax3_s32(part[0], part[1], d[56]), a1 = __vimax3_s32(part[2], part[3], d[57]);
  const int a2 = __vimax3_s32(part[4], part[5], d[58]), a3 = __vimax3_s32(part[6], part[7], d[59]);
  const int b0 = __vimax3_s32(a0, a1, d[60]), b1 = __vimax3_s32(a2, a3, d[61]);
  return max(__vimax3_s32(b0, b1, d[62]), d[63]);
"""
FOLD_CHAINS = """\
  for (int k = 0; k < 8; ++k) part[k] = d[k];
#pragma unroll
  for (int i = 8; i + 16 <= 64; i += 16) {
#pragma unroll
    for (int k = 0; k < 8; ++k) part[k] = __vimax3_s32(part[k], d[i + k], d[i + 8 + k]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) part[k] = max(part[k], d[56 + k]);
  return max(__vimax3_s32(part[0], part[1], part[2]),
             max(__vimax3_s32(part[3], part[4], part[5]), max(part[6], part[7])));
"""
WIDE_STAGES = "kRoom / (512 * kKpad) >= 2   ? 512"
VARIANTS = {
    "kernel": [],
    "no_epilogue": [("if (fragment_max(d) >= threshold)", "if (d[0] == -7)")],
    "no_wgmma": [("wgmma_s8(d, smem_desc(", "if (threshold < -5) wgmma_s8(d, smem_desc(")],
    "rows256": [(WIDE_STAGES, "false ? 512")],
    "rows128": [(WIDE_STAGES, "false ? 512"), ("kRoom / (256 * kKpad) >= 2 ? 256", "false ? 256")],
    "stages3": [("kMaxStages = 6;", "kMaxStages = 3;")],
    "max_chain": [("__vimax3_s32(", "max3("),
                  ("__device__ __forceinline__ int fragment_max(",
                   "__device__ __forceinline__ int max3(int a, int b, int c) {\n"
                   "  return max(max(a, b), c);\n}\n\n"
                   "__device__ __forceinline__ int fragment_max(")],
    "fold_chains": [(FOLD, FOLD_CHAINS)],
}


def build(name: str):
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import kernels

    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is no longer in {SOURCE.name}")
        text = text.replace(old, new)
    source = BUILD / f"{name}.cu"
    source.write_text(text)
    result = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(BUILD / f"{name}.so"),
         str(source)], capture_output=True, text=True)
    output = result.stdout + result.stderr
    registers = sorted({line.split("Used")[1].split(",")[0].strip()
                        for line in output.splitlines() if "Used" in line and "registers" in line})
    return name, result.returncode, output, registers


def run(name: str) -> None:
    import torch

    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch.ops import whitelist as wl_ops

    entry = ctypes.CDLL(str(BUILD / f"{name}.so")).whitelist_correct
    entry.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    device = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)

    def case(length, n_w, n_q):
        whitelist = torch.from_numpy(rng.integers(0, 4, size=(n_w, length), dtype=np.uint8)).to(device)
        queries = whitelist[torch.from_numpy(rng.integers(0, n_w, size=n_q)).to(device)].clone()
        flip = torch.from_numpy(rng.random(n_q) < 0.1).to(device)
        pos = torch.from_numpy(rng.integers(0, length, size=n_q)).to(device)
        rows = torch.arange(n_q, device=device)
        queries[rows[flip], pos[flip]] = (queries[rows[flip], pos[flip]] + 1) % 4
        table = wl_ops.make_table(whitelist)
        q_onehot = wl_ops.onehot_int8(queries)
        out = torch.empty(n_q, dtype=torch.int32, device=device)

        def launch():
            status = entry(q_onehot.data_ptr(), n_q, length, table.onehot.data_ptr(), n_w,
                           out.data_ptr(), stream)
            if status != 0:
                raise RuntimeError(f"{name}: cudaError_t {status}")

        return launch, out, lambda: wl_ops.correct_plain(queries, table)

    launch, out, plain = case(16, 737_280, 65_536)
    for _ in range(3):
        launch()
    times = []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 20)
    exact = [bool(torch.equal(out, plain()))]
    for shape in ((1, 700, 300), (17, 1025, 999), (64, 1537, 700)):
        small, small_out, small_plain = case(*shape)
        small()
        exact.append(bool(torch.equal(small_out, small_plain())))
    after = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"{name}: {times[0]:.3f} / {times[1]:.3f} ms per batch; equal to plain "
          f"(full size, L=1, L=17, L=64): {exact}; after: {after}", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        run(argv[1])
        return 0
    names = argv or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    BUILD.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    print(f"built {len(names)} variant(s) in {time.perf_counter() - start:.2f} s", flush=True)
    ready = []
    for name, returncode, output, registers in built:
        print(f"{name}: nvcc rc {returncode}, registers {registers}, "
              f"C7514 warnings {output.count('C7514')}", flush=True)
        if returncode != 0:
            print(output[-1500:], flush=True)
        else:
            ready.append(name)
    for order in (ready, ready[::-1]):
        for name in order:
            result = subprocess.run(["timeout", "60", sys.executable, __file__, "--run", name],
                                    capture_output=True, text=True)
            print(result.stdout.strip() or f"{name}: rc {result.returncode} {result.stderr[-800:]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
