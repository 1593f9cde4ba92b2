"""How long the PyTorch/CUDA port's kernels take to build on this machine,
with and without nvcc's split compilation.

    python3 scripts/torch_build_times.py [out_dir]

Builds every source of ``ops/_cuda.KERNEL_SOURCES`` twice into a temporary
directory, one nvcc per source, all started together as ``_cuda.build``
does: first with ``_cuda.NVCC_FLAGS`` less ``--split-compile``, then with
``--split-compile=0`` (every core). Prints the card's name and power limit,
the host's core count, when each build finished and each round's wall
time, and whether each source's ptxas report (registers, shared memory,
stack and spills per kernel) is the same in both rounds. With ``out_dir``
it also writes nvcc's per-stage timings there (``nvcc -time``, one CSV per
source and round). Needs nvcc; run it from the repository root.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = "--split-compile=0"


def build_round(cuda, flags, work, out_dir, tag):
    """Start one nvcc per source with ``flags``; returns ({source: ptxas
    lines}, wall seconds)."""
    procs, t0 = {}, time.perf_counter()
    for name in cuda.KERNEL_SOURCES:
        timing = ["-time", os.path.join(out_dir, f"nvcc_time_{tag}_{name}.csv")] if out_dir else []
        cmd = [cuda.nvcc(), *flags, *timing, "-I", str(cuda.CSRC), "-o", os.path.join(work, f"{tag}_{name}.so"),
               str(cuda.CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tag} build of {name} failed:\n{log}")
        reports[name] = [line for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"{tag} {name}: done at {time.perf_counter() - t0:.1f} s", flush=True)
    wall = time.perf_counter() - t0
    print(f"{tag}: every source built in {wall:.1f} s", flush=True)
    return reports, wall


def main():
    sys.path.insert(0, REPO)
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    out_dir = sys.argv[1] if len(sys.argv) > 1 else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}; host cores: {os.cpu_count()}", flush=True)
    plain_flags = [f for f in _cuda.NVCC_FLAGS if not f.startswith("--split-compile")]
    with tempfile.TemporaryDirectory() as work:
        plain, plain_s = build_round(_cuda, plain_flags, work, out_dir, "plain")
        split, split_s = build_round(_cuda, plain_flags + [SPLIT], work, out_dir, "split")
    for name in _cuda.KERNEL_SOURCES:
        print(f"{name}: ptxas registers, shared memory and spills the same with {SPLIT}: "
              f"{plain[name] == split[name]}", flush=True)
    print(f"wall: {plain_s:.1f} s without, {split_s:.1f} s with {SPLIT}", flush=True)


if __name__ == "__main__":
    main()
