"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into ``build/torch_kernels/<name>-<hash>/lib<name>.so`` (the hash covers the
sources and the flags, so an edit rebuilds) and loaded with ``ctypes``. The
sources expose a plain ``extern "C"`` interface: every pointer and the
stream are ``c_void_p``, every int ``c_int``, and each entry returns
``cudaGetLastError()`` after its launch. Nothing here includes PyTorch's
headers, so a build takes seconds, not minutes.

Building happens at first use — never at import — so the CPU tests can
import every module on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNEL_SOURCES = (
    "flash_attention", "decode_attention", "paged_flash_attention", "ragged_paged_attention", "quant_matmul",
    "moe_decode", "fused_attn_block", "fused_mlp_block",
)
#: the kernels whose launches are counted, by name: B4 (paged decode) is the
#: paged address mode of decode_attention.cu, counted apart from B1, and the
#: int8/fp8 code modes of B1, B4, B5 and B3 (a QuantizedKV cache) count
#: apart from their bf16/fp32 modes, under ``<name>_codes``. B1 with more
#: than one query a row over a plain cache (a speculative verify pass, or
#: a windowed prefill's window of up to 16 tokens) counts as
#: ``decode_attention_verify``. An entry that makes several grid
#: launches (B7, B8, B9) counts one.
KERNELS = (
    "flash_attention", "decode_attention", "paged_decode_attention", "paged_flash_attention",
    "ragged_paged_attention", "quant_matmul", "moe_decode", "fused_attn_block", "fused_mlp_block",
    "decode_attention_codes", "paged_decode_attention_codes", "paged_flash_attention_codes",
    "ragged_paged_attention_codes", "decode_attention_verify",
)
#: ``--split-compile=0`` runs each source's optimizer and ptxas passes on
#: every core: all eight sources, started together, build in 66.5 s
#: instead of 129.7 s on the 8-core host of one H100 (NVIDIA H100 80GB
#: HBM3, 700.00 W), the longest being decode_attention.cu's 64 split-kernel
#: instances, with the same registers and spills for every kernel
#: (scripts/torch_build_times.py)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}

#: kernel launches per kernel name: each wrapper adds one where it launches
#: its CUDA kernel, and nowhere else (the plain versions never count)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

#: calls per route that is not a kernel of the port: ``int4_dense`` counts
#: the int4 projections with more rows than B6 takes, run on a card as a
#: dequantized weight and one torch.matmul (ops/quant_matmul.py), and only
#: on a card. The MoE routes of ``modules/moe.moe_layer`` count on every
#: device: ``moe_dense`` (all experts, every token), ``moe_grouped``
#: (expert-sorted rows, prefill) and ``moe_capacity`` (the dropping
#: dispatch, prefill); a call that B7 takes counts as its launch.
ROUTES: Dict[str, int] = {"int4_dense": 0, "moe_dense": 0, "moe_grouped": 0, "moe_capacity": 0}


#: guards LAUNCHES and ROUTES: a router's replica threads count at once
#: (``count``, a graph replay's ``add_counts``), and ``+=`` on a dict entry
#: is a read-modify-write. Not ``_lock``, which a build holds for seconds.
_count_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to kernel ``name``'s launch count (or route ``name``'s call
    count): a wrapper calls it where it launches its kernel, and nowhere
    else."""
    with _count_lock:
        (LAUNCHES if name in LAUNCHES else ROUTES)[name] += n


def reset_launch_counts() -> None:
    """Zero every kernel's launch count and every route's call count."""
    with _count_lock:
        for counts in (LAUNCHES, ROUTES):
            for name in counts:
                counts[name] = 0


@contextmanager
def census():
    """Record the kernel launches and route calls that the wrappers count
    inside, and take them back out of the counts: a CUDA graph capture
    enqueues nothing. Yields the dict {name: count} it fills on exit; each
    replay of the graph adds it back (:func:`add_counts`), so a graphed run
    counts what the same run counts eagerly. A capture runs while no other
    thread counts (a capture fails while another thread launches work; the
    router's threaded stepping needs every replica's programs captured and
    sealed first), so the counts that change inside are the capture's."""
    with _count_lock:
        before = {**LAUNCHES, **ROUTES}
    recorded: Dict[str, int] = {}
    try:
        yield recorded
    finally:
        with _count_lock:
            for counts in (LAUNCHES, ROUTES):
                for name in counts:
                    n = counts[name] - before[name]
                    if n:
                        recorded[name] = n
                    counts[name] = before[name]


def add_counts(recorded: Dict[str, int], times: int = 1) -> None:
    """Add a recorded census ``times`` times (a graph's replays)."""
    with _count_lock:
        for name, n in recorded.items():
            (LAUNCHES if name in LAUNCHES else ROUTES)[name] += n * times


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def route_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(ROUTES)


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_dir(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"


def lib_path(name: str) -> Path:
    return _lib_dir(name) / f"lib{name}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: ptxas report} (registers,
    shared memory and spills per kernel, from ``-Xptxas -v``); raises with
    the compiler's output if a build fails."""
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (out.parent / "nvcc.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: ptxas_report(name) for name in names}


def ptxas_report(name: str) -> str:
    """The ``ptxas`` lines (registers, shared memory, stack and spills per
    kernel) of the build that produced ``name``'s library."""
    log = lib_path(name).parent / "nvcc.log"
    if not log.exists():
        return ""
    return "\n".join(
        line for line in log.read_text().splitlines() if "ptxas" in line or "spill" in line
    )


def function(name: str, symbol: str, argtypes: Sequence):
    """The ctypes function ``symbol`` of kernel library ``name``, built and
    loaded on first use; returns a C int (a ``cudaError_t``)."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SM count of CUDA ``device``, read once per device and cached."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


#: pool key -> one fp32 scratch buffer, grown to the largest call: the
#: split partials of B1, B4, B6, B8 and B9, B7's partial sums and B9's act
#: rows. A pool key is (device index, stream): one stream runs its launches
#: in order, so a call may reuse what the previous call on that stream left
#: there. Inside :func:`pool_scope` it is (device index, scope) instead: a
#: captured CUDA graph owns the pools of its scope (runtime/graphs.py).
_SCRATCH: Dict[tuple, object] = {}

#: pool key -> one int32 buffer of completion counters (the last of a group
#: of blocks to finish combines their partial results: B3's decode splits,
#: B8's kv splits and o-proj splits, B9's gate/up and down splits). Every
#: counter is 0 between launches: the block that finishes resets it, so a
#: buffer is zeroed once, when it is made, and launches that run in order
#: may share it (graph replays included).
_COUNTERS: Dict[tuple, object] = {}

#: pool keys a live CUDA graph points into: asking one of them to grow
#: raises (:class:`PoolPinnedError`), since a graph keeps the old pointer
_PINNED: Dict[tuple, int] = {}

_SCOPE = threading.local()


class PoolPinnedError(RuntimeError):
    """A scratch or counter pool that a live CUDA graph uses was asked to
    grow; reallocating it would leave the graph writing freed memory."""


@contextmanager
def pool_scope(scope):
    """Key the scratch and counter pools of the calls inside by ``scope``
    instead of by their stream (a captured graph's pools: sized by its
    eager run, then pinned by :func:`pin_pools` while the graph lives)."""
    prev = getattr(_SCOPE, "key", None)
    _SCOPE.key = scope
    try:
        yield
    finally:
        _SCOPE.key = prev


def _pool_key(device, stream: int) -> tuple:
    scope = getattr(_SCOPE, "key", None)
    return (device.index, stream if scope is None else scope)


def pin_pools(key: tuple) -> None:
    """Pin the pools of ``key`` ((device index, scope)): from now on a call
    that needs more than they hold raises instead of reallocating."""
    _PINNED[key] = _PINNED.get(key, 0) + 1


def release_pools(key: tuple) -> None:
    """Unpin the pools of ``key`` (its graph is gone) and free them."""
    n = _PINNED.pop(key, 0) - 1
    if n > 0:
        _PINNED[key] = n
        return
    _SCRATCH.pop(key, None)
    _COUNTERS.pop(key, None)


def _pool(pools: Dict[tuple, object], what: str, numel: int, device, stream: int, make):
    key = _pool_key(device, stream)
    buf = pools.get(key)
    if buf is None or buf.numel() < numel:
        if key in _PINNED:
            raise PoolPinnedError(
                f"the {what} pool {key} is pinned by a captured CUDA graph and holds "
                f"{0 if buf is None else buf.numel()} elements; a call asked for {numel}. "
                "A graph's pools are sized by its eager run before capture and never "
                "reallocated while it lives"
            )
        buf = pools[key] = make()
    return buf


def scratch(numel: int, device, stream: int):
    """At least ``numel`` fp32 values of scratch on CUDA ``device`` for
    ``stream`` (:func:`stream_ptr`; contents undefined), allocated once and
    grown as needed, never per call (raises if the pool is pinned)."""
    import torch

    return _pool(
        _SCRATCH, "scratch", numel, device, stream,
        lambda: torch.empty(numel, dtype=torch.float32, device=device),
    )


def counters(numel: int, device, stream: int):
    """At least ``numel`` completion counters (int32, all 0) on CUDA
    ``device`` for ``stream``, allocated once and grown as needed (raises
    if the pool is pinned)."""
    import torch

    return _pool(
        _COUNTERS, "counter", numel, device, stream,
        lambda: torch.zeros(max(numel, 1024), dtype=torch.int32, device=device),
    )


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
