"""CUDA graphs of the port's runners: the counterpart of the reference's
fixed set of jitted programs, one per bucket.

The reference jits one step program per runner and compiles it once per
(bucket, batch) key, lazily at first use; after ``warmup()`` the
application may seal the runners so that steady state never builds a new
program (``analysis/retrace_guard.py``). The port writes the same programs
as eager PyTorch and captures each key's program as one CUDA graph
(``torch.cuda.CUDAGraph``), replayed with one launch:

- **First use** of a key runs the program eagerly on the app's capture
  stream (that run is the real step: its launches count, its result is
  returned), then captures it on the same stream. The eager run sizes the
  kernels' scratch and counter pools (``ops/_cuda.py``), which are keyed by
  the program (:func:`_cuda.pool_scope`), and the capture pins them: a later
  call that would need them larger raises instead of reallocating memory a
  live graph points into.
- **Launch counts**: the capture's wrapper calls enqueue nothing, so the
  counts they add are taken back out and recorded (:func:`_cuda.census`);
  each replay adds them again. A graphed run counts what the same run
  counts eagerly.
- **Memory and order**: all graphs of one app share one graph memory pool
  (``torch.cuda.graph_pool_handle()``) and replay in order on the caller's
  stream, so no two of them run at once. A graph's outputs live in that
  pool and the next replay overwrites them: callers copy them out.
- **Bindings**: a graph reads the params and the cache at the addresses it
  was captured with. :meth:`Graph.check_binding` raises when a replay is
  handed other tensors.
- **Random draws**: a program that samples registers the app's generator
  with its graph, so every replay draws afresh. Where the installed
  PyTorch cannot register a generator, capturing a sampling program
  raises: a replay would repeat the draws of its capture.

- **Threads**: a capture fails while another thread launches work, so a
  router's replica worker threads (``runtime/router.py``) never capture:
  :meth:`GraphSet.capture` raises on a thread marked by
  :func:`mark_worker_thread`. Every replica's programs are captured and
  sealed before threaded stepping; replays and launch counts are safe from
  any thread (``ops/_cuda.py`` counts under a lock).

With ``cuda_graphs=False``, and always on the CPU, :class:`GraphSet` is
disabled and the runners run every program eagerly on the current stream.
"""

from __future__ import annotations

import gc
import itertools
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

from neuronx_distributed_inference_tpu_torch.ops import _cuda

_IDS = itertools.count()
_THREAD = threading.local()


def mark_worker_thread() -> None:
    """Mark the calling thread as a router replica worker: a graph capture
    on it raises (another replica's thread launches work meanwhile)."""
    _THREAD.worker = True


class Graph:
    """One captured program: the graph, its static outputs, the launches it
    makes per replay, and the tensors it was captured against."""

    __slots__ = ("graph", "outputs", "census", "binding")

    def __init__(self, graph, outputs, census: Dict[str, int], binding: Tuple):
        self.graph = graph
        self.outputs = outputs
        self.census = census
        self.binding = binding

    def check_binding(self, binding: Tuple, what: str) -> None:
        if binding != self.binding:
            raise RuntimeError(
                f"{what}: the params or the KV cache are not the tensors this graph was "
                "captured with (a new cache or params object after capture); zero the "
                "cache in place (init_kv_cache) or load() again, which drops the graphs"
            )

    def replay(self) -> None:
        self.graph.replay()
        _cuda.add_counts(self.census)


def binding(params, cache) -> Tuple:
    """What a graph is bound to: the params object and the cache buffers
    (a quantized stream's codes and scales both)."""
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import stream_ptrs

    return (id(params), *stream_ptrs(cache.k), *stream_ptrs(cache.v))


class GraphSet:
    """The captured programs of one application: one graph memory pool, one
    capture stream, and the kernel pools pinned by its graphs (released by
    :meth:`close`, or when the set is collected)."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.enabled = bool(enabled) and device.type == "cuda"
        self.id = next(_IDS)
        self.captures = 0
        self._pinned: List[tuple] = []
        if self.enabled:
            self.index = device.index if device.index is not None else torch.cuda.current_device()
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.index)

    def scope(self, *key) -> tuple:
        """The pool scope of one program of this set."""
        return (self.id, *key)

    def eager(self, scope: tuple, fn: Callable):
        """``fn()`` on the capture stream with the pools of ``scope``,
        ordered after the caller's stream and before its later work."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream), _cuda.pool_scope(scope):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def capture(self, scope: tuple, fn: Callable, bind: Tuple, generator: Optional[torch.Generator] = None) -> Graph:
        """Capture ``fn()`` (already run once by :meth:`eager` under the same
        scope) as a graph; pins the scope's pools. ``generator``: the
        generator the program draws from, registered so that replays draw
        afresh."""
        if getattr(_THREAD, "worker", False):
            from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceError

            raise RetraceError(
                "a CUDA graph capture on a router replica thread: another replica's thread "
                "launches work meanwhile and the capture would fail. Warm every replica's "
                "programs (one sequential drain of the traffic) and seal the runners before "
                "threaded stepping"
            )
        g = torch.cuda.CUDAGraph()
        if generator is not None:
            register = getattr(g, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "this PyTorch cannot register a generator with a CUDA graph "
                    "(CUDAGraph.register_generator_state): every replay of a sampling "
                    "program would repeat the draws of its capture; run it with "
                    "cuda_graphs=False"
                )
            register(generator)
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        # a garbage collection inside the capture could free a dropped app's
        # graphs, and destroying a graph while a stream captures is an error
        # that invalidates the capture: no collection runs until it ends
        collect = gc.isenabled()
        gc.disable()
        try:
            with _cuda.census() as counts, _cuda.pool_scope(scope):
                with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
                    out = fn()
        finally:
            if collect:
                gc.enable()
        cur.wait_stream(self.stream)
        key = (self.index, scope)
        _cuda.pin_pools(key)
        self._pinned.append(key)
        self.captures += 1
        return Graph(g, out, counts, bind)

    def close(self) -> None:
        """Unpin and free the pools of this set's graphs (the graphs
        themselves go with their runners' program tables)."""
        pinned, self._pinned = self._pinned, []
        for key in pinned:
            _cuda.release_pools(key)

    def __del__(self):
        try:
            self.close()
        except (TypeError, AttributeError):
            pass  # interpreter shutdown: the module's globals are gone, the pools go with the process
