"""The router rows of the PyTorch/CUDA port on one H100, without the rest of
``chip_smoke.py``.

    python3 scripts/torch_router_times.py [phase] [replay]

(no argument: both)

- ``phase``: the card's name and power limit, the kernels' build and
  ``chip_smoke.phase_router`` with all its gates (the sequential, threaded
  and elastic router over the paged cache, the disaggregated tier and the
  tier off; B1 and B2b timed at the rows' shapes).
- ``replay``: where a router step's host time goes: two paged int8 1B
  replicas warmed, one warm drain and sealed, then drains of the same
  traffic in turns (sequential, threaded, threaded, sequential), each CUDA
  graph replay call timed on the host clock without the profiler (the
  profiler's ``cudaGraphLaunch`` rows include CUPTI's own cost).

Run it from the repository root; it prints one line per drain.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def replay_times(torch, cs):
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_1B
    from neuronx_distributed_inference_tpu_torch.runtime import graphs

    calls = []
    real = graphs.Graph.replay

    def timed_replay(self):
        t0 = time.perf_counter()
        real(self)
        calls.append((threading.get_ident(), (time.perf_counter() - t0) * 1e3))

    graphs.Graph.replay = timed_replay
    try:
        s = cs.SERVING
        rng = np.random.RandomState(0)
        vocab = LLAMA_1B["vocab_size"]
        prompts = [rng.randint(0, vocab - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
        apps = cs._router_apps(torch, True, cs.ROUTER["replicas"])
        cs._route(torch, apps, prompts, s["gen"])  # warm pass
        cs._seal(apps)
        for label, threaded in (("sequential", False), ("threaded", True), ("threaded", True), ("sequential", False)):
            calls.clear()
            r = cs._route(torch, apps, prompts, s["gen"], threaded=threaded)
            ms = np.array([d for _, d in calls])
            cs.log(
                f"{label}: {len(prompts) * s['gen'] / r['secs']:.1f} tok/s, {r['steps']} router steps, "
                f"{len(ms)} replays, replay host ms mean {ms.mean():.3f} p50 {np.median(ms):.3f} "
                f"p90 {np.percentile(ms, 90):.3f}, summed per router step {ms.sum() / r['steps']:.3f}, "
                f"router step ms mean {np.mean(r['step_ms']):.3f}"
            )
    finally:
        graphs.Graph.replay = real


def main():
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention as fa

    what = set(sys.argv[1:]) or {"phase", "replay"}
    cs.phase_device(torch)
    cs.timed("build", _cuda.build)
    if "phase" in what:
        out = cs.timed("router", cs.phase_router, torch, fa, da)
        cs.log(f"router launches {out['launches']}")
    if "replay" in what:
        cs.timed("replay times", replay_times, torch, cs)


if __name__ == "__main__":
    main()
