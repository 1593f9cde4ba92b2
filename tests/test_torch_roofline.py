"""The port's roofline bounds (``ops/roofline.py``): the bound is the larger
of the bytes time and the operations time, and the paper bounds of the
kernels still to port count the bytes the reference's own formats hold."""

import numpy as np
import pytest

from neuronx_distributed_inference_tpu.ops import quant_matmul as jqm
from neuronx_distributed_inference_tpu_torch.ops import roofline


def test_bound_is_the_larger_time():
    ms, by = roofline.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = roofline.bound_ms(1.0, 989e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_int4_bytes_match_the_reference_format():
    K, N = 512, 48
    entry = jqm.quantize_tensor_int4(np.random.RandomState(0).randn(K, N).astype(np.float32))
    nbytes, flops = roofline.int4_matmul(1, K, N)
    activations = K * roofline.BF16 + N * roofline.BF16
    assert nbytes - activations == entry["weight"].nbytes + entry["scale"].nbytes
    assert flops == 2 * K * N


def test_paper_bounds_cover_the_kernels_still_to_port():
    rows = {r["tag"]: r for r in roofline.paper_bounds()}
    assert sorted(rows) == ["B6", "B7", "B8", "B9"]
    for r in rows.values():
        assert r["bytes"] > 0 and r["flops"] > 0 and r["bound_ms"] > 0
    # B9 streams the MLP's three bf16 weight matrices once
    m = roofline.MODEL_1B
    assert rows["B9"]["bytes"] >= 3 * m["H"] * m["I"] * roofline.BF16


@pytest.mark.parametrize("point", ["mixed", "decode"])
def test_ragged_points_count_the_packed_work(point):
    """B3's timed points: q over the real tokens, out over the 16-aligned
    packed slots, K and V once per context position, the descriptors and
    tables; FLOPs over the causal pairs (a 128-token chunk from 0 has
    128 * 129 / 2, a decode row its context)."""
    m = roofline.MODEL_1B
    pt = roofline.RAGGED_POINTS[point]
    nbytes, flops = roofline.ragged_work(**pt)
    if point == "mixed":
        q_tokens, T, kv, pairs = 128 + 7, 128 + 7 * 16, 128 + 7 * 192, 128 * 129 // 2 + 7 * 192
    else:
        q_tokens, T, kv, pairs = 8, 8 * 16, 8 * 192, 8 * 192
    tables = 8 * 3 * 4 + 8 * (1024 // 32) * 4
    assert nbytes == (q_tokens + T) * m["Hq"] * m["D"] * 2 + 2 * kv * m["Hkv"] * m["D"] * 2 + tables
    assert flops == 4 * m["D"] * m["Hq"] * pairs
    assert roofline.bound_ms(nbytes, flops)[1] == "bytes"
