"""The port's roofline bounds (``ops/roofline.py``): the bound is the larger
of the bytes time and the operations time, and each kernel's bytes count
what its inputs and outputs hold, in the reference's own formats."""

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


@pytest.mark.parametrize(
    "rows, K, N, want",
    [
        # 8B up projection at 1 row: x 4096 bf16, codes 2048 x 14336 u8,
        # scales 32 x 14336 f32, out 14336 bf16
        (1, 4096, 14336, 4096 * 2 + 2048 * 14336 + 32 * 14336 * 4 + 14336 * 2),
        # 1B down projection at 8 rows: x 8 x 8192 bf16, codes 4096 x 2048,
        # scales 64 x 2048 f32, out 8 x 2048 bf16
        (8, 8192, 2048, 8 * 8192 * 2 + 4096 * 2048 + 64 * 2048 * 4 + 8 * 2048 * 2),
        # K 1000 pads to 1024: codes 512 rows, 8 scale groups
        (2, 1000, 200, 2 * 1000 * 2 + 512 * 200 + 8 * 200 * 4 + 2 * 200 * 2),
    ],
)
def test_int4_matmul_bytes_counted_by_hand(rows, K, N, want):
    nbytes, flops = roofline.int4_matmul(rows, K, N)
    assert nbytes == want and flops == 2 * rows * K * N
    assert roofline.bound_ms(nbytes, flops)[1] == "bytes"


def test_int4_step_bytes_cover_every_projection():
    """The 8B int4 decode step reads ~4.0 GB of weights (~1.19 ms at
    3.35 TB/s): 32 layers of qkv, o, gate, up and down, and the lm head."""
    shapes = [(4096, 6144), (4096, 4096), (4096, 14336), (4096, 14336), (14336, 4096)]
    weights = 32 * sum(K * N for K, N in shapes) + 4096 * 128256
    acts = 32 * sum(K + N for K, N in shapes) + 4096 + 128256  # x and out, one row
    step = roofline.int4_step_bytes(roofline.MODEL_8B)
    assert step == weights // 2 + weights // 128 * 4 + 2 * acts
    assert roofline.bound_ms(step, 0)[0] == pytest.approx(1.19, abs=0.01)


@pytest.mark.parametrize("point, want_ms", [("bs1", 0.00642), ("bs4", 0.00690)])
def test_attn_block_bounds(point, want_ms):
    """B8 over one Llama-3.2-1B decode layer: Wqkv (2048 x 3072), Wout
    (2048 x 2048) and gamma in bf16, x and out, k_new and v_new, fp32
    cos / sin, the mask bytes (bucket 512), slot ids and positions, and K
    and V at every cached position read (255 a row)."""
    m = roofline.MODEL_1B
    pt = roofline.FUSED_POINTS[point]
    B = pt["batch"]
    nbytes, flops = roofline.attn_block(m, B, 1, pt["prior"], 512)
    weights = (2048 * 3072 + 2048 * 2048 + 2048) * 2
    acts = B * (2 * 2048 * 2 + 2 * 8 * 64 * 2 + 2 * 32 * 4 + 512 + 2 * 4)
    assert pt["prior"] == 255 * B
    assert nbytes == weights + acts + 2 * pt["prior"] * 8 * 64 * 2
    assert flops == B * 2 * 2048 * (3072 + 2048) + 4 * 64 * 32 * (pt["prior"] + B)
    ms, by = roofline.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(want_ms, abs=5e-6)


@pytest.mark.parametrize("rows", [1, 4])
def test_mlp_block_bounds(rows):
    """B9 streams the MLP's three bf16 weight matrices and gamma once (100.7
    MB at Llama-3.2-1B, 0.030 ms at 3.35 TB/s) and reads x, writes out."""
    m = roofline.MODEL_1B
    nbytes, flops = roofline.mlp_block(m, rows)
    assert nbytes == (3 * 2048 * 8192 + 2048) * 2 + 2 * rows * 2048 * 2
    assert flops == 6 * rows * 2048 * 8192
    ms, by = roofline.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(0.0300, abs=1e-4)


@pytest.mark.parametrize(
    "point, rows, H, I, want_ms",
    [("bs1", 1, 2048, 8192, 0.03005), ("bs4", 4, 2048, 8192, 0.03006), ("rows16", 16, 2048, 8192, 0.03009),
     ("8b bs1", 1, 4096, 14336, 0.10518)],
)
def test_fused_points_mlp_bytes_counted_by_hand(point, rows, H, I, want_ms):
    """B9 at each timed point: the three bf16 weights and gamma once (352.3
    MB at Llama-3.1-8B's MLP), x read and out written for every row; B8
    only where the point reads a cache (prior)."""
    pt = roofline.FUSED_POINTS[point]
    assert pt["batch"] == rows and (pt["m"]["H"], pt["m"]["I"]) == (H, I)
    assert (pt["prior"] is None) == (point in ("rows16", "8b bs1"))
    nbytes, flops = roofline.mlp_block(pt["m"], rows)
    assert nbytes == 3 * H * I * 2 + H * 2 + rows * H * 2 * 2
    assert flops == rows * 6 * H * I
    ms, by = roofline.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(want_ms, abs=5e-6)


@pytest.mark.parametrize("point", ["mixed", "decode", "spec"])
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
    elif point == "spec":
        # a verify row of 4 new tokens over 196 positions: 4 * 192 + 4 * 5 / 2
        q_tokens, T, kv, pairs = 128 + 7 * 4, 128 + 7 * 16, 128 + 7 * 196, 128 * 129 // 2 + 7 * (4 * 192 + 10)
    else:
        q_tokens, T, kv, pairs = 8, 8 * 16, 8 * 192, 8 * 192
    tables = 8 * 3 * 4 + 8 * (1024 // 32) * 4
    assert nbytes == (q_tokens + T) * m["Hq"] * m["D"] * 2 + 2 * kv * m["Hkv"] * m["D"] * 2 + tables
    assert flops == 4 * m["D"] * m["Hq"] * pairs
    assert roofline.bound_ms(nbytes, flops)[1] == "bytes"


@pytest.mark.parametrize(
    "point, want_ms",
    [("qwen3 bs1", 0.02254), ("qwen3 bs8", 0.1803), ("mixtral bs1", 0.2103)],
)
def test_moe_decode_bounds(point, want_ms):
    """B7 reads each distinct selected expert's gate, up and down weights
    once (Qwen3-30B-A3B: 3 x 2048 x 768 bf16 = 9.44 MB an expert; Mixtral:
    3 x 4096 x 14336 = 352 MB), x and out in bf16, and the (tokens, k) ids
    and weights."""
    pt = roofline.MOE_POINTS[point]
    m, T = pt["m"], pt["tokens"]
    nbytes, flops = roofline.moe_decode(m, T, pt["distinct"])
    expert = 3 * m["H"] * m["I"] * 2
    assert nbytes == pt["distinct"] * expert + 2 * T * m["H"] * 2 + T * m["k"] * 8
    assert flops == T * m["k"] * 6 * m["H"] * m["I"]
    ms, by = roofline.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(want_ms, abs=5e-5)


def test_moe_step_bytes_and_the_dense_route():
    """A Qwen3-30B-A3B decode step at batch 1 reads 6.08 GB of weights
    (1.816 ms at 3.35 TB/s), B7's 8 experts a layer 60% of it; the dense
    all-experts route B7 replaces reads 1.21 GB a layer (0.3606 ms)."""
    m = roofline.MODEL_QWEN3_MOE
    step = roofline.moe_step_bytes(m)
    assert roofline.bound_ms(step, 0)[0] == pytest.approx(1.816, abs=5e-4)
    b7 = m["L"] * roofline.moe_decode(m, 1, 8)[0]
    assert b7 / step == pytest.approx(0.60, abs=0.01)
    assert roofline.bound_ms(b7, 0)[0] == pytest.approx(1.082, abs=5e-4)
    dense = roofline.moe_dense_bytes(m, 1)
    assert dense == pytest.approx(1.21e9, rel=0.01)
    assert roofline.bound_ms(dense, 0)[0] == pytest.approx(0.3606, abs=5e-4)
    # batch 8 touches at most 64 experts a layer
    assert roofline.moe_step_bytes(m, 8) == roofline.moe_step_bytes(m, 8, 64) > step


@pytest.mark.parametrize(
    "intervals, want",
    [
        ([], 0.0),
        ([(0.0, 1000.0)], 1.0),
        ([(0.0, 10.0), (5.0, 20.0), (30.0, 40.0)], 0.03),  # a launch that starts before the last ends
        ([(30.0, 40.0), (0.0, 10.0), (0.0, 25.0)], 0.035),  # any order; one inside another
        ([(0.0, 10.0), (10.0, 20.0)], 0.02),
    ],
)
def test_device_busy_counts_overlapping_launches_once(intervals, want):
    """chip_smoke's device busy time is the union of the kernels' (start,
    end) intervals in us, in ms: B7's down and combine launches start while
    the launch before them drains and wait inside, so summing durations
    would count their wait as work."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    assert chip_smoke.union_ms(intervals) == pytest.approx(want)
