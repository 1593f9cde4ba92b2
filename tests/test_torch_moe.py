"""The MoE block of the port (``modules/moe.py``, ``ops/moe_decode.py``,
``kernel_mode.use_moe_tkg``) against the JAX package's, on the CPU at fp32
with inputs made by numpy from a seed: the router with every scoring
function (ties included: ``jax.lax.top_k`` puts the lower index first),
the grouped, capacity and dense expert routes, ``moe_layer``'s choice of
route, and B7's plain version against the JAX Pallas kernel in interpret
mode and against the dense route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import moe as jmoe
from neuronx_distributed_inference_tpu.ops.moe_decode import fused_moe_decode as jax_fused_moe_decode
from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops import kernel_mode
from neuronx_distributed_inference_tpu_torch.ops import moe_decode as tmd

H, I = 32, 48
ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _specs(**kw):
    """The same MoESpec in both packages."""
    return jmoe.MoESpec(**kw), tmoe.MoESpec(**kw)


def _experts(rng, E, bias=False):
    p = {
        "gate_proj": {"weight": rng.randn(E, H, I).astype(np.float32) * 0.1},
        "up_proj": {"weight": rng.randn(E, H, I).astype(np.float32) * 0.1},
        "down_proj": {"weight": rng.randn(E, I, H).astype(np.float32) * 0.1},
    }
    if bias:
        p["gate_proj"]["bias"] = rng.randn(E, I).astype(np.float32) * 0.1
        p["up_proj"]["bias"] = rng.randn(E, I).astype(np.float32) * 0.1
        p["down_proj"]["bias"] = rng.randn(E, H).astype(np.float32) * 0.1
    return p


def _tree(p, conv):
    return {k: _tree(v, conv) if isinstance(v, dict) else conv(v) for k, v in p.items()}


def _both(p):
    return _tree(p, jnp.asarray), _tree(p, _t)


def _tied_logits(rng, T, E):
    """Router logits on a coarse grid, so many values tie."""
    return (rng.randint(-3, 4, size=(T, E)) * 0.5).astype(np.float32)


ROUTER_CASES = {
    "softmax": dict(),
    "softmax no renorm": dict(normalize_top_k_affinities=False),
    "softmax p-norm": dict(norm_weights_p=2.0),
    "softmax scaled": dict(routed_scaling_factor=2.5),
    "sigmoid": dict(scoring_func="sigmoid"),
    "sigmoid correction": dict(scoring_func="sigmoid"),
    "sigmoid grouped": dict(scoring_func="sigmoid", n_group=4, topk_group=2),
    "softmax_topk": dict(scoring_func="softmax_topk"),
    "sigmoid_topk": dict(scoring_func="sigmoid_topk"),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
@pytest.mark.parametrize("ties", [False, True])
def test_router_top_k_matches_jax(case, ties):
    rng = np.random.RandomState(0)
    T, E, k = 24, 16, 4
    logits = _tied_logits(rng, T, E) if ties else rng.randn(T, E).astype(np.float32)
    js, ts = _specs(num_experts=E, top_k=k, **ROUTER_CASES[case])
    bias = rng.randn(E).astype(np.float32) * 0.1 if case in ("sigmoid correction", "sigmoid grouped") else None
    ja, jsel = jmoe.router_top_k(jnp.asarray(logits), js, None if bias is None else jnp.asarray(bias))
    ta, tsel = tmoe.router_top_k(_t(logits), ts, None if bias is None else _t(bias))
    np.testing.assert_array_equal(_np(tsel), np.asarray(jsel))
    assert int(_np(tsel).sum()) == T * k
    np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=1e-6, rtol=1e-6)


def test_top_k_puts_the_lower_index_first_among_ties():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 2.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = tmoe._top_k(_t(x), 4)
    assert _np(ti).tolist() == np.asarray(ji).tolist() == [[1, 2, 4, 3]]
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))


def _affinities(rng, T, E, k, ties, **kw):
    logits = _tied_logits(rng, T, E) if ties else rng.randn(T, E).astype(np.float32)
    js, ts = _specs(num_experts=E, top_k=k, **kw)
    ja, jsel = jmoe.router_top_k(jnp.asarray(logits), js)
    return js, ts, np.asarray(ja), np.asarray(jsel)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_grouped_route_matches_jax(bias, early, ties):
    rng = np.random.RandomState(1)
    E, k, T = 8, 2, 96
    js, ts, aff, _ = _affinities(rng, T, E, k, ties, early_affinity_modulation=early)
    jp, tp = _both(_experts(rng, E, bias=bias))
    x = rng.randn(T, H).astype(np.float32) * 0.3
    ref = jmoe.expert_mlps_grouped(jp, jnp.asarray(x), jnp.asarray(aff), js)
    out = tmoe.expert_mlps_grouped(tp, _t(x), _t(aff), ts)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL, rtol=ATOL)
    # the expert sort is stable: rows of one expert keep their token order
    jst, jse, _, jgs = jmoe._sorted_dispatch(jnp.asarray(aff), k)
    tst, tse, _, tgs = tmoe._sorted_dispatch(_t(aff), k)
    for a, b in ((tst, jst), (tse, jse), (tgs, jgs)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_routes_sum_each_token_in_a_fixed_order(dtype):
    """The grouped and capacity routes add each token's k expert rows in
    increasing expert id, one add at a time in the rows' dtype (a CUDA
    index_add_ would add them in the order its atomics land): in fp32 the
    sums of the CPU's sequential index_add_, in bf16 a loop in that order."""
    g = torch.Generator().manual_seed(3)
    T, E, k, H = 37, 64, 8, 48
    aff = torch.softmax(torch.randn(T, E, generator=g), -1)
    st, _, _, _, order, e_topk = tmoe._sorted_dispatch_order(aff, k)
    rows = torch.randn(T * k, H, generator=g).to(dtype)
    out = tmoe._sum_per_token(rows, order, e_topk)
    if dtype == torch.float32:
        torch.testing.assert_close(out, torch.zeros(T, H).index_add_(0, st, rows), rtol=0, atol=0)
    want = torch.zeros(T, H, dtype=dtype)
    flat = torch.empty_like(rows)
    flat[order] = rows
    for t in range(T):
        for j in sorted(range(k), key=lambda j: int(e_topk[t, j])):
            want[t] = want[t] + flat[t * k + j]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("capacity_factor", [0.25, 1.0, 8.0])
@pytest.mark.parametrize("early", [False, True])
def test_capacity_route_matches_jax(capacity_factor, early):
    """The dropping route, with overflow (capacity 0.25 and 1.0) and
    without (8.0 holds every replica); a tied router decides which tokens
    each expert keeps by the stable sort."""
    rng = np.random.RandomState(2)
    E, k, T = 8, 2, 96
    js, ts, aff, _ = _affinities(
        rng, T, E, k, True, capacity_factor=capacity_factor, early_affinity_modulation=early
    )
    jp, tp = _both(_experts(rng, E, bias=True))
    x = rng.randn(T, H).astype(np.float32) * 0.3
    ref = jmoe.expert_mlps_capacity(jp, jnp.asarray(x), jnp.asarray(aff), js)
    out = tmoe.expert_mlps_capacity(tp, _t(x), _t(aff), ts)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL, rtol=ATOL)
    if capacity_factor < 1:
        assert (np.abs(_np(out)).sum(axis=1) == 0).any()  # dropped tokens


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_dense_route_matches_jax(bias, early, ties):
    rng = np.random.RandomState(3)
    E, k, T = 8, 2, 12
    js, ts, aff, sel = _affinities(rng, T, E, k, ties, early_affinity_modulation=early)
    jp, tp = _both(_experts(rng, E, bias=bias))
    x = rng.randn(T, H).astype(np.float32) * 0.3
    ref = jmoe.expert_mlps_dense(jp, jnp.asarray(x), jnp.asarray(aff), js, jnp.asarray(sel))
    out = tmoe.expert_mlps_dense(tp, _t(x), _t(aff), ts, _t(sel))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL, rtol=ATOL)


def _layer(rng, E, **kw):
    p = {"router": {"weight": rng.randn(H, E).astype(np.float32)}, "experts": _experts(rng, E, **kw)}
    return _both(p)


#: (name, spec kwargs, experts kwargs, B, S, route the port counts, JAX kernel forced)
LAYER_CASES = [
    ("prefill grouped", dict(num_experts=32, top_k=2), {}, 1, 64, "moe_grouped", False),
    ("prefill capacity", dict(num_experts=8, top_k=2, capacity_factor=1.0), {}, 2, 64, "moe_capacity", False),
    ("prefill dense: E < 16 k", dict(num_experts=8, top_k=2), {}, 1, 64, "moe_dense", False),
    ("decode B7", dict(num_experts=8, top_k=2), {}, 4, 1, None, True),
    ("short prefill B7", dict(num_experts=8, top_k=2), {}, 2, 16, None, True),
    ("decode B7 gelu", dict(num_experts=8, top_k=2, act="gelu"), {}, 4, 1, None, True),
    ("decode B7 gpt-oss glu", dict(num_experts=8, top_k=2, act_scale=1.702, act_bias=1.0, swiglu_limit=7.0), {},
     4, 1, None, True),
    ("decode dense: T k > 64", dict(num_experts=8, top_k=2), {}, 33, 1, "moe_dense", False),
    ("decode dense: kernel off", dict(num_experts=8, top_k=2, moe_fused_kernel=False), {}, 4, 1, "moe_dense", False),
    ("decode dense: biased experts", dict(num_experts=8, top_k=2), dict(bias=True), 4, 1, "moe_dense", False),
    ("decode dense: early modulation", dict(num_experts=8, top_k=2, early_affinity_modulation=True), {}, 4, 1,
     "moe_dense", False),
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_moe_layer_route_choice_matches_jax(case):
    """The route each shape takes, and the output against JAX's moe_layer
    on the same route (JAX's B7 forced on, in interpret mode, where the
    port takes B7: its default is the dense route)."""
    _, kw, ekw, B, S, route, jax_kernel = case
    rng = np.random.RandomState(4)
    jp, tp = _layer(rng, kw["num_experts"], **ekw)
    x = rng.randn(B, S, H).astype(np.float32) * 0.3
    jkw = dict(kw, moe_fused_kernel=True) if jax_kernel else kw
    ref = jmoe.moe_layer(jp, jnp.asarray(x), jmoe.MoESpec(**jkw))
    _cuda.reset_launch_counts()
    out = tmoe.moe_layer(tp, _t(x), tmoe.MoESpec(**kw))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL, rtol=ATOL)
    want = {"int4_dense": 0, "moe_dense": 0, "moe_grouped": 0, "moe_capacity": 0}
    if route is not None:
        want[route] = 1
    assert _cuda.route_counts() == want
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}


def _decode_inputs(rng, E, k, T, ties=False, dtype=np.float32):
    p = _experts(rng, E)
    x = rng.randn(T, H).astype(np.float32) * 0.3
    logits = _tied_logits(rng, T, E) if ties else rng.randn(T, E).astype(np.float32)
    js, ts = _specs(num_experts=E, top_k=k)
    aff, sel = jmoe.router_top_k(jnp.asarray(logits), js)
    w, idx = jax.lax.top_k(aff, k)
    return p, x, np.asarray(aff), np.asarray(sel), np.asarray(w), np.asarray(idx).astype(np.int32)


GLUS = {
    "silu": dict(act="silu"),
    "gelu": dict(act="gelu"),
    "gpt-oss": dict(act="silu", act_scale=1.702, act_bias=1.0, swiglu_limit=7.0),
    "gpt-oss unclamped": dict(act="silu", act_scale=1.702, act_bias=1.0),
}


@pytest.mark.parametrize("glu", sorted(GLUS))
@pytest.mark.parametrize("T, k, E", [(1, 2, 8), (4, 2, 8), (8, 8, 16), (3, 4, 6)])
def test_b7_plain_matches_the_jax_kernel(glu, T, k, E):
    """fused_moe_decode_plain against the JAX Pallas kernel in interpret
    mode, and against both packages' dense route on the same selection."""
    rng = np.random.RandomState(5)
    p, x, aff, sel, w, idx = _decode_inputs(rng, E, k, T, ties=(T == 3))
    kw = GLUS[glu]
    ref = jax_fused_moe_decode(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), jnp.asarray(p["gate_proj"]["weight"]),
        jnp.asarray(p["up_proj"]["weight"]), jnp.asarray(p["down_proj"]["weight"]), interpret=True, **kw,
    )
    tp = _tree(p, _t)
    args = (_t(x), _t(idx), _t(w), tp["gate_proj"]["weight"], tp["up_proj"]["weight"], tp["down_proj"]["weight"])
    out = tmd.fused_moe_decode_plain(*args, **kw)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL, rtol=ATOL)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    _cuda.reset_launch_counts()
    np.testing.assert_array_equal(_np(tmd.fused_moe_decode(*args, **kw)), _np(out))
    assert _cuda.launch_counts()["moe_decode"] == 0
    dense_kw = dict(num_experts=E, top_k=k, act=kw["act"], act_scale=kw.get("act_scale", 1.0),
                    act_bias=kw.get("act_bias", 0.0), swiglu_limit=kw.get("swiglu_limit"))
    js, ts = _specs(**dense_kw)
    jd = jmoe.expert_mlps_dense(_tree(p, jnp.asarray), jnp.asarray(x), jnp.asarray(aff), js, jnp.asarray(sel))
    td = tmoe.expert_mlps_dense(tp, _t(x), _t(aff), ts, _t(sel))
    np.testing.assert_allclose(_np(out), np.asarray(jd), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(_np(out), _np(td), atol=ATOL, rtol=ATOL)


H100_SMS = 132


@pytest.mark.parametrize(
    "H_, I_, rows",
    [(2048, 768, 8), (2048, 768, 64), (2048, 768, 16), (4096, 14336, 2), (1001, 333, 12), (1000, 332, 15),
     (256, 48, 8), (32, 48, 1)],
)
def test_moe_h_split_covers_every_row_once(H_, I_, rows):
    """B7's gate/up split of H: each row of H in one split, in order, none
    empty, whole 32-row tiles a split, at most 16 splits."""
    splits, per = tmd.moe_h_split(H_, I_, rows, H100_SMS)
    assert 1 <= splits <= tmd.MOE_MAX_SPLITS and per % tmd.MOE_SPLIT_ROWS == 0
    ranges = [range(z * per, min((z + 1) * per, H_)) for z in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert [h for r in ranges for h in r] == list(range(H_))


def test_moe_h_split_at_the_timed_shapes():
    """Qwen3-30B-A3B at batch 1 (8 rows: 12 column tiles x 8 = 96 blocks)
    takes 3 splits of 704 rows, 288 blocks on 132 SMs; at batch 8 (64
    rows) and Mixtral-8x7B at batch 1 (224 x 2 = 448 blocks) one split."""
    assert tmd.moe_h_split(2048, 768, 8, H100_SMS) == (3, 704)
    assert tmd.moe_h_split(2048, 768, 64, H100_SMS) == (1, 2048)
    assert tmd.moe_h_split(4096, 14336, 2, H100_SMS) == (1, 4096)


def test_moe_plan_at_the_timed_shapes(monkeypatch):
    """B7's launch plan (splits of H, rows a split, gate/up and down stage
    counts) on 132 SMs in bf16: 4 and 8 stages at Qwen3-30B-A3B's batch 1;
    2 and 3 at its batch 8, where many blocks share an SM; 3 and 8 at
    Mixtral-8x7B's batch 1, where each down block has an SM to itself."""
    monkeypatch.setattr(tmd._cuda, "sm_count", lambda device: H100_SMS)
    tmd._plan.cache_clear()
    try:
        assert tmd._plan(8, 2048, 768, 2, 0) == (3, 704, 4, 8)
        assert tmd._plan(64, 2048, 768, 2, 0) == (1, 2048, 2, 3)
        assert tmd._plan(2, 4096, 14336, 2, 0) == (1, 4096, 3, 8)
    finally:
        tmd._plan.cache_clear()


def _split_h_moe(x, idx, w, wg, wu, wd, **glu):
    """B7's CUDA algorithm in PyTorch: each selection's gate/up dots summed
    over H in moe_h_split's splits, each split in fp32, the splits added in
    split order, the GLU, the activation rounded to the weight dtype, the
    full I sum rounded to x's dtype, then the combine in fp32 over j in
    order, rounded once; an expert id outside [0, E) gives NaN for its
    selection."""
    T, Hh = x.shape
    k = idx.shape[1]
    E, _, Ii = wg.shape
    splits, per = tmd.moe_h_split(Hh, Ii, T * k, H100_SMS)
    y = torch.empty((T, k, Hh), dtype=x.dtype)
    for t in range(T):
        for j in range(k):
            e = int(idx[t, j])
            if not 0 <= e < E:
                y[t, j] = float("nan")
                continue
            g = torch.zeros(Ii)
            u = torch.zeros(Ii)
            for z in range(splits):  # split order
                h = slice(z * per, min((z + 1) * per, Hh))
                g = g + x[t, h].float() @ wg[e, h].float()
                u = u + x[t, h].float() @ wu[e, h].float()
            a = tmd.glu_plain(g, u, **glu).to(wd.dtype).float()
            y[t, j] = (a @ wd[e].float()).to(x.dtype)
    out = torch.zeros((T, Hh))
    for j in range(k):
        out = out + w[:, j:j + 1].float() * y[:, j].float()
    return out.to(x.dtype)


@pytest.mark.parametrize("glu", ["silu", "gpt-oss"])
@pytest.mark.parametrize("bad_id", [False, True])
def test_b7_split_h_order_matches_the_jax_kernel(glu, bad_id):
    """The kernel's summation order (8 splits of 32 rows over H 256 at 4
    tokens x top-2) against the JAX Pallas kernel in interpret mode at fp32
    within 2e-5. With an expert id past E in token 2, that token comes out
    NaN (the JAX kernel's index map clamps the id to the last expert
    instead), and the other tokens still agree."""
    rng = np.random.RandomState(9)
    T, k, E, Hh, Ii = 4, 2, 8, 256, 48
    x = rng.randn(T, Hh).astype(np.float32) * 0.3
    wg = rng.randn(E, Hh, Ii).astype(np.float32) * 0.1
    wu = rng.randn(E, Hh, Ii).astype(np.float32) * 0.1
    wd = rng.randn(E, Ii, Hh).astype(np.float32) * 0.1
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    w = rng.dirichlet(np.ones(k), size=T).astype(np.float32)
    if bad_id:
        idx[2, 1] = E + 3
    assert tmd.moe_h_split(Hh, Ii, T * k, H100_SMS)[0] == 8
    kw = GLUS[glu]
    ref = np.asarray(jax_fused_moe_decode(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
        interpret=True, **kw,
    ))
    out = _np(_split_h_moe(_t(x), _t(idx), _t(w), _t(wg), _t(wu), _t(wd), **kw))
    good = [t for t in range(T) if not (bad_id and t == 2)]
    np.testing.assert_allclose(out[good], ref[good], atol=ATOL, rtol=ATOL)
    if bad_id:
        assert np.isnan(out[2]).all()


def test_b7_plain_matches_the_jax_kernel_in_bf16():
    """In bf16 both round the activation and each selection's output where
    the Pallas kernel does; the fp32 dots may differ in their last bits, so
    an element may land one bf16 step away."""
    rng = np.random.RandomState(6)
    E, k, T = 8, 2, 4
    p, x, _, _, w, idx = _decode_inputs(rng, E, k, T)
    bf = jnp.bfloat16
    ref = jax_fused_moe_decode(
        jnp.asarray(x, bf), jnp.asarray(idx), jnp.asarray(w), jnp.asarray(p["gate_proj"]["weight"], bf),
        jnp.asarray(p["up_proj"]["weight"], bf), jnp.asarray(p["down_proj"]["weight"], bf), interpret=True,
    )
    tb = _tree(p, lambda a: _t(a).to(torch.bfloat16))
    out = tmd.fused_moe_decode_plain(
        _t(x).to(torch.bfloat16), _t(idx), _t(w), tb["gate_proj"]["weight"], tb["up_proj"]["weight"],
        tb["down_proj"]["weight"],
    )
    assert out.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref32, atol=1e-3, rtol=2.0**-7)


def test_b7_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.RandomState(7)
    p, x, _, _, w, idx = _decode_inputs(rng, 8, 2, 4)
    tp = _tree(p, _t)
    g, u, d = tp["gate_proj"]["weight"], tp["up_proj"]["weight"], tp["down_proj"]["weight"]
    ok = (_t(x), _t(idx), _t(w), g, u, d)
    with pytest.raises(ValueError, match="rows"):
        tmd.fused_moe_decode(torch.zeros(33, H), torch.zeros(33, 2, dtype=torch.int32), torch.zeros(33, 2), g, u, d)
    with pytest.raises(ValueError, match="w_down"):
        tmd.fused_moe_decode(*ok[:5], d.transpose(1, 2))
    with pytest.raises(ValueError, match="integer"):
        tmd.fused_moe_decode(ok[0], ok[2], *ok[2:])
    with pytest.raises(ValueError, match="act"):
        tmd.fused_moe_decode(*ok, act="relu")
    with pytest.raises(ValueError, match="all be on CUDA or all on the CPU"):
        tmd.fused_moe_decode(ok[0].to("meta"), *ok[1:])


def test_use_moe_tkg_gates():
    """The structural conditions of the reference's gate; None and True
    take the kernel (the reference's None is off), False the dense route."""
    rng = np.random.RandomState(8)
    params = _tree(_experts(rng, 8), _t)
    for flag in (None, True):
        spec = tmoe.MoESpec(num_experts=8, top_k=2, moe_fused_kernel=flag)
        assert kernel_mode.use_moe_tkg(spec, params, 32)  # 64 rows
        assert not kernel_mode.use_moe_tkg(spec, params, 33)  # 66 rows
    assert not kernel_mode.use_moe_tkg(tmoe.MoESpec(num_experts=8, top_k=2, moe_fused_kernel=False), params, 4)
    on = tmoe.MoESpec(num_experts=8, top_k=2)
    assert not kernel_mode.use_moe_tkg(tmoe.MoESpec(num_experts=8, top_k=2, ep_degree=2), params, 4)
    assert not kernel_mode.use_moe_tkg(
        tmoe.MoESpec(num_experts=8, top_k=2, early_affinity_modulation=True), params, 4
    )
    for extra in ("scale", "bias"):
        q = {k: dict(v) for k, v in params.items()}
        q["down_proj"][extra] = torch.ones(8, H)
        assert not kernel_mode.use_moe_tkg(on, q, 4)
    assert kernel_mode.MOE_TKG_MAX_ROWS == 64
    # the reference's gate on the same conditions (its None is off)
    jparams = _tree(_experts(rng, 8), jnp.asarray)
    from neuronx_distributed_inference_tpu.ops.kernel_mode import use_moe_tkg as jax_use_moe_tkg

    forced = jmoe.MoESpec(num_experts=8, top_k=2, moe_fused_kernel=True)
    assert jax_use_moe_tkg(forced, jparams, 32) and not jax_use_moe_tkg(forced, jparams, 33)


@pytest.mark.parametrize(
    "entry",
    [
        {"weight": torch.zeros(8, H // 2, I, dtype=torch.uint8), "scale": torch.ones(8, 1, I)},  # int4
        {"weight": torch.zeros(8, H, I, dtype=torch.int8), "scale": torch.ones(8, I)},  # int8 per channel
        {"weight": torch.zeros(8, H, I, dtype=torch.int8), "scale": torch.ones(8, H // 16, I)},  # blockwise
    ],
    ids=["int4", "int8", "blockwise"],
)
@pytest.mark.parametrize("S", [1, 64])
def test_quantized_experts_are_refused_naming_a9(entry, S):
    rng = np.random.RandomState(9)
    _, tp = _layer(rng, 32)
    tp["experts"]["gate_proj"] = entry
    spec = tmoe.MoESpec(num_experts=32, top_k=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tmoe.moe_layer(tp, torch.zeros(1, S, H), spec)
