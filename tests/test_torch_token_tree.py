"""The port's token trees (``modules/token_tree.py`` through
``runtime/fused_spec.EagleSpecModelForCausalLM``) against the JAX package's
on the CPU, fp32, with the tiny head_dim-64 target and EAGLE drafts of
``tests/torch_eagle_common.py``. Mirrors the reference's
``tests/test_token_tree.py`` case for case, and adds:

- ``TokenTree`` / ``DynamicTokenTree`` index arrays equal to JAX's, for the
  trees below (the 16-node tree of the 8B phase among them);
- ``place_tree_mask``, ``_place_dynamic_mask``, ``fixup_cache_paths`` and
  ``q_to_target_vocab`` equal to JAX's on the same inputs (bit for bit;
  the fixup on overlapping source and destination slots);
- greedy static trees (a chain-shaped tree, a branching tree, the 18-node
  tree whose verify pass takes the plain path) and dynamic trees: sequences
  and per-round counts equal to the JAX app's, sequences equal to plain
  greedy ``generate()``, caches and the hidden buffer within 5e-5 (fp32);
  the same with an EAGLE3 draft of reduced vocab (``d2t``);
- sampled verification: the first emitted token's marginal matches the
  warped target distribution (total variation under 0.05 over 6000
  draws, one batched call) for the static walk and a data-dependent one;
  top_k 1 equals the greedy tree; draws reproduce by seed and differ
  across seeds. The two frameworks' generators differ, so sampled paths
  are held by these statistics, not by token.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import token_tree as jtt
from neuronx_distributed_inference_tpu_torch.modules import token_tree as tt
from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache
from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from tests.test_torch_eagle import assert_same_run, assert_state_close
from tests.torch_eagle_common import MASK, PROMPTS, eagle_apps, eagle_draft_sd, port_cfg, target_sd

# root -> two children; the first child has two children
TREE = {0: [1, 2], 1: [3, 4]}
CHAIN = {0: [1], 1: [2], 2: [3]}
#: the 8B phase's static tree: 16 nodes, depth 4
TREE16 = {0: [1, 2, 3, 4], 1: [5, 6, 7], 2: [8, 9], 3: [10], 5: [11, 12], 6: [13], 8: [14], 11: [15]}
#: 18 nodes: its verify pass is past B1's 16 queries (the plain path)
TREE18 = {0: [1, 2, 3], 1: [4, 5, 6], 2: [7, 8], 3: [9], 4: [10, 11], 5: [12], 7: [13], 10: [14, 15], 11: [16],
          14: [17]}
DYN = {"step": 3, "branching_factor": 3, "num_inputs": 2}
DYN_8B = {"step": 4, "branching_factor": 3, "num_inputs": 1}
TREE_ARRAYS = ("parent", "level_of", "anc_mask", "paths", "path_len", "path_parent", "path_with_root",
               "children_table")


@pytest.fixture(scope="module")
def tsd():
    torch.set_num_threads(1)
    return target_sd(0)


@pytest.fixture(scope="module")
def plain(tsd):
    return ModelForCausalLM(None, port_cfg()).load(state_dict=tsd).generate(PROMPTS, MASK, max_new_tokens=12).sequences


def test_token_tree_structure():
    t = tt.TokenTree(TREE)
    assert t.num_nodes == 5 and t.depth == 2
    np.testing.assert_array_equal(t.level_of, [0, 1, 1, 2, 2])
    np.testing.assert_array_equal(t.parent, [-1, 0, 0, 1, 1])
    assert set(np.nonzero(t.anc_mask[3])[0]) == {0, 1, 3}  # node 3 sees {0, 1, 3}
    assert sorted(t.path_len.tolist()) == [1, 2, 2]  # leaves 2, 3, 4
    np.testing.assert_array_equal(t.parent_local[0], [0, 0])
    np.testing.assert_array_equal(t.child_rank[0], [0, 1])
    np.testing.assert_array_equal(t.parent_local[1], [0, 0])
    np.testing.assert_array_equal(t.child_rank[1], [0, 1])


@pytest.mark.parametrize("cfg", [TREE, CHAIN, TREE16, TREE18, {"0": ["2", "1"], "2": ["3"]}],
                         ids=["tree", "chain", "tree16", "tree18", "str_keys_unsorted"])
def test_token_tree_arrays_equal_jax(cfg):
    t, j = tt.TokenTree(cfg), jtt.TokenTree(cfg)
    assert (t.num_nodes, t.depth, t.max_width, t.max_children) == (j.num_nodes, j.depth, j.max_width, j.max_children)
    for name in TREE_ARRAYS:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    for name in ("levels", "parent_local", "child_rank"):
        assert len(getattr(t, name)) == len(getattr(j, name))
        for a, b in zip(getattr(t, name), getattr(j, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    dev = t.tensors("cpu")
    for name in TREE_ARRAYS[1:]:
        np.testing.assert_array_equal(dev[name].numpy(), getattr(t, name), err_msg=name)
    if cfg is TREE16:
        assert t.num_nodes == 16 and t.depth == 4 and [len(lv) for lv in t.levels] == [1, 4, 6, 4, 1]


@pytest.mark.parametrize("params", [DYN, DYN_8B, {"step": 2, "branching_factor": 2, "num_inputs": 2}])
def test_dynamic_tree_layout_equals_jax(params):
    d, j = tt.DynamicTokenTree(params), jtt.DynamicTokenTree(params)
    assert (d.num_nodes, d.depth, d.k_out) == (j.num_nodes, j.depth, j.k_out)
    assert (d.level_offsets, d.level_widths) == (j.level_offsets, j.level_widths)
    if params is DYN_8B:
        assert d.num_nodes == 13 and d.level_widths == [1, 3, 3, 3, 3]


def test_token_tree_validation():
    with pytest.raises(ValueError):
        tt.TokenTree({1: [2]})  # no root
    with pytest.raises(ValueError):
        tt.TokenTree({0: [1], 2: [1]})  # two parents
    with pytest.raises(ValueError):
        tt.TokenTree({0: [1], 5: [6]})  # unreachable


def test_dynamic_tree_params_validation():
    d = tt.DynamicTokenTree(DYN)
    assert d.num_nodes == 1 + 3 + 2 * 2 * 3  # 1 + bf + (steps - 1) * ni * bf
    assert d.k_out == 4
    with pytest.raises(ValueError):
        tt.DynamicTokenTree({"step": 0, "branching_factor": 3, "num_inputs": 2})
    with pytest.raises(ValueError):
        tt.DynamicTokenTree({"step": 2, "branching_factor": 2, "num_inputs": 4})
    with pytest.raises(NotImplementedError, match="num_verification_token"):
        tt.DynamicTokenTree(dict(DYN, num_verification_token=5))


def test_place_tree_mask():
    t = tt.TokenTree(TREE)
    m = tt.place_tree_mask(t.tensors("cpu")["anc_mask"], torch.tensor([[3]]), 16)[0, 0].numpy()  # (5, 16)
    assert set(np.nonzero(m[0])[0]) == {0, 1, 2, 3}  # the root at slot 3: the prior cache and itself
    assert set(np.nonzero(m[3])[0]) == {0, 1, 2, 3, 4, 6}  # node 3: ancestors 0 -> 3, 1 -> 4, itself at 6
    assert not m[3, 5]  # its sibling branch (node 2) is invisible


@pytest.mark.parametrize("cfg", [TREE, TREE16, TREE18])
def test_tree_masks_equal_jax(cfg):
    """The static mask of every level and of the verify pass, and the
    dynamic mask on random ancestry rows, at roots deep and shallow (one
    whose tree runs past the bucket), bit for bit; contiguous and bool, as
    B1 reads it."""
    import jax.numpy as jnp

    t = tt.TokenTree(cfg)
    dev = t.tensors("cpu")
    p = np.array([[3], [40], [60]], np.int32)
    for rows, jrows in [(dev["anc_mask"], t.anc_mask)] + list(zip(dev["anc_levels"], (t.anc_mask[lv] for lv in t.levels))):
        got = tt.place_tree_mask(rows, torch.from_numpy(p), 64)
        assert got.is_contiguous() and got.dtype == torch.bool and got.shape == (3, 1, rows.shape[0], 64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtt.place_tree_mask(jrows, jnp.asarray(p), 64)))
    anc = np.random.RandomState(0).rand(3, 5, t.num_nodes) < 0.4
    got = tt._place_dynamic_mask(torch.from_numpy(anc), torch.from_numpy(p), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtt._place_dynamic_mask(jnp.asarray(anc), jnp.asarray(p), 64)))


def test_fixup_cache_paths_equals_jax():
    """The accepted path's K/V moved to p .. p + depth in place, equal to
    JAX's bit for bit: overlapping source and destination slots, a row on
    the garbage line, and a path running past the cache."""
    import jax.numpy as jnp
    from neuronx_distributed_inference_tpu.modules.kvcache import KVCache as JaxKV

    rng = np.random.RandomState(1)
    k = rng.randn(2, 4, 24, 2, 8).astype(np.float32)
    v = rng.randn(2, 4, 24, 2, 8).astype(np.float32)
    slots = np.array([0, 3, 1], np.int32)  # line 3 is the garbage line
    p = np.array([[4], [10], [22]], np.int32)
    best = np.array([[0, 1, 3, 4], [0, 2, 0, 0], [0, 1, 0, 0]], np.int32)  # row 2's slots run past 24
    want = jtt.fixup_cache_paths(JaxKV(k=jnp.asarray(k), v=jnp.asarray(v)), jnp.asarray(slots), jnp.asarray(p),
                                 jnp.asarray(best))
    cache = KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
    tt.fixup_cache_paths(cache, torch.from_numpy(slots), torch.from_numpy(p), torch.from_numpy(best).long())
    # the garbage line takes the dropped writes here (the reference drops them)
    np.testing.assert_array_equal(cache.k.numpy()[:, :3], np.asarray(want.k)[:, :3])
    np.testing.assert_array_equal(cache.v.numpy()[:, :3], np.asarray(want.v)[:, :3])
    np.testing.assert_array_equal(cache.k.numpy()[0, 0, 5:8], k[0, 0, [5, 7, 8]])


def test_q_to_target_vocab_equals_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    q = rng.dirichlet(np.ones(8), size=(3, 2)).astype(np.float32)
    d2t = (rng.permutation(20)[:8] - np.arange(8)).astype(np.int32)
    got = tt.q_to_target_vocab(torch.from_numpy(q), torch.from_numpy(d2t), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtt.q_to_target_vocab(jnp.asarray(q), jnp.asarray(d2t), 20)))
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_greedy_tree_accept_picks_deepest_branch():
    """The rank-1 child matches where the rank-0 one does not: a chain would
    accept 1 token, the tree accepts its branch; the deeper branch wins."""
    t = tt.TokenTree(TREE)
    cand = torch.tensor([[7, 10, 11, 20, 21]], dtype=torch.int32)
    tl = torch.full((1, 5, 32), -10.0)
    tl[0, 0, 11] = 10.0  # after the root the target predicts 11: node 2 (rank 1)
    tl[0, 2, 30] = 10.0  # then 30, the bonus
    tokens, counts, best = tt.greedy_tree_accept(t, cand, tl)
    assert counts.tolist() == [2] and tokens[0, :2].tolist() == [11, 30] and best[0, :2].tolist() == [0, 2]
    tl = torch.full((1, 5, 32), -10.0)
    tl[0, 0, 10] = 10.0  # node 1's token
    tl[0, 1, 21] = 10.0  # node 4's (rank 1 under node 1)
    tl[0, 4, 5] = 10.0  # the bonus
    tokens, counts, best = tt.greedy_tree_accept(t, cand, tl)
    assert counts.tolist() == [3] and tokens[0, :3].tolist() == [10, 21, 5] and best[0, :3].tolist() == [0, 1, 4]


@pytest.mark.parametrize(
    "tree, draft",
    [
        (CHAIN, dict(correlated=True)),
        (TREE, dict(correlated=True)),
        (TREE, dict()),
        (TREE16, dict(correlated=True)),
        (TREE18, dict(correlated=True)),
        (DYN, dict(correlated=True)),
        (DYN, dict()),
    ],
    ids=["chain_tree", "branching", "branching_random_draft", "tree16", "tree18_plain_path", "dynamic",
         "dynamic_random_draft"],
)
def test_tree_greedy_matches_jax_and_plain_generate(tree, draft, tsd, plain):
    """Tree verification is target-greedy-exact for any tree shape; every
    round's count equals the JAX app's."""
    japp, app = eagle_apps(tsd, eagle_draft_sd(1, tsd, **draft), tree=tree)
    assert app.reserve_slots == app.tree.num_nodes
    assert_same_run(japp, app, plain)
    assert_state_close(japp, app)


@pytest.mark.parametrize("tree", [TREE, {"step": 2, "branching_factor": 2, "num_inputs": 2}], ids=["static", "dynamic"])
def test_eagle3_tree_with_d2t_matches_jax(tree):
    tsd4 = target_sd(0, 4)
    dsd = eagle_draft_sd(1, tsd4, eagle3=True, correlated=True, draft_vocab=64)
    japp, app = eagle_apps(tsd4, dsd, tree=tree, eagle3=True, draft_vocab=64, layers=4)
    plain4 = ModelForCausalLM(None, port_cfg(dict(num_hidden_layers=4))).load(state_dict=tsd4)
    assert_same_run(japp, app, plain4.generate(PROMPTS, MASK, max_new_tokens=12).sequences)
    assert_state_close(japp, app)


@pytest.mark.parametrize("tree", [None, TREE, DYN], ids=["chain", "static", "dynamic"])
def test_fused_decode_layer_never_runs_under_a_tree(tree, tsd, plain, monkeypatch):
    """With the fused decode layer turned on (and fused QKV), the chain's
    decode passes take B8 and B9, while a tree's, whose rope and mask are
    overrides, never do (B8 ropes at the write slot and builds a causal
    mask); the tokens stay plain generate()'s."""
    from neuronx_distributed_inference_tpu_torch.ops import decode_block

    calls = {"fused_attn_block": 0, "fused_mlp_block": 0}
    for name in calls:
        fn = getattr(decode_block, name)

        def counted(*a, fn=fn, name=name, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(decode_block, name, counted)
    fused = dict(fused_attn_block_kernel_enabled=True, fused_mlp_kernel_enabled=True, fused_qkv=True)
    _, app = eagle_apps(tsd, eagle_draft_sd(1, tsd, correlated=True), tree=tree, jax=False, **fused)
    np.testing.assert_array_equal(app.generate(PROMPTS, MASK, max_new_tokens=12).sequences, plain)
    if tree is None:
        assert calls["fused_attn_block"] > 0 and calls["fused_mlp_block"] > 0
    else:
        assert calls == {"fused_attn_block": 0, "fused_mlp_block": 0}


def test_chain_tree_equals_chain_eagle(tsd):
    """A chain-shaped tree reproduces chain EAGLE round for round."""
    from tests.torch_eagle_common import port_rounds

    dsd = eagle_draft_sd(1, tsd, correlated=True)
    _, tree_app = eagle_apps(tsd, dsd, tree=CHAIN, jax=False)
    _, chain_app = eagle_apps(tsd, dsd, jax=False)
    a, ca = port_rounds(tree_app, PROMPTS, MASK, max_new_tokens=12)
    b, cb = port_rounds(chain_app, PROMPTS, MASK, max_new_tokens=12)
    np.testing.assert_array_equal(a.sequences, b.sequences)
    assert [c.tolist() for c in ca] == [c.tolist() for c in cb]


def test_tree_config_validation():
    from neuronx_distributed_inference_tpu_torch.config import Config

    with pytest.raises(ValueError):
        Config(device="cpu", token_tree_config=TREE)  # needs EAGLE
    tc = Config(
        device="cpu", token_tree_config=TREE, speculation_length=4, enable_fused_speculation=True,
        enable_eagle_speculation=True, on_device_sampling_config={"do_sample": True},
    )
    assert tc.on_device_sampling_config.do_sample


def test_tree_acceptance_beats_chain(tsd):
    """With the correlated draft a branching tree finishes 24 tokens of one
    row in fewer rounds than chain EAGLE, with the same tokens."""
    from tests.torch_eagle_common import port_rounds

    dsd = eagle_draft_sd(1, tsd, correlated=True)
    prompts, mask = PROMPTS[:1], np.ones_like(PROMPTS[:1])

    def run(tree):
        _, app = eagle_apps(tsd, dsd, tree=tree, jax=False)
        out, counts = port_rounds(app, prompts, mask, max_new_tokens=24)
        return len(counts), out.sequences[0, 8:].tolist()

    chain_rounds, chain_toks = run(None)
    tree_rounds, tree_toks = run({0: [1, 2, 3], 1: [4, 5, 6], 4: [7, 8]})
    assert tree_toks == chain_toks
    assert tree_rounds < chain_rounds, (tree_rounds, chain_rounds)


N_DRAWS = 6000


def _first_token_tv(tokens, p_root, V):
    emp = np.bincount(tokens[:, 0].numpy(), minlength=V) / tokens.shape[0]
    return 0.5 * np.abs(emp - p_root).sum()


def test_sampled_tree_accept_marginal_matches_target():
    """The first emitted token's marginal equals the warped target
    distribution at the root whatever the q's are (children drawn i.i.d.
    from their parent's q): TV under 0.05 over 6000 rows of one call."""
    V, t = 12, tt.TokenTree(TREE)
    rng = np.random.RandomState(1)
    p = rng.dirichlet(np.ones(V), size=t.num_nodes).astype(np.float32)
    q = rng.dirichlet(np.ones(V), size=t.num_nodes).astype(np.float32)
    gen = torch.Generator().manual_seed(9)
    qt = torch.from_numpy(q)
    draws = torch.stack([torch.multinomial(qt[int(t.parent[n])], N_DRAWS, replacement=True, generator=gen)
                         for n in range(1, t.num_nodes)], dim=1)
    cand = torch.cat([torch.zeros((N_DRAWS, 1), dtype=torch.int64), draws], dim=1).to(torch.int32)
    tl = torch.from_numpy(np.log(p))[None].expand(N_DRAWS, -1, -1)
    sp = torch.from_numpy(prepare_sampling_params(N_DRAWS, top_k=-1))  # a neutral warp
    tokens, counts, _ = tt.sampled_tree_accept(t, cand, tl, qt[None].expand(N_DRAWS, -1, -1), sp, gen, 256)
    tv = _first_token_tv(tokens, p[0], V)
    assert tv < 0.05, f"TV(emp, p_root) = {tv:.3f}"
    assert counts.min() >= 1 and counts.max() <= t.depth + 1


def test_sampled_dynamic_walk_marginal_matches_target():
    """The walk over a per-row children table whose SHAPE depends on the
    drawn tokens (the dynamic expansion rule: the child with the higher
    log q expands): the first token's marginal is still the target's at
    the root (TV under 0.05 over 6000 rows of one call)."""
    V, N = 12, 5  # the root, 2 level-1 and 2 level-2 nodes (steps 2, bf 2, ni 1)
    rng = np.random.RandomState(3)
    p = rng.dirichlet(np.ones(V), size=N).astype(np.float32)
    q = rng.dirichlet(np.ones(V), size=N).astype(np.float32)
    qt, logq = torch.from_numpy(q), torch.from_numpy(np.log(q))
    gen = torch.Generator().manual_seed(11)
    c = torch.multinomial(qt[0], 2 * N_DRAWS, replacement=True, generator=gen).reshape(N_DRAWS, 2)
    sel_node = torch.argmax(logq[0][c], dim=1) + 1  # 1 or 2
    d = torch.stack([torch.multinomial(qt[n], 2 * N_DRAWS, replacement=True, generator=gen).reshape(N_DRAWS, 2)
                     for n in (1, 2)])  # (2, rows, 2)
    d = torch.where((sel_node == 1)[:, None], d[0], d[1])
    cand = torch.cat([torch.zeros((N_DRAWS, 1), dtype=torch.int64), c, d], dim=1).to(torch.int32)
    ctab = torch.full((N_DRAWS, N, 2), -1, dtype=torch.int64)
    ctab[:, 0] = torch.tensor([1, 2])
    ctab[torch.arange(N_DRAWS), sel_node] = torch.tensor([3, 4])
    tl = torch.from_numpy(np.log(p))[None].expand(N_DRAWS, -1, -1)
    sp = torch.from_numpy(prepare_sampling_params(N_DRAWS, top_k=-1))
    tokens, _, _ = tt.sampled_accept_walk(ctab, 2, cand, tl, qt[None].expand(N_DRAWS, -1, -1), sp, gen, 256)
    tv = _first_token_tv(tokens, p[0], V)
    assert tv < 0.05, f"TV(emp, p_root) = {tv:.3f}"


@pytest.mark.parametrize("tree", [TREE, DYN], ids=["static", "dynamic"])
def test_sampled_tree_topk1_equals_greedy_tree(tree, tsd, plain):
    """top_k 1 collapses every distribution to its argmax: the sampled tree
    emits the greedy tree's tokens (plain generate()'s)."""
    _, app = eagle_apps(tsd, eagle_draft_sd(1, tsd, correlated=True), tree=tree, sample=1, jax=False)
    np.testing.assert_array_equal(app.generate(PROMPTS, MASK, max_new_tokens=12, top_k=1).sequences, plain)


@pytest.mark.parametrize("tree", [TREE, {"step": 2, "branching_factor": 2, "num_inputs": 2}], ids=["static", "dynamic"])
def test_sampled_tree_runs_and_reproduces(tree, tsd):
    """Sampled tree decoding with temperature: tokens in the vocab, equal
    for equal seeds, different across seeds."""
    dsd = eagle_draft_sd(1, tsd)

    def run(seed):
        _, app = eagle_apps(tsd, dsd, tree=tree, sample=50, seed=seed, jax=False)
        return app.generate(PROMPTS, MASK, max_new_tokens=10, temperature=4.0, top_k=50).sequences

    a, b, a2 = run(0), run(123), run(0)
    assert (a >= 0).all() and (a < 128).all()
    np.testing.assert_array_equal(a, a2)
    assert a.tolist() != b.tolist()
