"""Token-tree speculation: the EAGLE draft expands a candidate TREE each
round and the target verifies every branch in one pass (counterpart of the
reference's ``modules/token_tree.py``).

- :class:`TokenTree` computes a static tree's index arrays on the host in
  numpy (BFS relabel, ancestry mask, levels, expansion indices,
  root-to-leaf paths) and keeps them as device tensors too
  (:meth:`TokenTree.tensors`), so a captured round reads no host memory.
- Tree nodes write DISTINCT cache slots ``p + node`` while RoPE takes the
  node's depth ``p + level``: ``StepInputs.position_ids`` and
  ``rope_position_ids`` carry the two, and ``mask_override`` the ancestry
  mask placed at the cache tail (:func:`place_tree_mask`). Under these the
  decode attention is B1 with K = the pass's node count (a tree of more
  than 16 nodes takes the plain path, as the reference's ``q_len <= 16``
  rule sends it), and the fused block B8 is never taken.
- The draft runs one forward per level; each node's top draft tokens (or,
  sampling, i.i.d. draws from its warped draft distribution) become its
  children in rank order. The target verifies all N nodes in one pass:
  greedy picks the deepest root-to-leaf path whose tokens contiguously
  match the target's argmax at their parents, plus a bonus token
  (:func:`greedy_tree_accept`); sampled walks the tree by recursive
  rejection sampling (:func:`sampled_tree_accept`), whose emitted marginal
  is the target's.
- The accepted path's K/V is then copied to the contiguous slots
  ``p .. p + depth`` of BOTH caches (:func:`fixup_cache_paths`) so the next
  round sees position == slot again.

:class:`DynamicTokenTree` fixes the node budget and decides the
connectivity on the device each round (:func:`dynamic_tree_token_gen`):
the top ``num_inputs`` nodes of a level by cumulative draft log-probability
expand ``branching_factor`` children each. Its shapes are static; its
choices use ``topk``, ``gather`` and ``where`` only, so the round is
captured as one CUDA graph like the others.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_TOKEN_GENERATION,
    ModelSpec,
    StepInputs,
    lm_head,
    model_logits,
)
from neuronx_distributed_inference_tpu_torch.modules.eagle import EagleOutput, d2t_table
from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache, QuantizedKV, slot_ids_from_seq_ids
from neuronx_distributed_inference_tpu_torch.modules.sampling import warped_probs
from neuronx_distributed_inference_tpu_torch.modules.speculation import _categorical


class TokenTree:
    """A static tree's structure and index arrays (host numpy, and device
    tensors through :meth:`tensors`).

    ``tree_config``: adjacency ``{node: [children]}`` (keys and values int
    or str; ids without an entry are leaves). Node 0 is the root, the last
    accepted token. Nodes are relabeled breadth-first, so index order is
    level order."""

    def __init__(self, tree_config: Dict):
        adj = {int(k): [int(c) for c in (v or [])] for k, v in tree_config.items()}
        nodes = set(adj) | {c for cs in adj.values() for c in cs}
        if 0 not in nodes:
            raise ValueError("token tree needs a root node 0")
        for n in sorted(nodes):
            adj.setdefault(n, [])
        parent = {}
        for n, cs in adj.items():
            for c in cs:
                if c in parent:
                    raise ValueError(f"node {c} has two parents")
                if c == 0:
                    raise ValueError("root cannot be a child")
                parent[c] = n
        order, frontier = [0], [0]
        while frontier:
            frontier = [c for n in frontier for c in adj[n]]
            order.extend(frontier)
        if len(order) != len(nodes):
            raise ValueError("tree has unreachable or duplicate nodes")
        relabel = {old: new for new, old in enumerate(order)}

        N = len(order)
        self.num_nodes = N
        self.parent = np.full(N, -1, np.int32)
        self.level_of = np.zeros(N, np.int32)
        kids: List[List[int]] = [[] for _ in range(N)]
        for old_c, old_p in parent.items():
            c, p = relabel[old_c], relabel[old_p]
            self.parent[c] = p
            kids[p].append(c)
        for p in range(N):
            kids[p].sort()  # child rank r = the r-th best draft token
        self.children = kids
        for n in range(1, N):
            self.level_of[n] = self.level_of[self.parent[n]] + 1
        self.depth = int(self.level_of.max())

        # ancestor-or-self mask
        anc = np.zeros((N, N), bool)
        for n in range(N):
            a = n
            while a != -1:
                anc[n, a] = True
                a = self.parent[a]
        self.anc_mask = anc

        self.levels: List[np.ndarray] = [
            np.asarray([n for n in range(N) if self.level_of[n] == lv], np.int32) for lv in range(self.depth + 1)
        ]
        self.max_width = max(len(lv) for lv in self.levels)
        # a level-(l+1) node's parent by index within level l, and its rank
        # among that parent's children (its top-k rank)
        self.parent_local: List[np.ndarray] = []
        self.child_rank: List[np.ndarray] = []
        for lv in range(1, self.depth + 1):
            prev = {int(n): i for i, n in enumerate(self.levels[lv - 1])}
            self.parent_local.append(np.asarray([prev[int(self.parent[n])] for n in self.levels[lv]], np.int32))
            self.child_rank.append(
                np.asarray([kids[int(self.parent[n])].index(int(n)) for n in self.levels[lv]], np.int32)
            )
        self.max_children = max((len(c) for c in kids), default=0)
        # (N, max_children) child ids in rank order, -1 padded: the walk
        # order of sampled verification
        self.children_table = np.full((N, max(self.max_children, 1)), -1, np.int32)
        for n in range(N):
            for r, c in enumerate(kids[n]):
                self.children_table[n, r] = c

        # root-to-leaf paths (P, depth), padded with 0 past path_len (which
        # excludes the root)
        paths, lens = [], []
        for leaf in (n for n in range(N) if not kids[n]):
            chain, n = [], leaf
            while n != 0:
                chain.append(n)
                n = int(self.parent[n])
            chain.reverse()
            lens.append(len(chain))
            paths.append(chain + [0] * (self.depth - len(chain)))
        self.paths = np.asarray(paths, np.int32).reshape(len(paths), self.depth)
        self.path_len = np.asarray(lens, np.int32)
        # each path step's parent (its token is matched against the
        # parent's prediction)
        self.path_parent = np.concatenate(
            [np.zeros((len(paths), 1), np.int32), self.paths[:, :-1]], axis=1
        )[:, : self.depth].astype(np.int32)
        # [root, n_1, ..., n_depth] a path: the token gather and cache fixup
        self.path_with_root = np.concatenate([np.zeros((len(paths), 1), np.int32), self.paths], axis=1)
        self._tensors: Dict[torch.device, Dict[str, object]] = {}

    @property
    def k_out(self) -> int:
        """Most tokens a round emits (the deepest path + the bonus)."""
        return self.depth + 1

    def tensors(self, device) -> Dict[str, object]:
        """The index arrays as int64 / bool tensors on ``device`` (made once
        a device): ``levels``, ``anc_levels`` (each level's ancestry rows),
        ``parent_local`` and ``child_rank`` (lists by level), ``anc_mask``,
        ``level_of``, ``paths``, ``path_parent``, ``path_len``,
        ``path_with_root``, ``children_table``."""
        device = torch.device(device)
        t = self._tensors.get(device)
        if t is None:
            def dev(a):
                a = np.asarray(a)
                return torch.from_numpy(a if a.dtype == bool else a.astype(np.int64)).to(device)

            t = self._tensors[device] = dict(
                levels=[dev(lv) for lv in self.levels],
                anc_levels=[dev(self.anc_mask[lv]) for lv in self.levels],
                parent_local=[dev(a) for a in self.parent_local],
                child_rank=[dev(a) for a in self.child_rank],
                **{name: dev(getattr(self, name)) for name in (
                    "anc_mask", "level_of", "paths", "path_parent", "path_len", "path_with_root", "children_table",
                )},
            )
        return t


def place_tree_mask(anc_rows: torch.Tensor, p: torch.Tensor, bucket: int) -> torch.Tensor:
    """The (B, 1, Q, bucket) bool decode mask of a tree pass: the prior
    cache (columns < p) and, of the in-flight slots p + j, the query node's
    ancestors and itself. ``anc_rows`` (Q, N) bool on p's device, p (B, 1)
    the root's slot. Contiguous (the B1 kernel reads its K stride)."""
    Q, N = anc_rows.shape
    cols = torch.arange(bucket, device=p.device)[None, :]
    rel = cols - p  # (B, bucket)
    anc_pad = torch.cat([anc_rows, torch.zeros((Q, 1), dtype=torch.bool, device=p.device)], dim=1)  # (Q, N + 1)
    tree_part = anc_pad[:, torch.clamp(rel, 0, N)] & (rel >= 0)[None]  # (Q, B, bucket); rel >= N: the pad column
    return ((cols < p)[:, None, :] | tree_part.permute(1, 0, 2))[:, None].contiguous()


def fixup_cache_paths(cache: KVCache, slot_ids: torch.Tensor, p: torch.Tensor, best_nodes: torch.Tensor) -> KVCache:
    """Copy the accepted path's K/V to the contiguous slots p .. p + depth of
    every layer, in place. ``slot_ids`` (B,) cache lines, p (B, 1) the
    root's slot, ``best_nodes`` (B, depth + 1) the accepted node sequence
    from the root. The source is gathered into a temporary first, so
    overlapping source and destination slots never alias. Slots past the
    accepted count take junk from the padded path tail: they lie past the
    next round's mask and are written before anything attends them. A
    quantized cache moves its codes (the scale is per layer and head)."""
    d1 = best_nodes.shape[1]
    src = p + best_nodes  # (B, d1)
    dst = p + torch.arange(d1, device=p.device)[None, :]
    lines = slot_ids.long()[:, None]
    for stream in (cache.k, cache.v):
        arr = stream.data if isinstance(stream, QuantizedKV) else stream
        garbage, s_max = arr.shape[1] - 1, arr.shape[2]
        vals = arr[:, lines, torch.clamp(src, 0, s_max - 1).long()]  # (L, B, d1, H, D), a copy
        ok = dst < s_max  # writes past the cache go to the garbage line, as the reference drops them
        arr[:, torch.where(ok, lines, garbage), torch.where(ok, dst, 0).long()] = vals
    return cache


def greedy_tree_accept(
    tree: TokenTree,
    cand: torch.Tensor,  # (B, N) each node's token (target vocab)
    tlogits: torch.Tensor,  # (B, N, V) the target's logits at each node
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy path selection: the deepest root-to-leaf path whose tokens
    contiguously match the target's argmax at their parents, its matched
    tokens and a bonus. Returns (tokens (B, depth + 1) zero-padded, counts
    (B,), best_nodes (B, depth + 1) the accepted nodes from the root)."""
    t = tree.tensors(cand.device)
    greedy = torch.argmax(tlogits, dim=-1).to(torch.int32)  # (B, N)
    tok_at = cand[:, t["paths"]]  # (B, P, depth)
    pred_at_parent = greedy[:, t["path_parent"]]
    steps = torch.arange(tree.depth, device=cand.device)
    valid = (steps[None, :] < t["path_len"][:, None])[None]  # (1, P, depth)
    match = (tok_at.to(torch.int32) == pred_at_parent) & valid
    contig = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)  # (B, P)
    best = torch.argmax(contig, dim=-1)  # the first deepest (ties share the prefix)
    a = torch.take_along_dim(contig, best[:, None], dim=1)[:, 0]
    best_nodes = t["path_with_root"][best]  # (B, depth + 1)
    toks = torch.take_along_dim(greedy, best_nodes, dim=1)  # token j = the prediction at node j - 1
    counts = (a + 1).to(torch.int32)
    idx = torch.arange(tree.depth + 1, device=cand.device)[None, :]
    return torch.where(idx < counts[:, None], toks, torch.zeros_like(toks)), counts, best_nodes


def sampled_tree_accept(
    tree: TokenTree,
    cand: torch.Tensor,
    tlogits: torch.Tensor,
    q_nodes: torch.Tensor,  # (B, N, V) the warped draft distribution at each internal node
    sampling_params: torch.Tensor,
    generator: torch.Generator,
    max_topk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multinomial tree verification by recursive rejection sampling (see
    :func:`sampled_accept_walk`) over the static tree's children table.
    Returns (tokens, counts, best_nodes) as :func:`greedy_tree_accept`."""
    ctab = tree.tensors(cand.device)["children_table"]
    ctab = ctab[None].expand(tlogits.shape[0], -1, -1)
    return sampled_accept_walk(ctab, tree.depth, cand, tlogits, q_nodes, sampling_params, generator, max_topk)


def sampled_accept_walk(
    ctab: torch.Tensor,  # (B, N, mc) child node id by (node, rank); -1 absent
    depth: int,
    cand: torch.Tensor,  # (B, N)
    tlogits: torch.Tensor,  # (B, N, V)
    q_nodes: torch.Tensor,  # (B, N, V)
    sampling_params: torch.Tensor,
    generator: torch.Generator,
    max_topk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recursive-rejection walk over a per-row children table (the
    connectivity may be decided on the device: dynamic trees). At the
    current node the walk keeps a residual target distribution p_res and
    tries the children in rank order: child token x accepts with
    probability min(1, p_res(x) / q(x)), each rejection sets p_res <-
    norm(max(p_res - q, 0)). An accept descends (p_res becomes the child's
    warped target distribution); when every child rejects, or at a leaf,
    the last token is drawn from p_res. The emitted marginal equals
    sampling from the target whenever each reached node's children were
    drawn i.i.d. from its q, whatever decided which nodes got children."""
    tlogits = tlogits[..., : q_nodes.shape[-1]]  # q lives on the true target vocab
    B, N, V = tlogits.shape
    mc = ctab.shape[2]
    dev = cand.device
    p_warp = warped_probs(
        tlogits.reshape(B * N, V), torch.repeat_interleave(sampling_params, N, dim=0), max_topk
    ).reshape(B, N, V)
    bi = torch.arange(B, device=dev)
    cur = torch.zeros(B, dtype=torch.int64, device=dev)
    p_res = p_warp[:, 0]
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    counts = torch.ones(B, dtype=torch.int32, device=dev)
    tok_out = torch.zeros((B, depth + 1), dtype=torch.int32, device=dev)
    node_out = torch.zeros((B, depth + 1), dtype=torch.int64, device=dev)
    for d in range(depth):
        accepted = torch.zeros(B, dtype=torch.bool, device=dev)
        next_cur = cur
        tok_d = torch.zeros(B, dtype=torch.int32, device=dev)
        q_cur = q_nodes[bi, cur]  # (B, V)
        for r in range(mc):
            child = ctab[bi, cur, r].long()  # -1 when absent
            has = (child >= 0) & ~stopped & ~accepted
            x = cand[bi, torch.clamp(child, min=0)].long()
            px, qx = p_res[bi, x], q_cur[bi, x]
            u = torch.rand((B,), generator=generator, device=dev, dtype=torch.float32)
            acc = has & (u * torch.clamp(qx, min=1e-20) < px)
            next_cur = torch.where(acc, child, next_cur)
            tok_d = torch.where(acc, x.to(torch.int32), tok_d)
            accepted = accepted | acc
            # a rejection takes this node's draft distribution off the residual
            resid = torch.clamp(p_res - q_cur, min=0.0)
            norm = resid.sum(dim=-1, keepdim=True)
            resid = torch.where(norm > 1e-20, resid / torch.clamp(norm, min=1e-20), p_res)
            p_res = torch.where((has & ~acc)[:, None], resid, p_res)
        # an accept descends: the residual becomes the child's target dist
        p_res = torch.where(accepted[:, None], p_warp[bi, torch.clamp(next_cur, min=0)], p_res)
        tok_out[:, d] = torch.where(accepted, tok_d, torch.zeros_like(tok_d))
        node_out[:, d + 1] = torch.where(accepted, next_cur, torch.zeros_like(next_cur))
        counts = counts + accepted.to(torch.int32)
        stopped = stopped | ~accepted
        cur = next_cur
    # the last token (the bonus after a full walk, else the residual draw)
    # lands at counts - 1
    tok_out[bi, counts.long() - 1] = _categorical(p_res, generator)
    idx = torch.arange(depth + 1, device=dev)[None, :]
    # node_out past the count holds the root (0): fixup_cache_paths takes junk there
    return torch.where(idx < counts[:, None], tok_out, torch.zeros_like(tok_out)), counts, node_out


def q_to_target_vocab(q_draft: torch.Tensor, d2t: torch.Tensor, target_vocab: int) -> torch.Tensor:
    """A draft-vocab distribution (..., Vd) onto the target vocab through
    the d2t table (draft d is target d + d2t[d])."""
    Vd = q_draft.shape[-1]
    tgt = torch.arange(Vd, device=q_draft.device) + d2t[:Vd].long()
    out = torch.zeros(q_draft.shape[:-1] + (target_vocab,), dtype=q_draft.dtype, device=q_draft.device)
    return out.index_add_(out.dim() - 1, tgt, q_draft)


class DynamicTokenTree:
    """A dynamic token tree: a static node budget whose connectivity is
    decided on the device each round by cumulative draft probability (the
    reference's ``DynamicTokenTree``; params ``step``, ``branching_factor``,
    ``num_inputs``, ``num_verification_token``).

    Layout: node 0 the root; step 0 adds nodes 1..bf (the root's top-bf
    tokens); each later step adds ``ni * bf`` nodes, the top-``ni`` nodes of
    the previous level by cumulative draft log-probability expanding ``bf``
    children each. Every node runs the draft (so the draft cache holds K/V
    for any node that is accepted); the choice only gates expansion."""

    def __init__(self, params: Dict):
        self.steps = int(params["step"])
        self.bf = int(params["branching_factor"])
        self.ni = int(params["num_inputs"])
        self.nv = int(params.get("num_verification_token", 0)) or None
        if self.steps < 1 or self.bf < 1 or self.ni < 1:
            raise ValueError("dynamic tree needs step/branching_factor/num_inputs >= 1")
        if self.ni > self.bf:
            raise ValueError(
                "num_inputs must be <= branching_factor (the level-1 frontier "
                "is root's branching_factor children)"
            )
        # node-id offsets and widths per level: 1, bf, ni * bf, ...
        self.level_offsets = [0, 1]
        self.level_widths = [1, self.bf]
        for _ in range(1, self.steps):
            self.level_offsets.append(self.level_offsets[-1] + self.level_widths[-1])
            self.level_widths.append(self.ni * self.bf)
        self.num_nodes = self.level_offsets[-1] + self.level_widths[-1]
        self.depth = self.steps
        if self.nv is not None and self.nv != self.num_nodes:
            raise NotImplementedError(
                "num_verification_token subsetting is not implemented: every "
                "tree node is verified (set it to the node budget "
                f"{self.num_nodes} or omit it) — refusing to silently ignore "
                "the knob"
            )
        # a child's rank among its siblings is static (its index in the
        # level mod bf); only its parent is decided on the device
        self.ranks = np.zeros(self.num_nodes, np.int64)
        for s in range(1, self.steps + 1):
            o, w = self.level_offsets[s], self.level_widths[s]
            self.ranks[o : o + w] = np.arange(w) % self.bf
        self._ranks: Dict[torch.device, torch.Tensor] = {}

    @property
    def k_out(self) -> int:
        return self.steps + 1

    def ranks_on(self, device) -> torch.Tensor:
        """:attr:`ranks` as a tensor on ``device`` (made once a device)."""
        device = torch.device(device)
        if device not in self._ranks:
            self._ranks[device] = torch.from_numpy(self.ranks).to(device)
        return self._ranks[device]


def _place_dynamic_mask(anc_rows: torch.Tensor, p: torch.Tensor, bucket: int) -> torch.Tensor:
    """:func:`place_tree_mask` for ancestry rows decided on the device:
    ``anc_rows`` (B, Q, N) bool."""
    B, Q, N = anc_rows.shape
    cols = torch.arange(bucket, device=p.device)[None, :]
    rel = cols - p  # (B, bucket)
    anc_pad = torch.cat([anc_rows, torch.zeros((B, Q, 1), dtype=torch.bool, device=p.device)], dim=-1)
    idx = torch.clamp(rel, 0, N)[:, None, :].expand(B, Q, bucket)
    tree_part = torch.take_along_dim(anc_pad, idx, dim=2) & (rel >= 0)[:, None, :]
    return ((cols < p)[:, None, :] | tree_part)[:, None].contiguous()


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _draws(q: torch.Tensor, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` i.i.d. draws from each row of ``q`` (B, w, V) -> (B, w, n)
    int64."""
    B, w, V = q.shape
    flat = q.reshape(B * w, V)
    return torch.stack([_categorical(flat, generator) for _ in range(n)], dim=-1).reshape(B, w, n).long()


def _sampled_children(dlogits, sp, generator, max_topk, n, d2t, target_vocab):
    """A level's sampled expansion: (the warped draft distributions q (B,
    w, Vd), q on the target vocab (B, w, target_vocab), n i.i.d. draws a
    node from q (B, w, n), in the draft vocab)."""
    B, w, Vd = dlogits.shape
    q_l = warped_probs(dlogits.reshape(B * w, Vd), torch.repeat_interleave(sp, w, dim=0), max_topk).reshape(B, w, Vd)
    q_t = q_l if d2t is None else q_to_target_vocab(q_l, d2t, target_vocab)
    if q_t.shape[-1] < target_vocab:
        q_t = torch.nn.functional.pad(q_t, (0, target_vocab - q_t.shape[-1]))
    return q_l, q_t, _draws(q_l, n, generator)


def dynamic_tree_token_gen(
    draft_params: dict,
    target_params: dict,
    draft_cache: KVCache,
    target_cache: KVCache,
    hidden_buffer: torch.Tensor,
    inputs: StepInputs,
    generator: Optional[torch.Generator] = None,
    *,
    dyn: DynamicTokenTree,
    bucket: int,
    draft_hidden_fn: Callable,
    draft_spec: ModelSpec,
    target_spec: ModelSpec,
    target_mlp_fn: Callable,
    target_capture_layers: Optional[Tuple[int, ...]] = None,
    draft_lm_hidden_fn: Optional[Callable] = None,
    do_sample: bool = False,
    max_topk: int = 256,
) -> EagleOutput:
    """One fused dynamic-tree round: the tree's connectivity (each node's
    parent) decided on the device from cumulative draft log-probabilities;
    the rest as :func:`tree_token_gen`. Greedy expands each frontier node's
    top-bf draft tokens and verifies by the deepest contiguous argmax match
    through the connectivity; sampled draws each frontier node's bf
    children i.i.d. from its warped draft distribution and verifies by
    :func:`sampled_accept_walk`. Every choice is a topk, gather or where:
    nothing reads the device from the host."""
    N = dyn.num_nodes
    seq_ids, sp = inputs.seq_ids, inputs.sampling_params
    p = inputs.position_ids  # (B, 1)
    B, dev = p.shape[0], p.device
    slots = slot_ids_from_seq_ids(seq_ids, hidden_buffer.shape[0] - 1)
    d2t = d2t_table(draft_params)
    Vt = target_spec.vocab_size

    tokens = torch.zeros((B, N), dtype=torch.int32, device=dev)
    tokens[:, 0] = inputs.input_ids[:, 0]
    parent = torch.zeros((B, N), dtype=torch.int64, device=dev)
    depth = torch.zeros((B, N), dtype=torch.int64, device=dev)
    cumlp = torch.full((B, N), -1e30, dtype=torch.float32, device=dev)
    cumlp[:, 0] = 0.0
    anc = torch.zeros((B, N, N), dtype=torch.bool, device=dev)
    anc[:, 0, 0] = True
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    node_hidden = None  # (B, N, Hd), the draft hidden of each node
    q_nodes = torch.zeros((B, N, Vt), dtype=torch.float32, device=dev) if do_sample else None

    for s in range(dyn.steps + 1):
        off, w = dyn.level_offsets[s], dyn.level_widths[s]
        lvl = slice(off, off + w)
        if s == 0:
            prev_h = hidden_buffer[slots][:, None, :]
        else:  # each node's parent's draft hidden
            prev_h = torch.take_along_dim(node_hidden, parent[:, lvl, None], dim=1)
        step_inputs = StepInputs(
            input_ids=tokens[:, lvl], attention_mask=None,  # unused under mask_override
            position_ids=p + torch.arange(off, off + w, device=dev)[None, :],
            rope_position_ids=p + depth[:, lvl],
            mask_override=_place_dynamic_mask(anc[:, lvl], p, bucket),
            seq_ids=seq_ids, sampling_params=sp,
        )
        d_hidden, _ = draft_hidden_fn(
            draft_params, step_inputs.input_ids, prev_h, draft_cache, step_inputs, PHASE_TOKEN_GENERATION
        )
        if node_hidden is None:
            node_hidden = torch.zeros((B, N, d_hidden.shape[-1]), dtype=d_hidden.dtype, device=dev)
        node_hidden[:, lvl] = d_hidden
        if s == dyn.steps:
            break  # the deepest level: cache fill only

        lm_h = d_hidden if draft_lm_hidden_fn is None else draft_lm_hidden_fn(draft_params, d_hidden)
        dlogits = lm_head(draft_params, lm_h, draft_spec)[..., : draft_spec.vocab_size]
        if do_sample:
            # children drawn i.i.d. from the node's warped q (the accept
            # ratio's q); the frontier ranks by cumulative log q of the draws
            q_l, q_t, topt = _sampled_children(dlogits, sp, generator, max_topk, dyn.bf, d2t, Vt)
            topv = torch.log(torch.clamp(torch.take_along_dim(q_l, topt, dim=-1), min=1e-30))
            q_nodes[:, lvl] = q_t
        else:
            topv, topt = _top(torch.log_softmax(dlogits.float(), dim=-1), dyn.bf)
        if d2t is not None:
            topt = topt + d2t[topt].long()  # draft vocab -> target vocab (EAGLE3)

        # the expansion frontier: the level's top-ni by cumulative log-prob
        lvl_cum = cumlp[:, lvl]
        _, sel_local = _top(lvl_cum, min(dyn.ni, w) if s > 0 else 1)  # (B, ni)
        nxt = slice(dyn.level_offsets[s + 1], dyn.level_offsets[s + 1] + dyn.level_widths[s + 1])
        nw = dyn.level_widths[s + 1]
        # frontier node j's children at nxt.start + j * bf + r
        child_tok = torch.take_along_dim(topt, sel_local[:, :, None], dim=1).reshape(B, -1)[:, :nw]
        child_lp = torch.take_along_dim(topv, sel_local[:, :, None], dim=1).reshape(B, -1)[:, :nw]
        child_cum = torch.repeat_interleave(torch.take_along_dim(lvl_cum, sel_local, dim=1), dyn.bf, dim=1)[:, :nw]
        child_par = torch.repeat_interleave(off + sel_local, dyn.bf, dim=1)[:, :nw]  # (B, nw)
        tokens[:, nxt] = child_tok.to(torch.int32)
        cumlp[:, nxt] = child_cum + child_lp
        parent[:, nxt] = child_par
        depth[:, nxt] = torch.take_along_dim(depth, child_par, dim=1) + 1
        # a child's ancestry: its parent's row and itself
        anc[:, nxt] = torch.take_along_dim(anc, child_par[:, :, None].expand(B, nw, N), dim=1) | eye[nxt][None]

    target_inputs = StepInputs(
        input_ids=tokens, attention_mask=None, position_ids=p + torch.arange(N, device=dev)[None, :],
        rope_position_ids=p + depth, mask_override=_place_dynamic_mask(anc, p, bucket),
        seq_ids=seq_ids, sampling_params=sp,
    )
    tlogits, _, t_hidden = model_logits(
        target_params, target_cache, target_inputs, spec=target_spec, phase=PHASE_TOKEN_GENERATION,
        mlp_fn=target_mlp_fn, return_hidden=True, capture_layers=target_capture_layers,
    )
    if do_sample:
        # the children table from the device-decided connectivity: one scatter
        ids = torch.arange(1, N, device=dev)[None, :].expand(B, N - 1)
        ctab = torch.full((B, N, dyn.bf), -1, dtype=torch.int64, device=dev)
        ctab[torch.arange(B, device=dev)[:, None], parent[:, 1:], dyn.ranks_on(dev)[None, 1:]] = ids
        out_tokens, counts, best_nodes = sampled_accept_walk(
            ctab, dyn.steps, tokens, tlogits, q_nodes, sp, generator, max_topk
        )
    else:
        greedy = torch.argmax(tlogits, dim=-1).to(torch.int32)  # (B, N)
        node_ids = torch.arange(N, device=dev)[None, :]
        cur = torch.zeros(B, dtype=torch.int64, device=dev)
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        acc = torch.zeros(B, dtype=torch.int32, device=dev)
        walk = [cur]
        for _ in range(dyn.steps):
            pred = torch.take_along_dim(greedy, cur[:, None], dim=1)  # (B, 1)
            # the child of cur whose token is the target's prediction
            match = (parent == cur[:, None]) & (node_ids > 0) & (depth > 0) & (tokens == pred)
            found = match.any(dim=1) & alive
            cur = torch.where(found, torch.argmax(match.to(torch.int32), dim=1), cur)
            acc = acc + found.to(torch.int32)
            alive = found
            walk.append(cur)
        best_nodes = torch.stack(walk, dim=1)  # (B, steps + 1)
        counts = acc + 1
        toks = torch.take_along_dim(greedy, best_nodes, dim=1)
        idx = torch.arange(dyn.steps + 1, device=dev)[None, :]
        out_tokens = torch.where(idx < counts[:, None], toks, torch.zeros_like(toks))
    _finish_round(target_cache, draft_cache, hidden_buffer, t_hidden, seq_ids, slots, p, best_nodes, counts)
    return EagleOutput(out_tokens, counts, draft_cache, target_cache, hidden_buffer)


def _finish_round(target_cache, draft_cache, hidden_buffer, t_hidden, seq_ids, slots, p, best_nodes, counts):
    """The accepted path's K/V to contiguous slots in both caches, and the
    buffer line set to the target hidden at the bonus-producing node."""
    for cache in (target_cache, draft_cache):
        fixup_cache_paths(cache, slot_ids_from_seq_ids(seq_ids, cache.k.shape[1] - 1), p, best_nodes)
    bonus_node = torch.take_along_dim(best_nodes, counts.long()[:, None] - 1, dim=1)  # (B, 1)
    bonus = torch.take_along_dim(t_hidden, bonus_node[:, :, None], dim=1)[:, 0, :]
    hidden_buffer[slots] = bonus.to(hidden_buffer.dtype)


def tree_token_gen(
    draft_params: dict,
    target_params: dict,
    draft_cache: KVCache,
    target_cache: KVCache,
    hidden_buffer: torch.Tensor,
    inputs: StepInputs,
    generator: Optional[torch.Generator] = None,
    *,
    tree: TokenTree,
    bucket: int,
    draft_hidden_fn: Callable,
    draft_spec: ModelSpec,
    target_spec: ModelSpec,
    target_mlp_fn: Callable,
    target_capture_layers: Optional[Tuple[int, ...]] = None,
    draft_lm_hidden_fn: Optional[Callable] = None,
    do_sample: bool = False,
    max_topk: int = 256,
) -> EagleOutput:
    """One fused static-tree round (the reference's ``tree_token_gen``).

    The draft runs one forward per level, over all of the level's nodes
    (the deepest level only fills the draft cache); each node's children
    take its top draft tokens in rank order (sampled: i.i.d. draws from its
    warped draft distribution). The target verifies all N nodes in one
    pass under the tree's ancestry mask; greedy or recursive-rejection
    acceptance; the accepted path's K/V moves to contiguous slots in both
    caches and the buffer line takes the bonus-producing node's target
    hidden. ``draft_hidden_fn(params, tokens, prev_hidden, cache, inputs,
    phase) -> (hidden, cache)`` is the EAGLE or EAGLE3 draft; a ``d2t``
    table in the draft params maps draft tokens into the target vocab."""
    N = tree.num_nodes
    t = tree.tensors(inputs.position_ids.device)
    seq_ids, sp = inputs.seq_ids, inputs.sampling_params
    p = inputs.position_ids  # (B, 1) the root's slot
    B, dev = p.shape[0], p.device
    slots = slot_ids_from_seq_ids(seq_ids, hidden_buffer.shape[0] - 1)
    d2t = d2t_table(draft_params)
    Vt = target_spec.vocab_size

    cand = torch.zeros((B, N), dtype=torch.int32, device=dev)
    cand[:, 0] = inputs.input_ids[:, 0]
    prev_h = hidden_buffer[slots][:, None, :]  # the root's draft feature
    q_nodes = torch.zeros((B, N, Vt), dtype=torch.float32, device=dev) if do_sample else None
    for lv, nodes in enumerate(t["levels"]):
        w = nodes.shape[0]
        if lv > 0:  # each node's parent's draft hidden from the level before
            prev_h = prev_h[:, t["parent_local"][lv - 1], :]
        tok_l = cand[:, nodes]  # (B, w)
        step_inputs = StepInputs(
            input_ids=tok_l, attention_mask=None,  # unused under mask_override
            position_ids=p + nodes[None, :], rope_position_ids=(p + lv).expand(B, w),
            mask_override=place_tree_mask(t["anc_levels"][lv], p, bucket),
            seq_ids=seq_ids, sampling_params=sp,
        )
        prev_h, _ = draft_hidden_fn(draft_params, tok_l, prev_h, draft_cache, step_inputs, PHASE_TOKEN_GENERATION)
        if lv == tree.depth:
            break  # the deepest level: cache fill only
        lm_h = prev_h if draft_lm_hidden_fn is None else draft_lm_hidden_fn(draft_params, prev_h)
        dlogits = lm_head(draft_params, lm_h, draft_spec)[..., : draft_spec.vocab_size]
        pl, cr = t["parent_local"][lv], t["child_rank"][lv]
        if do_sample:
            _, q_t, top = _sampled_children(dlogits, sp, generator, max_topk, tree.max_children, d2t, Vt)
            q_nodes[:, nodes] = q_t
        else:
            top = _top(dlogits, tree.max_children)[1]
        if d2t is not None:
            top = top + d2t[top].long()  # draft vocab -> target vocab
        cand[:, t["levels"][lv + 1]] = top[:, pl, cr].to(torch.int32)

    target_inputs = StepInputs(
        input_ids=cand, attention_mask=None, position_ids=p + torch.arange(N, device=dev)[None, :],
        rope_position_ids=p + t["level_of"][None, :], mask_override=place_tree_mask(t["anc_mask"], p, bucket),
        seq_ids=seq_ids, sampling_params=sp,
    )
    tlogits, _, t_hidden = model_logits(
        target_params, target_cache, target_inputs, spec=target_spec, phase=PHASE_TOKEN_GENERATION,
        mlp_fn=target_mlp_fn, return_hidden=True, capture_layers=target_capture_layers,
    )
    if do_sample:
        tokens, counts, best_nodes = sampled_tree_accept(tree, cand, tlogits, q_nodes, sp, generator, max_topk)
    else:
        tokens, counts, best_nodes = greedy_tree_accept(tree, cand, tlogits)
    _finish_round(target_cache, draft_cache, hidden_buffer, t_hidden, seq_ids, slots, p, best_nodes, counts)
    return EagleOutput(tokens, counts, draft_cache, target_cache, hidden_buffer)
