"""Binned, level-wise decision-tree growth, batched over lanes.

Counterpart of `spark_sklearn_tpu/ops/trees.py`: the same histogram
grower (features pre-binned to uint8 codes, one (node, feature, bin)
histogram a level, the best split per node by cumulative sums and a first
argmax, Newton leaf values -G/(H+λ), nodes in a heap array with children
of i at 2i+1 and 2i+2), with a lane axis written out where the reference
`vmap`s: L trees grow at once on the same codes, each with its own
gradients, hessians and weights.  Each level is four device passes of
`ops/tree_kernels.py` (T1 histogram, T2 split choice, T3 routing; T4 the
leaf values after the last level), hand-written CUDA kernels on the card
and their plain versions on the CPU; the RF feature mask stays torch ops.

The semantics are the reference's: the gain is summed over the outputs,
`min_child_weight` holds on both sides, the last bin never splits, ties go
to the first (feature, bin), a node splits only where its gain > 1e-7, a
frozen sample stays where it is, and every sample still unfrozen after the
last level sits in a leaf.  Rows of weight 0 add nothing to a sum, so the
histograms and the leaf sums leave them out; they are routed all the
same (a leaf reached only by them is still a leaf).

Memory: the deepest level's histogram is (L, 2**(depth-1), d, n_bins, S)
float32 (226 MB a lane at depth 10, d = 54, S = 8), so `grow_tree` grows
its lanes in passes that each fit `max_hist_bytes`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from spark_sklearn_tpu_torch.ops import random as jr
from spark_sklearn_tpu_torch.ops.tree_kernels import (
    best_splits,
    leaf_values,
    level_histogram,
    route,
    walk,
)

#: most bytes of one level's histogram a pass of `grow_tree` builds
MAX_HIST_BYTES = 2 << 30


class Tree(NamedTuple):
    """L trees in heap layout, M = 2**(max_depth+1) - 1 nodes each."""
    feat: torch.Tensor       # (L, M) int32, -1 = leaf/unused
    thresh: torch.Tensor     # (L, M) int32 bin threshold (left if code <= )
    value: torch.Tensor      # (L, M, n_out) float32 leaf values
    is_leaf: torch.Tensor    # (L, M) bool


def feature_masks(feat_mask_key, max_depth: int, d: int, max_features,
                  device) -> List[Optional[torch.Tensor]]:
    """Per level, the (2**level, d) bool mask of the features a node may
    split on (trees.py:106-114): a node keeps the `max_features` smallest
    of d uniform scores drawn from ``fold_in(feat_mask_key, level)`` (all
    of them where scores tie with the kth); None where there is no mask.
    One draw and one sort serve every level: level l's nodes are rows
    2**l - 1 .. 2**(l+1) - 2 of the stack, as in the tree's heap."""
    if feat_mask_key is None or max_features is None or max_features >= d:
        return [None] * max_depth
    keys = [jr.fold_in(feat_mask_key, level) for level in range(max_depth)]
    scores = jr.uniform_ragged(
        keys, [2 ** level * d for level in range(max_depth)],
        device).reshape(-1, d)
    kth = torch.sort(scores, dim=1).values[:, max_features - 1:max_features]
    masks = scores <= kth
    return [masks[2 ** level - 1:2 ** (level + 1) - 1]
            for level in range(max_depth)]


def hist_bytes(max_depth: int, d: int, n_bins: int, S: int) -> int:
    """Bytes of one lane's deepest level histogram."""
    return 4 * 2 ** max(max_depth - 1, 0) * d * n_bins * S


def grow_tree(codes, g, h, w, max_depth: int, n_bins: int,
              min_child_weight: float = 1e-3, reg_lambda: float = 1.0,
              feat_mask_key=None, max_features=None, n_out: int = 1,
              max_hist_bytes: int = MAX_HIST_BYTES) -> Tree:
    """Grow L trees on binned features.

    codes: (n, d) uint8 bin codes.  g: (L, n, n_out) or (n, n_out)
    gradients; h: (L, n) or (n,) hessians (shared by the outputs); w: (L,
    n) sample weights (0 excludes: fold masks, subsample and bootstrap
    weights all enter here).  `feat_mask_key` (a threefry key) with
    `max_features` < d draws the per-level feature masks, shared by the
    lanes as the reference's static key is."""
    L, n = w.shape
    d = codes.shape[1]
    S = 1 + n_out
    masks = feature_masks(feat_mask_key, max_depth, d, max_features,
                          codes.device)
    per_pass = max(1, max_hist_bytes // hist_bytes(max_depth, d, n_bins, S))
    parts = []
    for lo in range(0, L, per_pass):
        hi = min(L, lo + per_pass)
        g_p = g[lo:hi] if g.dim() == 3 else g
        h_p = h[lo:hi] if h.dim() == 2 else h
        # w·h, then w·g per output (trees.py:60-61)
        stats = torch.cat([(h_p * w[lo:hi])[..., None],
                           g_p * w[lo:hi, :, None]], dim=-1).contiguous()
        parts.append(_grow(codes, stats, w[lo:hi] > 0, max_depth, n_bins,
                           min_child_weight, reg_lambda, masks))
    if len(parts) == 1:
        return parts[0]
    return Tree(*(torch.cat(x, dim=0) for x in zip(*parts)))


def _grow(codes, stats, active, max_depth, n_bins, min_child_weight,
          reg_lambda, masks) -> Tree:
    L, n, _ = stats.shape
    dev = stats.device
    max_nodes = 2 ** (max_depth + 1) - 1
    feat = torch.full((L, max_nodes), -1, dtype=torch.int32, device=dev)
    thresh = torch.zeros((L, max_nodes), dtype=torch.int32, device=dev)
    is_leaf = torch.zeros((L, max_nodes), dtype=torch.bool, device=dev)
    node = torch.zeros((L, n), dtype=torch.int32, device=dev)
    frozen = torch.zeros((L, n), dtype=torch.bool, device=dev)
    minus_one = torch.tensor(-1, dtype=torch.int32, device=dev)
    for level in range(max_depth):
        n_nodes = 2 ** level
        offset = n_nodes - 1
        local = torch.where(frozen | ~active, minus_one, node - offset)
        hist = level_histogram(codes, local, stats, n_nodes, n_bins)
        bf, bb, _, split = best_splits(hist, masks[level], reg_lambda,
                                       min_child_weight)
        del hist
        sf = torch.where(split, bf, minus_one)
        feat[:, offset:offset + n_nodes] = sf
        thresh[:, offset:offset + n_nodes] = bb
        is_leaf[:, offset:offset + n_nodes] = ~split
        route(codes, node, frozen, sf, bb, offset)
    # everything still unfrozen at the last level is a leaf
    is_leaf.scatter_(1, node.long(), True)
    value = leaf_values(torch.where(active, node, minus_one), stats,
                        max_nodes, reg_lambda)
    return Tree(feat=feat, thresh=thresh, value=value, is_leaf=is_leaf)


def predict_tree(tree: Tree, codes, max_depth: int):
    """(n, d) codes -> (L, n, n_out) leaf values of each lane's tree."""
    return walk(codes, tree.feat, tree.thresh, tree.is_leaf, tree.value,
                max_depth)


def accumulate_tree(tree: Tree, codes, max_depth: int, out, scale):
    """``out += scale[l] * predict_tree(tree)[l]`` in place (out (L, n,
    n_out), scale (L,)): the families' update of a prediction."""
    return walk(codes, tree.feat, tree.thresh, tree.is_leaf, tree.value,
                max_depth, out, scale)
