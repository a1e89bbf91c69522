"""The histogram tree grower's four device passes (T1-T4) and T1's and
T4's grouping of rows by node (G), each as a hand-written CUDA kernel
(``csrc/tree_hist.cu``) with its plain PyTorch version beside it.  They replace the level body and the leaf sums of
`spark_sklearn_tpu/ops/trees.py` `grow_tree` (:42-148), its
`predict_tree` (:151-163) and the families' accumulation of a tree's
prediction (`spark_sklearn_tpu/models/trees.py:175-177, 257-261,
375-377`), batched over L lanes (one tree a lane).

- T1 `level_histogram(codes, local, stats, n_nodes, n_bins)` -> hist
  (L, n_nodes, d, n_bins, S): per lane, the sum of each of the S stats
  of a row (w·h, then w·g per output) over the rows of each (node,
  feature, bin); a row takes part where its `local` node id is >= 0
  (trees.py:70-84: live rows; rows of weight 0 add nothing and are left
  out by the caller).
- T2 `best_splits(hist, fmask, reg_lambda, min_child_weight)` -> (feat,
  bin, gain, split), each (L, n_nodes): cumulative sums over the bins,
  the gain summed over the outputs, `min_child_weight` on both sides,
  the last bin never a split, the feature mask, the first maximum over
  the flat (feature, bin) index, and ``split = gain > 1e-7``
  (trees.py:85-122).
- T3, three entry points with one count.  `level_step(codes, node,
  active, split_feat, split_bin, split, feat, thresh, is_leaf, local,
  last)`: one level's heap writes, routing and keys, in place
  (trees.py:123-136; at the last level also :139): the heap's level from
  T2's splits, every row at a splitting node moved to its child (a row at
  a shallower node is frozen there), and `local` set to the next level's
  keys for G, T1 (node - next offset, -1 where the row stopped or is
  inactive) or, at the `last` level, T4's keys (node, -1 where inactive)
  with is_leaf set at every row's node.  `accumulate(value, node, out,
  scale)`: ``out += scale[l] * value[l, node]`` from the grower's final
  nodes (the fit's update; `ops/trees.py` says why that is the walk's
  leaf).  `walk(codes, feat, thresh, is_leaf, value, depth, out, scale)`:
  `predict_tree` from the root, either returning the leaf values or
  adding ``scale[l] * value`` to `out`.  Both updates round once, as a
  fused multiply-add (the families' ``F + lr·live·delta`` and ``acc +
  live·pred``, which XLA contracts so in the reference's compiled fit).
- T4 `leaf_values(local, stats, n_nodes, reg_lambda)` -> (L, n_nodes,
  S - 1): per lane and node, ``-Σ w·g / (Σ w·h + λ)`` (trees.py:142-147).
- G `segments(local, n_nodes)` -> (perm, offs): each lane's rows grouped
  by node, in row order within a node (the plain version a stable sort,
  `segments_plain`).  `level_histogram_grouped` and `leaf_values_grouped`
  launch T1 and T4 on rows already grouped.

Shapes: codes (n, d) uint8 bin codes shared by the lanes; local, node
(L, n) int32; frozen (L, n) bool; stats (L, n, S) float32; a tree's
arrays (L, M) with M = 2**(depth+1) - 1 heap nodes, value (L, M, n_out).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back.  `LAUNCHES` counts
a wrapper's calls on the card (plain runs are not counted).

Order of the sums.  The plain versions add as the reference does on the
CPU: `index_add_` adds each node's rows in row order, and `cumsum_bins`
scans the bins in XLA's order.  The kernels keep that order, so they give
the plain versions' bits on the CPU (and the same bits launch after
launch), and a tie between two splits breaks the same way on both
devices.  T1 and T4 first group each lane's taking-part rows by node
(`segments`: on the card a counting sort, `tree_segments`, stable, so a
node's rows keep their order).  The order binds each sum alone, not a
whole column, and what bounds T1 and T4 at the shallow levels is the
longest chain of one cell (a one-hot column's hot bin, a big leaf), one
dependent add a row, and the 32-row batches a warp takes one after
another.  T1 finds the rows of a batch that share a cell by ballots on
the code bits and adds them in order: a one-hot batch's two cells in
registers, a lane a stat; small groups in rounds by rank; big ones by
their lowest lane.  At the deep levels T1 is bound by the bytes of the
histogram it writes.  T4 runs one chain a (node, stat), fed from shared
memory that `cp.async` fills two tiles ahead, so its loads stay off the
chain.  T2 scans the bins in XLA's order, from feature blocks staged
whole in shared memory (`split_plan`: a few features a round, a cluster of
blocks at the roots), and reads only the features a node's mask keeps.
T3 takes a tile of 256 rows a block, a row a thread, for a group of
lanes: the tile's codes are staged once in shared memory and serve every
lane of the group, and the level's splits (the walk: the whole trees)
sit in shared memory packed a word a node (`row_plan`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"tree_level_hist": 0, "tree_best_split": 0, "tree_route": 0,
            "tree_leaf_values": 0, "tree_segments": 0}

#: shared memory for T1's histogram tile in one block (three blocks, with
#: their staged rows, fit an SM's 228 KB)
HIST_SMEM_BYTES = 48 * 1024
#: the most dynamic shared memory a block takes on an H100 (227 KB)
MAX_SMEM = 232448
#: T1 narrows its feature tiles until a launch has about this many
#: blocks per SM (few nodes: the shallow levels)
HIST_BLOCKS_PER_SM = 4
#: rows T1 stages a tile (a loader thread each), the tiles in shared
#: memory and the most warps that add features (one each), as
#: `kRowTile`, `kLoaders`, `kStages` and `kColWarps`
ROW_TILE = 128
HIST_LOADERS = ROW_TILE
HIST_STAGES = 3
HIST_WARPS = 6
#: T4's tile of rows a (node, stat) chain takes from shared memory, a
#: stat's row padded for 16-byte loads, and the tiles in shared memory, as
#: `kLeafRows`, `kLeafPad` and `kLeafStages`
LEAF_ROWS = 128
LEAF_PAD = LEAF_ROWS + 4
LEAF_STAGES = 3
#: rows a block of the grouping counts and scatters, and the most shared
#: memory its blocks take (a node key and a row's key each 4 bytes; up to
#: 10240 nodes, depth 12), as `kGroupTile` and `kGroupSmem`
GROUP_TILE = 2048
GROUP_SMEM = 48 * 1024
#: T2's threads a block, the scanned sums' row for a 16-bin block, the
#: most staged rounds of features (the one scanned and two ahead), the
#: most blocks a (lane, node) (a thread-block cluster) and the most
#: features a round (a group of whole warps each), as `kSplitThreads`,
#: `kSplitRow`, `kSplitMaxStages`, `kSplitMaxChunks` and the kernel's G
SPLIT_THREADS = 256
SPLIT_ROW = 17
SPLIT_STAGES = 3
SPLIT_MAX_CHUNKS = 8
SPLIT_MAX_GROUPS = 8
#: T2 shares a (lane, node)'s features out over more blocks until a
#: launch has about this many blocks an SM (few nodes: the roots)
SPLIT_BLOCKS_PER_SM = 2
#: T2's dynamic shared memory at most: a block's, less the 1 KB that
#: holds its static shared memory (80 bytes: the warps' maxima); and what
#: leaves four blocks an SM, which fewer stages keep to where they can
SPLIT_MAX_SMEM = MAX_SMEM - 1024
SPLIT_SMEM_FOUR = MAX_SMEM // 4 - 1024
#: T3's threads a block (a row each, as `kRowThreads`); the most bytes of
#: a row tile's codes it stages in shared memory (d <= 96); the shared
#: memory of the level step's and the walk's blocks, at most; the row
#: tiles of a launch spread over more lane groups until it has about
#: this many blocks an SM (the best of 2, 4, 8 and 16 at phase 9's and
#: 10's shapes on the H100)
ROW_THREADS = 256
ROW_STAGE_BYTES = 24 * 1024
STEP_SMEM = 48 * 1024
WALK_SMEM = 96 * 1024
ROW_BLOCKS_PER_SM = 4


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _lane_ids(local, n_nodes):
    """(L, n) global segment ids lane * n_nodes + local (int64)."""
    lane = torch.arange(local.shape[0], device=local.device)[:, None]
    return lane * n_nodes + local.long()


def level_histogram_plain(codes, local, stats, n_nodes, n_bins=256):
    """T1's plain version: one `index_add_` over (lane, node, feature,
    bin) ids, as the reference's `segment_sum`."""
    L, n = local.shape
    d = codes.shape[1]
    S = stats.shape[2]
    live = local >= 0
    seg = _lane_ids(local, n_nodes)[live]                        # (m,)
    rows = torch.nonzero(live)[:, 1]
    ids = ((seg[:, None] * d + torch.arange(d, device=codes.device))
           * n_bins + codes[rows].long())                          # (m, d)
    vals = stats[live]                                             # (m, S)
    out = torch.zeros((L * n_nodes * d * n_bins, S), dtype=stats.dtype,
                      device=stats.device)
    out.index_add_(0, ids.reshape(-1),
                   vals[:, None, :].expand(-1, d, -1).reshape(-1, S))
    return out.reshape(L, n_nodes, d, n_bins, S)


def _sequential_cumsum(x):
    out = torch.empty_like(x)
    acc = x[..., 0].clone()
    out[..., 0] = acc
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def cumsum_bins(x, base: int = 16):
    """Cumulative sums over the last axis in the order XLA's CPU backend
    adds them for `jnp.cumsum` (its reduce-window rewrite): in order
    within blocks of `base`, then the blocks' totals scanned the same way
    (recursively) and added to each block.  So the CPU path rounds as the
    reference does; on the card T2 scans its own way."""
    B = x.shape[-1]
    if B <= base:
        return _sequential_cumsum(x)
    pad = (-B) % base
    blocks = torch.nn.functional.pad(x, (0, pad)).reshape(
        *x.shape[:-1], -1, base)
    inner = _sequential_cumsum(blocks)
    before = cumsum_bins(inner[..., -1], base)
    before = torch.cat([torch.zeros_like(before[..., :1]),
                        before[..., :-1]], dim=-1)
    return (inner + before[..., None]).reshape(
        *x.shape[:-1], B + pad)[..., :B]


def best_splits_plain(hist, fmask, reg_lambda, min_child_weight):
    """T2's plain version: the reference's level body (trees.py:85-122),
    op for op in float32."""
    L, N, d, B, S = hist.shape
    lam = torch.tensor(reg_lambda, dtype=hist.dtype, device=hist.device)
    mcw = torch.tensor(min_child_weight, dtype=hist.dtype,
                       device=hist.device)
    cum_h = cumsum_bins(hist[..., 0])
    tot_h = cum_h[..., -1:]
    left_h, right_h = cum_h, tot_h - cum_h
    gain = torch.zeros_like(cum_h)
    for o in range(S - 1):
        cum_g = cumsum_bins(hist[..., 1 + o])
        tot_g = cum_g[..., -1:]
        left_g, right_g = cum_g, tot_g - cum_g
        gain = gain + (left_g * left_g / (left_h + lam)
                       + right_g * right_g / (right_h + lam)
                       - tot_g * tot_g / (tot_h + lam))
    ok = (left_h >= mcw) & (right_h >= mcw)
    neg_inf = torch.tensor(float("-inf"), dtype=hist.dtype,
                           device=hist.device)
    gain = torch.where(ok, gain, neg_inf)
    gain[..., -1] = neg_inf
    if fmask is not None:
        gain = torch.where(fmask[None, :, :, None], gain, neg_inf)
    flat = gain.reshape(L, N, d * B)
    best = torch.argmax(flat, dim=2)              # the first maximum
    best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
    return ((best // B).to(torch.int32), (best % B).to(torch.int32),
            best_gain, best_gain > 1e-7)


def level_step_plain(codes, node, active, split_feat, split_bin, split,
                     feat, thresh, is_leaf, local, last):
    """T3's level step, plain (trees.py:123-136, and :139 at the last
    level), in place: the heap's level (feat = split_feat or -1, thresh,
    is_leaf = ~split); every row at a splitting node of the level moves
    to child 2·node + 1 + (code > bin), a row at a shallower node (frozen)
    stays; then `local` gets the next level's keys (node - (2N - 1), -1
    where the row stopped or is inactive) or, with `last`, T4's keys
    (node, -1 where inactive), and is_leaf is set at every row's node."""
    N = split.shape[1]
    offset = N - 1
    sf = torch.where(split, split_feat, -1)
    feat[:, offset:offset + N] = sf
    thresh[:, offset:offset + N] = split_bin
    is_leaf[:, offset:offset + N] = ~split
    j = (node - offset).clamp(0, N - 1).long()
    f = torch.gather(sf, 1, j)
    code_at = codes.long().T.gather(0, f.clamp_min(0).long())     # (L, n)
    go = (node >= offset) & (f >= 0)
    right = (code_at > torch.gather(split_bin, 1, j)).to(node.dtype)
    node.copy_(torch.where(go, 2 * node + 1 + right, node))
    if last:
        is_leaf.scatter_(1, node.long(), True)
        local.copy_(torch.where(active, node, -1))
    else:
        nxt = 2 * N - 1
        local.copy_(torch.where(active & (node >= nxt), node - nxt, -1))


def accumulate_plain(value, node, out, scale):
    """T3's accumulate, plain: ``out += scale[l] * value[l, node[l, r]]``
    in place (returned), one rounding as the walk's."""
    vals = torch.gather(value, 1, node.long()[..., None].expand(
        -1, -1, value.shape[2]))
    return out.addcmul_(scale[:, None, None], vals)


def walk_plain(codes, feat, thresh, is_leaf, value, depth, out=None,
               scale=None):
    """T3's walk, plain: `predict_tree` (trees.py:151-163) for each lane's
    tree, then either the leaf values (L, n, n_out) or ``out += scale[l]
    * value`` (in place, returned)."""
    L = feat.shape[0]
    n = codes.shape[0]
    codes_t = codes.long().T                                       # (d, n)
    node = torch.zeros((L, n), dtype=torch.long, device=codes.device)
    for _ in range(depth):
        f = torch.gather(feat, 1, node)
        stop = torch.gather(is_leaf, 1, node) | (f < 0)
        code_at = codes_t.gather(0, f.clamp_min(0).long())
        go_right = code_at > torch.gather(thresh, 1, node)
        node = torch.where(stop, node, 2 * node + 1 + go_right.long())
    vals = torch.gather(value, 1, node[..., None].expand(
        -1, -1, value.shape[2]))
    if out is None:
        return vals
    # one rounding, as the reference's compiled update (XLA contracts
    # F + lr·live·delta into a fused multiply-add)
    return out.addcmul_(scale[:, None, None], vals)


def leaf_values_plain(local, stats, n_nodes, reg_lambda):
    """T4's plain version: per-node sums by `index_add_`, then the Newton
    step -Σg / (Σh + λ) (trees.py:142-147)."""
    L = local.shape[0]
    S = stats.shape[2]
    live = local >= 0
    sums = torch.zeros((L * n_nodes, S), dtype=stats.dtype,
                       device=stats.device)
    sums.index_add_(0, _lane_ids(local, n_nodes)[live], stats[live])
    sums = sums.reshape(L, n_nodes, S)
    lam = torch.tensor(reg_lambda, dtype=stats.dtype, device=stats.device)
    return -sums[..., 1:] / (sums[..., :1] + lam)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("tree_hist")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tree_level_hist.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                    i, i, p]
    lib.tree_best_split.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                    i, i, i, i, f, f, p]
    lib.tree_level_step.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                    i, i, i, i, i, i, i, p]
    lib.tree_walk.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                              i, i, p]
    lib.tree_add_leaves.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.tree_leaf_values.argtypes = [p, p, p, p, i, i, i, i, f, i, p]
    lib.tree_segments.argtypes = [p, p, p, p, i, i, i, p]
    for fn in (lib.tree_level_hist, lib.tree_best_split, lib.tree_level_step,
               lib.tree_walk, lib.tree_add_leaves, lib.tree_leaf_values,
               lib.tree_segments):
        fn.restype = i
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, t, shape, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on_card(t, name) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one; raises
    on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def segments_plain(local, n_nodes):
    """The grouping's plain version: a stable sort of the int32 keys
    lane·(n_nodes+1) + node (n_nodes for a row with local < 0), then a
    binary search for where each key's rows begin."""
    L, n = local.shape
    width = n_nodes + 1
    lane = torch.arange(L, dtype=torch.int32, device=local.device)[:, None]
    key = (torch.where(local >= 0, local, n_nodes) + lane * width).reshape(-1)
    sorted_key, perm = torch.sort(key, stable=True)
    offs = torch.searchsorted(
        sorted_key, torch.arange(L * width + 1, dtype=torch.int32,
                                 device=local.device), out_int32=True)
    return perm.to(torch.int32), offs


def segments(local, n_nodes):
    """The rows of each (lane, node) together: (perm (L·n,) int32 flat
    row ids lane·n + row, sorted by (lane, node) and, within a node, by
    row; offs (L·(n_nodes+1) + 1,) int32, where node j of lane l holds
    perm[offs[l·(n_nodes+1) + j] : offs[l·(n_nodes+1) + j + 1]]).  Rows
    with local < 0 sort into each lane's last slot, which no kernel
    reads.  On the card a counting sort (`tree_segments`: counts a tile
    of rows, scans a lane, scatters a tile in row order); on the CPU
    `segments_plain`."""
    L, n = local.shape
    width = n_nodes + 1
    if L * width >= 2 ** 31 or L * n >= 2 ** 31:
        raise ValueError("too many lanes x nodes for int32 segment keys")
    if not _on_card(local, "segments"):
        return segments_plain(local, n_nodes)
    dev = local.device
    _check("local", local, (L, n), torch.int32, dev)
    if 4 * (width + GROUP_TILE) > GROUP_SMEM:
        raise ValueError(f"the grouping cannot take {n_nodes} nodes")
    perm = torch.empty(L * n, dtype=torch.int32, device=dev)
    offs = torch.empty(L * width + 1, dtype=torch.int32, device=dev)
    counts = torch.empty((2, L, -(-n // GROUP_TILE), width),
                         dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().tree_segments(local.data_ptr(), perm.data_ptr(),
                                  offs.data_ptr(), counts.data_ptr(), L, n,
                                  n_nodes, _stream(dev))
    _raise_on(rc, "tree_segments")
    LAUNCHES["tree_segments"] += 1
    return perm, offs


def hist_plan(d: int, S: int, n_bins: int, L: int, n_nodes: int,
              n_sm: int) -> dict:
    """T1's launch.  A block holds `ft` features' (n_bins, sp) histogram
    tiles (the S stats padded to the vector width `vw`: 2 for S <= 2,
    else 4), at most `HIST_WARPS` (a warp each) and what
    `HIST_SMEM_BYTES` holds, and few enough that the
    grid has about `HIST_BLOCKS_PER_SM` blocks an SM; its features go to
    `warps` warps (at most `HIST_WARPS`), and `HIST_LOADERS` more threads
    stage rows.  Returns
    ft, vw, sp, warps, threads, the grid and the dynamic shared memory
    (`hist_smem`)."""
    vw = 2 if S <= 2 else 4
    sp = -(-S // vw) * vw
    tile = n_bins * sp * 4                      # one feature's tile
    ft = max(1, min(d, HIST_SMEM_BYTES // tile, HIST_WARPS))
    tiles_wanted = -(-HIST_BLOCKS_PER_SM * n_sm // (L * n_nodes))
    ft = max(1, min(ft, -(-d // tiles_wanted)))
    ft = -(-d // -(-d // ft))                   # even tiles
    warps = min(ft, HIST_WARPS)
    smem = hist_smem(ft, n_bins, sp, warps)
    if smem > MAX_SMEM or n_bins > 256:
        raise ValueError(f"T1 cannot take {S} stats at {n_bins} bins in one "
                         f"block ({smem} bytes of shared memory)")
    return {"ft": ft, "vw": vw, "sp": sp, "warps": warps,
            "threads": 32 * warps + HIST_LOADERS,
            "grid": (L * n_nodes, -(-d // ft)), "smem": smem}


def hist_smem(ft: int, n_bins: int, sp: int, warps: int) -> int:
    """T1's dynamic shared memory (bytes), as `level_hist` lays it out:
    the (ft, n_bins, sp) histogram tiles; per stage a tile of rows' stats
    (sp floats), code words ((ft + 2) // 4 + 1 words: the 4-byte words
    holding a row's ft codes) and first code byte; a tile of code bytes a
    feature warp."""
    words = (ft + 2) // 4 + 1
    return (4 * (-(-ft * n_bins * sp // 4) * 4)
            + HIST_STAGES * ROW_TILE * (4 * sp + 4 * words + 1)
            + warps * ROW_TILE)


def leaf_plan(S: int, L: int, n_nodes: int) -> dict:
    """T4's launch: a one-warp block a (lane, node), ceil(S / 32) passes
    of up to 32 stats (a lane each), and `LEAF_STAGES` tiles of
    `LEAF_ROWS` rows x a pass's stats in shared memory."""
    width = min(S, 32)
    smem = LEAF_STAGES * width * LEAF_PAD * 4
    return {"grid": L * n_nodes, "threads": 32, "passes": -(-S // 32),
            "smem": smem}


def level_histogram(codes, local, stats, n_nodes, n_bins=256):
    """T1 (see the module docstring): the rows grouped by `segments`,
    then `level_histogram_grouped`."""
    if not _on_card(stats, "level_histogram"):
        return level_histogram_plain(codes, local, stats, n_nodes, n_bins)
    L, n, _ = stats.shape
    _check("local", local, (L, n), torch.int32, stats.device)
    perm, offs = segments(local, n_nodes)
    return level_histogram_grouped(codes, perm, offs, stats, n_nodes,
                                   n_bins)


def level_histogram_grouped(codes, perm, offs, stats, n_nodes, n_bins=256):
    """T1's kernel on rows already grouped by `segments` (card only: a
    CPU tensor raises; chip_smoke.py times it alone)."""
    dev = stats.device
    if dev.type != "cuda":
        raise ValueError("level_histogram_grouped runs on the card only")
    L, n, S = stats.shape
    d = codes.shape[1]
    _check("codes", codes, (n, d), torch.uint8, dev)
    _check("perm", perm, (L * n,), torch.int32, dev)
    _check("offs", offs, (L * (n_nodes + 1) + 1,), torch.int32, dev)
    _check("stats", stats, (L, n, S), torch.float32, dev)
    plan = hist_plan(d, S, n_bins, L, n_nodes, _sm_count(dev.index))
    hist = torch.empty((L, n_nodes, d, n_bins, S), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        rc = _lib().tree_level_hist(
            codes.data_ptr(), perm.data_ptr(), offs.data_ptr(),
            stats.data_ptr(), hist.data_ptr(), n, d, L, n_nodes, n_bins, S,
            plan["ft"], plan["vw"], plan["warps"], plan["smem"],
            _stream(dev))
    _raise_on(rc, "tree_level_hist")
    LAUNCHES["tree_level_hist"] += 1
    return hist


def _scan_conflicts(S: int, m: int, rs: int) -> int:
    """The most threads of one warp that T2's in-block scan sends to one
    shared-memory bank when chain c = (16-bin block c // S, stat c % S)
    writes its running sums to rows of `rs` floats a stat,
    `SPLIT_ROW` floats a block."""
    worst = 1
    for c0 in range(0, m * S, 32):
        banks = [((c % S) * rs + SPLIT_ROW * (c // S)) % 32
                 for c in range(c0, min(c0 + 32, m * S))]
        worst = max(worst, max(banks.count(b) for b in set(banks)))
    return worst


def split_smem(m: int, S: int, d: int, rk: int, rs: int, stages: int,
               G: int) -> int:
    """T2's dynamic shared memory (bytes), as `best_split` lays it out:
    `stages` rounds of G staged feature blocks (m rows of rk floats); per
    group the scanned sums (S rows of rs floats), each stat's 16 block
    offsets, its total and its total's gain term; the node's list of kept
    features."""
    return 4 * (stages * G * m * rk + G * S * (rs + 16 + 2) + d)


@functools.lru_cache(maxsize=256)
def split_plan(L: int, N: int, d: int, n_bins: int, S: int,
               n_sm: int) -> dict:
    """T2's launch.  A block of `SPLIT_THREADS` takes the kept features
    of one (lane, node), G at a time (a round: a group of whole warps a
    feature; G the most of 1, 2, 4, 8 whose groups still have a thread a
    scan chain, up to the power of two that covers a block's share of
    d); `chunks` blocks
    (a cluster) share a (lane, node) where L·N alone gives fewer than
    `SPLIT_BLOCKS_PER_SM` blocks an SM.  A staged 16-bin block is a row
    of rk floats, rk = S (mod 32), so the scan's reads of a warp hit 32
    banks; the scanned sums are rows of rs floats a stat, rs chosen for
    the fewest bank conflicts of the scan's writes.  `stages` rounds (3:
    the one scanned and two ahead; 2 where 3 would leave fewer than four
    blocks an SM; fewer where S is large) fit the block's shared memory.
    Returns chunks, groups, grid, threads, rk, rs, stages, vw (the copy's
    floats, where the histogram is aligned) and smem; cached (the search
    for rs takes longer on the host than the kernel on the card)."""
    if n_bins % 16 or not 16 <= n_bins <= 256:
        raise ValueError(f"T2 takes n_bins a multiple of 16 up to 256, "
                         f"got {n_bins}")
    m = n_bins // 16
    rk = 16 * S + (S - 16 * S) % 32
    rs = min(range(SPLIT_ROW * m, SPLIT_ROW * m + 32),
             key=lambda r: (_scan_conflicts(S, m, r), r))
    chunks = max(1, min(SPLIT_MAX_CHUNKS, d,
                        -(-SPLIT_BLOCKS_PER_SM * n_sm // (L * N))))
    share = -(-d // chunks)                  # a block's features, at most
    G = 1
    while (2 * G <= SPLIT_MAX_GROUPS and G < share
           and SPLIT_THREADS // (2 * G) >= m * S):
        G *= 2
    fits = [st for st in range(SPLIT_STAGES, 0, -1)
            if split_smem(m, S, d, rk, rs, st, G) <= SPLIT_MAX_SMEM]
    if not fits:
        raise ValueError(f"T2 cannot take {S} stats at {n_bins} bins in one "
                         f"block")
    stages = next((st for st in fits if st >= 2 and split_smem(
        m, S, d, rk, rs, st, G) <= SPLIT_SMEM_FOUR), fits[0])
    vw = 4 if S % 4 == 0 else 2 if S % 2 == 0 else 1
    return {"chunks": chunks, "groups": G, "grid": L * N * chunks,
            "threads": SPLIT_THREADS, "rk": rk, "rs": rs, "stages": stages,
            "vw": vw, "smem": split_smem(m, S, d, rk, rs, stages, G)}


def best_splits(hist, fmask, reg_lambda, min_child_weight):
    """T2 (see the module docstring).  fmask: (n_nodes, d) bool, shared by
    the lanes, or None."""
    if not _on_card(hist, "best_splits"):
        return best_splits_plain(hist, fmask, reg_lambda, min_child_weight)
    dev = hist.device
    L, N, d, B, S = hist.shape
    _check("hist", hist, (L, N, d, B, S), torch.float32, dev)
    if fmask is not None:
        _check("fmask", fmask, (N, d), torch.bool, dev)
    plan = split_plan(L, N, d, B, S, _sm_count(dev.index))
    feat = torch.empty((L, N), dtype=torch.int32, device=dev)
    thr = torch.empty((L, N), dtype=torch.int32, device=dev)
    gain = torch.empty((L, N), dtype=torch.float32, device=dev)
    split = torch.empty((L, N), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().tree_best_split(
            hist.data_ptr(), None if fmask is None else fmask.data_ptr(),
            feat.data_ptr(), thr.data_ptr(), gain.data_ptr(),
            split.data_ptr(), L, N, d, B, S, plan["chunks"], plan["rk"],
            plan["rs"], plan["stages"], plan["groups"], plan["smem"],
            float(reg_lambda),
            float(min_child_weight), _stream(dev))
    _raise_on(rc, "tree_best_split")
    LAUNCHES["tree_best_split"] += 1
    return feat, thr, gain, split


def row_plan(n: int, d: int, L: int, per_lane: int, budget: int,
             n_sm: int) -> dict:
    """T3's launch (the level step's and the walk's).  A block of
    `ROW_THREADS` takes a tile of as many rows, a row a thread, for a
    group of `lg` lanes; the tile's codes are staged in shared memory
    where `ROW_THREADS`·d bytes fit `ROW_STAGE_BYTES`.  A lane takes
    `per_lane` bytes of shared memory; the lanes go into as few groups
    as `budget` allows, or more where the row tiles alone give fewer
    than `ROW_BLOCKS_PER_SM` blocks an SM (GB: 60 lanes, 81 tiles).  A
    block walks the tiles `grid_x` apart, as many blocks as an SM holds
    at once.  Returns lg, groups, grid_x, stage and smem."""
    stage = ROW_THREADS * d <= ROW_STAGE_BYTES
    tile = -(-ROW_THREADS * d // 16) * 16 if stage else 0
    fit = (budget - tile) // per_lane
    if fit < 1:
        raise ValueError(f"T3 cannot hold a lane's {per_lane} bytes of "
                         f"nodes in one block")
    tiles = -(-n // ROW_THREADS)
    groups = max(-(-L // fit), min(L, -(-ROW_BLOCKS_PER_SM * n_sm // tiles)))
    lg = -(-L // groups)
    groups = -(-L // lg)
    smem = tile + lg * per_lane
    per_sm = max(1, min(2048 // ROW_THREADS, MAX_SMEM // (smem + 1024)))
    grid_x = max(1, min(tiles, per_sm * n_sm // groups))
    return {"lg": lg, "groups": groups, "grid_x": grid_x, "stage": stage,
            "smem": smem}


def level_step(codes, node, active, split_feat, split_bin, split, feat,
               thresh, is_leaf, local, last):
    """T3's level step, in place (see the module docstring): node (L, n)
    int32 and the heap's feat, thresh (L, M) int32 and is_leaf (L, M)
    bool; active (L, n) bool; the level's split_feat, split_bin (L, N)
    int32 and split (L, N) bool from T2; local (L, n) int32 gets the next
    level's keys, or T4's at the `last` level."""
    if not _on_card(node, "level_step"):
        return level_step_plain(codes, node, active, split_feat, split_bin,
                                split, feat, thresh, is_leaf, local, last)
    dev = node.device
    L, n = node.shape
    N = split.shape[1]
    M = feat.shape[1]
    d = codes.shape[1]
    _check("codes", codes, (n, d), torch.uint8, dev)
    _check("node", node, (L, n), torch.int32, dev)
    _check("active", active, (L, n), torch.bool, dev)
    _check("local", local, (L, n), torch.int32, dev)
    _check("split_feat", split_feat, (L, N), torch.int32, dev)
    _check("split_bin", split_bin, (L, N), torch.int32, dev)
    _check("split", split, (L, N), torch.bool, dev)
    _check("feat", feat, (L, M), torch.int32, dev)
    _check("thresh", thresh, (L, M), torch.int32, dev)
    _check("is_leaf", is_leaf, (L, M), torch.bool, dev)
    if M < (4 if last else 2) * N - 1:
        raise ValueError(f"a heap of {M} nodes cannot take a level of {N}")
    plan = _step_plan(n, d, L, N, M, bool(last), _sm_count(dev.index))
    with torch.cuda.device(dev):
        rc = _lib().tree_level_step(
            codes.data_ptr(), node.data_ptr(), active.data_ptr(),
            split_feat.data_ptr(), split_bin.data_ptr(), split.data_ptr(),
            feat.data_ptr(), thresh.data_ptr(), is_leaf.data_ptr(),
            local.data_ptr(), L, n, d, N, M, plan["lg"], plan["grid_x"],
            int(plan["stage"]), int(last), plan["smem"], _stream(dev))
    _raise_on(rc, "tree_level_step")
    LAUNCHES["tree_route"] += 1


@functools.lru_cache(maxsize=256)
def _step_plan(n, d, L, N, M, last, n_sm):
    return row_plan(n, d, L, 4 * N + (M if last else 0), STEP_SMEM, n_sm)


@functools.lru_cache(maxsize=64)
def _walk_plan(n, d, L, M, n_sm):
    return row_plan(n, d, L, 4 * M, WALK_SMEM, n_sm)


def accumulate(value, node, out, scale):
    """T3's accumulate: ``out[l, r] += scale[l] * value[l, node[l, r]]``
    in place (returned), for the grower's final nodes `node` (L, n)
    int32; value (L, M, n_out), out (L, n, n_out), scale (L,) float32."""
    if not _on_card(out, "accumulate"):
        return accumulate_plain(value, node, out, scale)
    dev = out.device
    L, M, n_out = value.shape
    n = node.shape[1]
    _check("value", value, (L, M, n_out), torch.float32, dev)
    _check("node", node, (L, n), torch.int32, dev)
    _check("out", out, (L, n, n_out), torch.float32, dev)
    _check("scale", scale, (L,), torch.float32, dev)
    with torch.cuda.device(dev):
        rc = _lib().tree_add_leaves(
            node.data_ptr(), value.data_ptr(), scale.data_ptr(),
            out.data_ptr(), L, n, M, n_out, _stream(dev))
    _raise_on(rc, "tree_add_leaves")
    LAUNCHES["tree_route"] += 1
    return out


def walk(codes, feat, thresh, is_leaf, value, depth, out=None, scale=None):
    """T3's walk (see the module docstring).  With `out` (L, n, n_out)
    and `scale` (L,) it adds ``scale[l] * value`` to `out` in place and
    returns it; without, it returns the leaf values."""
    if not _on_card(value, "walk"):
        return walk_plain(codes, feat, thresh, is_leaf, value, depth, out,
                          scale)
    dev = value.device
    L, M, n_out = value.shape
    n, d = codes.shape
    _check("codes", codes, (n, d), torch.uint8, dev)
    _check("feat", feat, (L, M), torch.int32, dev)
    _check("thresh", thresh, (L, M), torch.int32, dev)
    _check("is_leaf", is_leaf, (L, M), torch.bool, dev)
    _check("value", value, (L, M, n_out), torch.float32, dev)
    if M != 2 ** (depth + 1) - 1:
        raise ValueError(f"a depth-{depth} tree has {2 ** (depth + 1) - 1} "
                         f"nodes, got {M}")
    if out is None:
        res = torch.empty((L, n, n_out), dtype=torch.float32, device=dev)
    else:
        _check("out", out, (L, n, n_out), torch.float32, dev)
        _check("scale", scale, (L,), torch.float32, dev)
        res = out
    plan = _walk_plan(n, d, L, M, _sm_count(dev.index))
    with torch.cuda.device(dev):
        rc = _lib().tree_walk(
            codes.data_ptr(), feat.data_ptr(), thresh.data_ptr(),
            is_leaf.data_ptr(), value.data_ptr(),
            None if out is None else scale.data_ptr(), res.data_ptr(), L, n,
            d, M, n_out, depth, plan["lg"], plan["grid_x"],
            int(plan["stage"]), plan["smem"], _stream(dev))
    _raise_on(rc, "tree_walk")
    LAUNCHES["tree_route"] += 1
    return res


def leaf_values(local, stats, n_nodes, reg_lambda):
    """T4 (see the module docstring): the rows grouped by `segments`,
    then `leaf_values_grouped`."""
    if not _on_card(stats, "leaf_values"):
        return leaf_values_plain(local, stats, n_nodes, reg_lambda)
    L, n, _ = stats.shape
    _check("local", local, (L, n), torch.int32, stats.device)
    perm, offs = segments(local, n_nodes)
    return leaf_values_grouped(perm, offs, stats, n_nodes, reg_lambda)


def leaf_values_grouped(perm, offs, stats, n_nodes, reg_lambda):
    """T4's kernel on rows already grouped by `segments` (card only: a
    CPU tensor raises; chip_smoke.py times it alone)."""
    dev = stats.device
    if dev.type != "cuda":
        raise ValueError("leaf_values_grouped runs on the card only")
    L, n, S = stats.shape
    _check("perm", perm, (L * n,), torch.int32, dev)
    _check("offs", offs, (L * (n_nodes + 1) + 1,), torch.int32, dev)
    _check("stats", stats, (L, n, S), torch.float32, dev)
    plan = leaf_plan(S, L, n_nodes)
    value = torch.empty((L, n_nodes, S - 1), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        rc = _lib().tree_leaf_values(
            perm.data_ptr(), offs.data_ptr(), stats.data_ptr(),
            value.data_ptr(), L, n, n_nodes, S, float(reg_lambda),
            plan["smem"], _stream(dev))
    _raise_on(rc, "tree_leaf_values")
    LAUNCHES["tree_leaf_values"] += 1
    return value
