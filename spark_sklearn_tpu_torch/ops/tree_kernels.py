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
- T3 `route(codes, node, frozen, split_feat, split_bin, offset)`: one
  level's routing, in place (trees.py:129-136); and `walk(codes, feat,
  thresh, is_leaf, value, depth, out, scale)`: `predict_tree` from the
  root, either returning the leaf values or adding ``scale[l] * value``
  to `out` as one fused multiply-add (the families' ``F + lr·live·delta``
  and ``acc + live·pred``, which XLA contracts so in the reference's
  compiled fit).
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
chain.  T2 scans the bins in XLA's order.
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


def route_plain(codes, node, frozen, split_feat, split_bin, offset):
    """T3's routing, plain (trees.py:129-136), in place: a row that is
    not frozen moves to child 2·node + 1 + (code > bin) of a node that
    splits (split_feat >= 0) and freezes at one that does not."""
    j = (node - offset).clamp_min(0).long()
    f = torch.gather(split_feat, 1, j)
    b = torch.gather(split_bin, 1, j)
    code_at = codes.long().T.gather(0, f.clamp_min(0).long())     # (L, n)
    go = (~frozen) & (f >= 0)
    nxt = 2 * node + 1 + (code_at > b).to(node.dtype)
    node.copy_(torch.where(go, nxt, node))
    frozen |= (~frozen) & (f < 0)


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
    lib.tree_best_split.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f, p]
    lib.tree_route.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.tree_walk.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.tree_leaf_values.argtypes = [p, p, p, p, i, i, i, i, f, i, p]
    lib.tree_segments.argtypes = [p, p, p, p, i, i, i, p]
    for fn in (lib.tree_level_hist, lib.tree_best_split, lib.tree_route,
               lib.tree_walk, lib.tree_leaf_values, lib.tree_segments):
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


def best_splits(hist, fmask, reg_lambda, min_child_weight):
    """T2 (see the module docstring).  fmask: (n_nodes, d) bool, shared by
    the lanes, or None."""
    if not _on_card(hist, "best_splits"):
        return best_splits_plain(hist, fmask, reg_lambda, min_child_weight)
    dev = hist.device
    L, N, d, B, S = hist.shape
    _check("hist", hist, (L, N, d, B, S), torch.float32, dev)
    if B % 16 or B > 256:
        raise ValueError(f"T2 takes n_bins a multiple of 16 up to 256, "
                         f"got {B}")
    if fmask is not None:
        _check("fmask", fmask, (N, d), torch.bool, dev)
    feat = torch.empty((L, N), dtype=torch.int32, device=dev)
    thr = torch.empty((L, N), dtype=torch.int32, device=dev)
    gain = torch.empty((L, N), dtype=torch.float32, device=dev)
    split = torch.empty((L, N), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().tree_best_split(
            hist.data_ptr(), None if fmask is None else fmask.data_ptr(),
            feat.data_ptr(), thr.data_ptr(), gain.data_ptr(),
            split.data_ptr(), L, N, d, B, S, float(reg_lambda),
            float(min_child_weight), _stream(dev))
    _raise_on(rc, "tree_best_split")
    LAUNCHES["tree_best_split"] += 1
    return feat, thr, gain, split


def route(codes, node, frozen, split_feat, split_bin, offset):
    """T3's routing, in place (see the module docstring)."""
    if not _on_card(node, "route"):
        return route_plain(codes, node, frozen, split_feat, split_bin,
                           offset)
    dev = node.device
    L, n = node.shape
    N = split_feat.shape[1]
    d = codes.shape[1]
    _check("codes", codes, (n, d), torch.uint8, dev)
    _check("node", node, (L, n), torch.int32, dev)
    _check("frozen", frozen, (L, n), torch.bool, dev)
    _check("split_feat", split_feat, (L, N), torch.int32, dev)
    _check("split_bin", split_bin, (L, N), torch.int32, dev)
    with torch.cuda.device(dev):
        rc = _lib().tree_route(
            codes.data_ptr(), node.data_ptr(), frozen.data_ptr(),
            split_feat.data_ptr(), split_bin.data_ptr(), L, n, d, N,
            int(offset), _stream(dev))
    _raise_on(rc, "tree_route")
    LAUNCHES["tree_route"] += 1


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
    with torch.cuda.device(dev):
        rc = _lib().tree_walk(
            codes.data_ptr(), feat.data_ptr(), thresh.data_ptr(),
            is_leaf.data_ptr(), value.data_ptr(),
            None if out is None else scale.data_ptr(), res.data_ptr(), L, n,
            d, M, n_out, depth, _stream(dev))
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
