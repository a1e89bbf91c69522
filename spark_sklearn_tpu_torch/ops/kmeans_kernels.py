"""KMeans' assignment step (C1) as a hand-written CUDA kernel
(``csrc/kmeans.cu``) with its plain PyTorch version beside it.

- C1 `kmeans_assign(X (n, d), C (B, k, d), xx (n,), cc (B, k), w (B, n))
  -> (assign (B, n) int32, min_d2 (B, n), inertia (B,))`: every lane's
  distances from X and its k centers,

      dot[b, i, j] = Σ_t X[i, t] C[b, j, t]     (t = 0 .. d-1 in order)
      d2[b, i, j]  = max((xx[i] - 2 dot[b, i, j]) + cc[b, j], 0)

  each product and each sum rounded apart (`assign_distances`), then per
  lane and row the nearest center (the first on ties; the first NaN
  where there is one, as jnp.argmin) and its distance (NaN where any
  is), and per lane the weighted sum Σ_i w[b, i] min_d2[b, i].  xx and
  cc are the row and center norms Σ_t X², Σ_t C².  Replaces
  `spark_sklearn_tpu/models/cluster.py:31-35` (`_sq_dists`, its GEMM
  included) and its argmin and min at `:129-130`, `:145-146` and `:164`:
  a Lloyd iteration's assignment, the final inertia, `predict` and the
  default scorer's view.  d2 is never written.
- A block stages a tile of X's rows and a group of lanes' centers in
  shared memory a d-tile at a time, transposed (4 floats of t of 32
  neighbouring rows side by side), by cp.async copies of up to 16 bytes;
  a thread keeps the dot products of its 2 rows and 8 centers in
  registers across the d loop and walks k 8 centers at a time
  (`assign_plan`: lanes a block, the d-tile, the copies' width).  A block
  sums its rows' w·min_d2 a lane in a fixed order, and a second launch
  adds a lane's blocks in a fixed order: no float atomics, so two calls
  give the same bits.  It takes any n, d, k and B up to `MAX_LANE_GROUPS`
  lane groups.

- C1ℓ `kmeans_assign_lanes(X (B, n, d), C, xx (B, n), cc, w)`: the same
  with each lane's own rows (the keyed fleet's Lloyd step and predict,
  one lane a key), through the same kernel with X and xx advancing by a
  lane stride and one lane a block (`assign_plan(..., per_lane=True)`);
  its launches count in `LANE_LAUNCHES`.  Stride 0 is C1's shared X.

All float32 and contiguous, except `assign`.  A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches the kernel or
raises — it never falls back.  `LAUNCHES` counts calls that launch the
kernel (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"kmeans_assign": 0}
#: the lane-stride mode's launches (the keyed fleet's path)
LANE_LAUNCHES = {"kmeans_assign_lanes": 0}

#: C1's threads a block (8 warps), rows a thread and centers a pass of
#: the d loop, as `kThreads`, `kRowsPerThread` and `kCenters` in
#: csrc/kmeans.cu
ASSIGN_THREADS = 256
ROWS_PER_THREAD = 2
CENTERS_PER_PASS = 8
#: C1's dynamic shared memory a block, at most: the default 48 KB (no
#: attribute) less 1 KB for its static part, as `kMaxDynamicSmem`
ASSIGN_MAX_SMEM = 47 * 1024
#: most lane groups (the grid's y)
MAX_LANE_GROUPS = 65535


def reset_launches() -> None:
    for counts in (LAUNCHES, LANE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def assign_distances(X, C, xx, cc):
    """(B, n, k) squared distances of X's rows to every lane's centers,
    in C1's order: dot summed over t = 0 .. d-1, a product and a sum a
    step, then max((xx - 2 dot) + cc, 0)."""
    B, k, d = C.shape
    acc = torch.zeros((B, X.shape[0], k), dtype=X.dtype, device=X.device)
    for t in range(d):
        acc = acc + X[None, :, None, t] * C[:, None, :, t]
    return torch.clamp_min((xx[None, :, None] - 2.0 * acc)
                           + cc[:, None, :], 0.0)


def assign_distances_lanes(X, C, xx, cc):
    """(B, n, k) squared distances of each lane's own rows X (B, n, d) to
    its centers, in C1's order."""
    B, k, d = C.shape
    acc = torch.zeros((B, X.shape[1], k), dtype=X.dtype, device=X.device)
    for t in range(d):
        acc = acc + X[:, :, None, t] * C[:, None, :, t]
    return torch.clamp_min((xx[:, :, None] - 2.0 * acc) + cc[:, None, :],
                           0.0)


def kmeans_assign_lanes_plain(X, C, xx, cc, w):
    """C1ℓ's plain version."""
    d2 = assign_distances_lanes(X, C, xx, cc)
    assign = torch.argmin(d2, dim=2).to(torch.int32)
    min_d2 = d2.amin(dim=2)
    return assign, min_d2, (w * min_d2).sum(dim=1)


def kmeans_assign_plain(X, C, xx, cc, w):
    """C1's plain version: argmin and min over the centers (torch's argmin
    takes the first minimum and the first NaN, as jnp.argmin), and the
    weighted sums."""
    d2 = assign_distances(X, C, xx, cc)
    assign = torch.argmin(d2, dim=2).to(torch.int32)
    min_d2 = d2.amin(dim=2)
    return assign, min_d2, (w * min_d2).sum(dim=1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("kmeans")
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.kmeans_assign.argtypes = [p] * 9 + [i] * 9 + [ll, ll, p]
    lib.kmeans_assign.restype = i
    return lib


def assign_plan(n: int, d: int, B: int, align: int = 16,
                per_lane: bool = False) -> dict:
    """C1's launch: `lanes` lanes a block (1, 2, 4 or 8: the fewest idle
    lane slots, then the most lanes, so X is staged the fewest times),
    `rows` rows a block (2 a thread, the block's 8 warps shared by its
    lanes), the d-tile `dtile` staged as `dpad` / 4 quads, as wide as
    `ASSIGN_MAX_SMEM` allows, by copies of `vec` floats (4 where d % 4 ==
    0, 2 where d is even, and X and C start `align`-byte aligned; else
    1); grid (`blocks` row tiles, `groups`), then a block a lane adds its
    `blocks` partial sums.  `per_lane` (C1ℓ, each lane its own rows):
    one lane a block."""
    lanes = 1 if per_lane else min((1, 2, 4, 8),
                                   key=lambda L: (-(-B // L) * L, -L))
    rows = 32 * ROWS_PER_THREAD * (ASSIGN_THREADS // 32 // lanes)
    quads = ASSIGN_MAX_SMEM // (16 * (rows + lanes * CENTERS_PER_PASS))
    dtile = min(d, 4 * quads)
    dpad = 4 * -(-dtile // 4)
    vec = next(v for v in (4, 2, 1) if d % v == 0 and align % (4 * v) == 0)
    blocks = -(-n // rows)
    groups = -(-B // lanes)
    return {"lanes": lanes, "rows": rows, "dtile": dtile, "dpad": dpad,
            "vec": vec, "blocks": blocks, "groups": groups,
            "grid": (blocks, groups), "threads": ASSIGN_THREADS,
            "smem": 4 * (rows + lanes * CENTERS_PER_PASS) * dpad}


def kmeans_assign(X, C, xx, cc, w):
    """C1: each lane's nearest centers, their distances and the lanes'
    weighted sums, from X and the centers (see the module docstring)."""
    if X.device.type == "cpu":
        return kmeans_assign_plain(X, C, xx, cc, w)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if C.dim() != 3 or X.dim() != 2:
        raise ValueError(f"kmeans_assign: X must be (n, d) and C (B, k, "
                         f"d), got {tuple(X.shape)} and {tuple(C.shape)}")
    B, k, d = C.shape
    n = X.shape[0]
    dev = X.device
    _build.check_tensor("X", X, (n, d), dev)
    _build.check_tensor("xx", xx, (n,), dev)
    return _launch(X, C, xx, cc, w, n, per_lane=False)


def kmeans_assign_lanes(X, C, xx, cc, w):
    """C1ℓ: `kmeans_assign` where lane b has its own rows X[b] (B, n, d)
    and norms xx[b] (B, n) (see the module docstring)."""
    if X.device.type == "cpu":
        return kmeans_assign_lanes_plain(X, C, xx, cc, w)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if C.dim() != 3 or X.dim() != 3:
        raise ValueError(f"kmeans_assign_lanes: X must be (B, n, d) and C "
                         f"(B, k, d), got {tuple(X.shape)} and "
                         f"{tuple(C.shape)}")
    B, k, d = C.shape
    n = X.shape[1]
    dev = X.device
    _build.check_tensor("X", X, (B, n, d), dev)
    _build.check_tensor("xx", xx, (B, n), dev)
    return _launch(X, C, xx, cc, w, n, per_lane=True)


def _launch(X, C, xx, cc, w, n, per_lane):
    B, k, d = C.shape
    dev = X.device
    _build.check_tensor("C", C, (B, k, d), dev)
    _build.check_tensor("cc", cc, (B, k), dev)
    _build.check_tensor("w", w, (B, n), dev)
    if min(n, d, B, k) < 1:
        raise ValueError(f"kmeans_assign: empty shape n={n} d={d} B={B} "
                         f"k={k}")
    # the copies' width needs X and C aligned to it
    align = min(16, (X.data_ptr() | C.data_ptr()) & -(X.data_ptr()
                                                       | C.data_ptr()))
    plan = assign_plan(n, d, B, align, per_lane)
    if plan["groups"] > MAX_LANE_GROUPS:
        raise ValueError(f"kmeans_assign: B={B} lanes make {plan['groups']}"
                         f" lane groups, above the grid's "
                         f"{MAX_LANE_GROUPS}")
    assign = torch.empty((B, n), dtype=torch.int32, device=dev)
    min_d2 = torch.empty((B, n), dtype=X.dtype, device=dev)
    # the per-block partial sums, then the lanes' sums
    part = torch.empty(B * plan["blocks"] + B, dtype=X.dtype, device=dev)
    inertia = part[B * plan["blocks"]:]
    with torch.cuda.device(dev):
        rc = _lib().kmeans_assign(
            X.data_ptr(), C.data_ptr(), xx.data_ptr(), cc.data_ptr(),
            w.data_ptr(), assign.data_ptr(), min_d2.data_ptr(),
            part.data_ptr(), inertia.data_ptr(), n, d, B, k, plan["lanes"],
            plan["dtile"], plan["dpad"], plan["vec"], plan["blocks"],
            n * d if per_lane else 0, n if per_lane else 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kmeans_assign launch failed: cudaError {rc}")
    if per_lane:
        LANE_LAUNCHES["kmeans_assign_lanes"] += 1
    else:
        LAUNCHES["kmeans_assign"] += 1
    return assign, min_d2, inertia
