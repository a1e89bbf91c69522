"""Inference over converted tree ensembles (TI1) as a hand-written CUDA
kernel (``csrc/tree_infer.cu``) with its plain PyTorch version beside it.

- TI1 `tree_ensemble(X, feature, threshold, left, right, value,
  max_depth, mode, K=1, init=None, lr=1.0)`: every sample walked
  through every tree to its leaf (`left < 0`, or `max_depth` steps), the
  leaves reduced over the trees in tree order:

  - ``"forest_proba"``: the mean of each tree's normalised leaf
    distribution, value / max(Σ_j value, 1e-12), (n, n_out);
  - ``"mean"``: the mean of the leaves' first value, (n,);
  - ``"boost"``: init[c] + lr Σ_{t % K = c} value[t, leaf, 0], (n, K).

  Replaces `spark_sklearn_tpu/convert/tree_infer.py:50-76`
  (`ensemble_leaf_values`, which writes the (T, n, n_out) leaf values)
  and the shims' reductions over it (:93-160).  The kernel walks a
  sample a thread and keeps the reduction in registers.

`tree_ensemble_plain` takes the reference's level steps (a gather and a
compare a tree and level, leaves staying put), and sums in the kernel's
order: trees in order, the normalising sum over j in order, the multiply
and the add apart.  X float32 (n, d), the node arrays (T, N) int32 and
float32, value (T, N, n_out) float32, all on one device and contiguous.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back.  `LAUNCHES` counts
kernel launches (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"tree_ensemble": 0}

#: reduction name -> the kernel's mode
MODES = {"forest_proba": 0, "mean": 1, "boost": 2}
#: most outputs a sample (the kernel's largest register array)
MAX_WIDTH = 64


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def leaves(X, feature, threshold, left, right, max_depth):
    """(T, n) leaf index of every (tree, sample): the reference's
    `max_depth` level steps, each a gather and a compare."""
    T = feature.shape[0]
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)
    out = torch.empty((T, n), dtype=torch.long, device=X.device)
    for t in range(T):
        f_t, th_t, l_t, r_t = (feature[t].long(), threshold[t],
                               left[t].long(), right[t].long())
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        for _ in range(int(max_depth)):
            lft = l_t[node]
            go_left = X[rows, f_t[node]] <= th_t[node]
            nxt = torch.where(go_left, lft, r_t[node])
            node = torch.where(lft < 0, node, nxt)
        out[t] = node
    return out


def tree_ensemble_plain(X, feature, threshold, left, right, value,
                        max_depth, mode, K=1, init=None, lr=1.0):
    """TI1's plain version (see the module docstring)."""
    T, _, n_out = value.shape
    leaf = leaves(X, feature, threshold, left, right, max_depth)
    n = X.shape[0]
    width = n_out if mode == "forest_proba" else (1 if mode == "mean"
                                                  else K)
    acc = torch.zeros((n, width), dtype=value.dtype, device=X.device)
    for t in range(T):
        v = value[t][leaf[t]]                                # (n, n_out)
        if mode == "forest_proba":
            s = torch.zeros(n, dtype=v.dtype, device=v.device)
            for j in range(n_out):
                s = s + v[:, j]
            acc = acc + v / torch.clamp_min(s, 1e-12)[:, None]
        elif mode == "mean":
            acc[:, 0] = acc[:, 0] + v[:, 0]
        else:
            c = t % K
            acc[:, c] = acc[:, c] + v[:, 0]
    if mode == "forest_proba":
        return acc / float(T)
    if mode == "mean":
        return acc[:, 0] / float(T)
    lr32 = torch.tensor(lr, dtype=acc.dtype, device=acc.device)
    return init[None, :] + lr32 * acc


def node_visits(X, feature, threshold, left, right, max_depth):
    """The work TI1 does on this data: (internal node visits, leaf
    visits, distinct internal nodes touched, distinct leaves touched)
    over the samples of X and the trees (its bound counts them)."""
    T, N = feature.shape
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)
    internal = 0
    touched = torch.zeros((T, N), dtype=torch.bool, device=X.device)
    for t in range(T):
        f_t, th_t, l_t, r_t = (feature[t].long(), threshold[t],
                               left[t].long(), right[t].long())
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        for _ in range(int(max_depth)):
            touched[t, node] = True
            lft = l_t[node]
            inner = lft >= 0
            internal += int(inner.sum())
            go_left = X[rows, f_t[node]] <= th_t[node]
            node = torch.where(inner, torch.where(go_left, lft, r_t[node]),
                               node)
        touched[t, node] = True
    is_leaf = left < 0
    return (internal, T * n, int((touched & ~is_leaf).sum()),
            int((touched & is_leaf).sum()))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("tree_infer")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tree_ensemble.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, p]
    lib.tree_ensemble.restype = i
    return lib


def tree_ensemble(X, feature, threshold, left, right, value, max_depth,
                  mode, K=1, init=None, lr=1.0):
    """TI1 (see the module docstring)."""
    if X.device.type == "cpu":
        return tree_ensemble_plain(X, feature, threshold, left, right,
                                   value, max_depth, mode, K, init, lr)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")
    if X.dim() != 2 or feature.dim() != 2 or value.dim() != 3:
        raise ValueError("X must be (n, d), the node arrays (T, N) and "
                         "value (T, N, n_out)")
    n, d = X.shape
    T, N, n_out = value.shape
    dev = X.device
    _build.check_tensor("X", X, (n, d), dev)
    _build.check_tensor("feature", feature, (T, N), dev, torch.int32)
    _build.check_tensor("threshold", threshold, (T, N), dev)
    _build.check_tensor("left", left, (T, N), dev, torch.int32)
    _build.check_tensor("right", right, (T, N), dev, torch.int32)
    _build.check_tensor("value", value, (T, N, n_out), dev)
    if min(n, d, T, N, n_out) < 1:
        raise ValueError(f"tree_ensemble: empty shape n={n} d={d} T={T} "
                         f"N={N} n_out={n_out}")
    if mode == "boost":
        if K < 1 or T % K:
            raise ValueError(f"boost: {T} trees are not stages of K={K}")
        if init is None:
            raise ValueError("boost needs init (K,)")
        _build.check_tensor("init", init, (K,), dev)
    width = n_out if mode == "forest_proba" else (1 if mode == "mean"
                                                  else K)
    if width > MAX_WIDTH:
        raise ValueError(f"tree_ensemble: {width} outputs a sample, above "
                         f"{MAX_WIDTH}")
    out = torch.empty((n,) if mode == "mean" else (n, width),
                      dtype=torch.float32, device=dev)
    init_t = init if mode == "boost" else out
    with torch.cuda.device(dev):
        rc = _lib().tree_ensemble(
            X.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            left.data_ptr(), right.data_ptr(), value.data_ptr(),
            init_t.data_ptr(), out.data_ptr(), n, d, T, N, n_out, int(K),
            int(max_depth), MODES[mode], float(lr),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tree_ensemble launch failed: cudaError {rc}")
    LAUNCHES["tree_ensemble"] += 1
    return out
