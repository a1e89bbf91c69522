"""The port's gapply and compiled_group_func (`keyed/gapply.py`) against
the JAX package's on the CPU: the reference's `TestGapply` cases
(`test_components.py:145-246`), the compiled ones with torch group
functions beside the JAX ones, on DataFrames made from a seed with
numpy; and `run_bucketed`'s buckets.  Tolerances: pandas' own frame
equality for the host path; compiled outputs atol 1e-5 (float32 sums in
other orders)."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu_torch.keyed import keyed as pk

CPU = port.TorchConfig(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(*args, **kw):
    ref = sst.gapply(*args, **kw)
    got = port.gapply(*args, config=CPU, **kw)
    pd.testing.assert_frame_equal(got, ref)
    return got


def test_basic_sum():
    df = pd.DataFrame({"g": [1, 1, 2, 2, 2], "v": [1., 2., 3., 4., 5.]})
    out = _both(df.groupby("g"),
                lambda k, p: pd.DataFrame({"s": [p.v.sum()]}),
                [("s", "float64")])
    assert out.to_dict("list") == {"g": [1, 2], "s": [3.0, 12.0]}


def test_oracle_vs_pandas_groupby():
    rng = np.random.default_rng(1)
    df = pd.DataFrame({"a": rng.integers(0, 5, 100),
                       "b": rng.integers(0, 3, 100),
                       "v": rng.normal(size=100)})
    out = _both(df.groupby(["a", "b"]),
                lambda k, p: pd.DataFrame({"m": [p.v.mean()]}),
                [("m", "float64")])
    oracle = df.groupby(["a", "b"])["v"].mean().reset_index(name="m")
    pd.testing.assert_frame_equal(out, oracle, check_dtype=False)


def test_no_retain_group_columns():
    df = pd.DataFrame({"g": [1, 1, 2], "v": [1., 2., 3.]})
    out = _both(df.groupby("g"),
                lambda k, p: pd.DataFrame({"s": [p.v.sum()]}),
                [("s", "float64")], retainGroupColumns=False)
    assert list(out.columns) == ["s"]


def test_func_emits_key_column():
    df = pd.DataFrame({"g": [1, 1, 2], "v": [1., 2., 3.]})
    out = _both(df.groupby("g"),
                lambda k, p: pd.DataFrame({"g": [k[0]], "s": [p.v.sum()]}),
                None)
    assert set(out.columns) == {"g", "s"}


def test_multirow_output_and_tuple_form():
    df = pd.DataFrame({"g": [1, 1, 2], "v": [1., 2., 3.]})
    out = _both((df, "g"), lambda k, p: pd.DataFrame({"v2": p.v * 2}),
                [("v2", "float64")])
    assert list(out["v2"]) == [2., 4., 6.]


def test_schema_dtype_cast_and_selected_columns():
    df = pd.DataFrame({"g": [1, 2, 2], "v": [1., 2., 5.], "u": [3, 4, 5]})
    out = _both(df.groupby("g"),
                lambda k, p: pd.DataFrame({"s": [int(p.v.sum())]}),
                {"s": "int32"})
    assert out["s"].dtype == np.int32
    out = _both(df.groupby("g"),
                lambda k, p: pd.DataFrame({"cols": [",".join(p.columns)]}),
                ["cols"], "u")
    assert list(out["cols"]) == ["u", "u"]


def test_errors_and_empty_input():
    df = pd.DataFrame({"g": [1, 2], "v": [1., 2.]})
    for pkg, kw in ((sst, {}), (port, {"config": CPU})):
        with pytest.raises(TypeError, match="DataFrame"):
            pkg.gapply(df.groupby("g"), lambda k, p: 1.0, None, **kw)
        with pytest.raises(ValueError, match="missing schema"):
            pkg.gapply(df.groupby("g"),
                       lambda k, p: pd.DataFrame({"a": [1]}), ["b"], **kw)
    empty = df.iloc[:0]
    _both(empty.groupby("g"), lambda k, p: p, [("s", "float64")])
    _both(empty.groupby("g"), lambda k, p: p, None)


def _skewed(seed=7):
    rng = np.random.default_rng(seed)
    g = np.concatenate([np.repeat(np.arange(20), 5), np.zeros(700, int),
                        np.full(33, 21)])
    return pd.DataFrame({"g": g, "a": rng.normal(size=len(g)),
                         "b": rng.normal(size=len(g))})


def test_compiled_group_func_matches_jax_and_pandas():
    """Skewed groups (5, 33 and 700 rows) over the bucketed launcher."""
    df = _skewed()

    @port.compiled_group_func
    def means(X, w):
        return (X * w[:, None]).sum(dim=0) / w.sum()

    @sst.compiled_group_func
    def jmeans(X, w):
        return jnp.sum(X * w[:, None], axis=0) / jnp.sum(w)

    schema = [("a", "float64"), ("b", "float64")]
    got = port.gapply(df.groupby("g"), means, schema, config=CPU)
    ref = sst.gapply(df.groupby("g"), jmeans, schema)
    want = df.groupby("g")[["a", "b"]].mean().reset_index()
    assert list(got.columns) == list(ref.columns) == ["g", "a", "b"]
    np.testing.assert_array_equal(got["g"], ref["g"])
    np.testing.assert_allclose(got[["a", "b"]].to_numpy(),
                               ref[["a", "b"]].to_numpy(), atol=1e-5)
    np.testing.assert_allclose(got[["a", "b"]].to_numpy(),
                               want[["a", "b"]].to_numpy(), atol=1e-5)
    # the vmapped segment function is made once and kept
    launch = means._sst_segment_vmap
    port.gapply(df.groupby("g"), means, schema, config=CPU)
    assert means._sst_segment_vmap is launch


def test_compiled_group_func_schema_and_errors():
    @port.compiled_group_func
    def stats(X, w):
        s = (X[:, 0] * w).sum()
        return torch.stack([s, s / w.sum()])

    df = pd.DataFrame({"g": [1, 1, 2], "v": [1.0, 2.0, 4.0]})
    out = port.gapply(df.groupby("g"), stats,
                      [("tot", "float64"), ("avg", "float64")], config=CPU)
    assert out.loc[out.g == 1, "tot"].iloc[0] == 3.0
    assert out.loc[out.g == 2, "avg"].iloc[0] == 4.0
    with pytest.raises(ValueError, match="declares 1 columns"):
        port.gapply(df.groupby("g"), stats, [("only_one", "float64")],
                    config=CPU)
    dfs = pd.DataFrame({"g": [1, 2], "v": ["x", "y"]})
    with pytest.raises(TypeError, match="numeric"):
        port.gapply(dfs.groupby("g"), stats, [("a", None), ("b", None)],
                    config=CPU)
    # no schema: positional names; called directly: one unpadded group
    out = port.gapply(df.groupby("g"), stats, config=CPU)
    assert list(out.columns) == ["g", "out0", "out1"]
    direct = stats((1,), df[df.g == 1][["v"]])
    np.testing.assert_allclose(direct.to_numpy(), [[3.0, 1.5]])


def test_compiled_scalar_and_multikey():
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"a": rng.integers(0, 3, 90),
                       "b": rng.choice(["x", "y"], 90),
                       "v": rng.normal(size=90)})

    @port.compiled_group_func
    def wsum(X, w):
        return (X[:, 0] * w).sum()

    @sst.compiled_group_func
    def jwsum(X, w):
        return jnp.sum(X[:, 0] * w)

    got = port.gapply(df.groupby(["a", "b"]), wsum, ["s"], "v", config=CPU)
    ref = sst.gapply(df.groupby(["a", "b"]), jwsum, ["s"], "v")
    pd.testing.assert_frame_equal(got[["a", "b"]], ref[["a", "b"]])
    np.testing.assert_allclose(got["s"], ref["s"], atol=1e-5)


def test_compiled_default_device_is_cuda():
    @port.compiled_group_func
    def f(X, w):
        return w.sum()

    df = pd.DataFrame({"g": [1, 2], "v": [1.0, 2.0]})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.gapply(df.groupby("g"), f, ["n"])


def test_run_bucketed_pads_and_orders():
    """Groups of 3, 9, 17 and 8 rows: buckets 8 (two), 16 and 32; each
    padded with zero rows of weight 0; results in launch order."""
    sizes = [3, 9, 17, 8]
    X = torch.arange(sum(sizes) * 2, dtype=torch.float32).view(-1, 2)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    rows = [np.arange(starts[i], starts[i + 1]) for i in range(4)]
    seen = []

    def fit_bucket(Xs, ws):
        seen.append((tuple(Xs.shape), ws.sum(dim=1).tolist()))
        assert (Xs[ws == 0] == 0).all()
        return {"sum": (Xs * ws[:, :, None]).sum(dim=1)}

    order, out, buckets = pk.run_bucketed(rows, X, fit_bucket)
    assert order == [0, 3, 1, 2]
    assert buckets == [(8, 2), (16, 1), (32, 1)]
    assert seen[0] == ((2, 8, 2), [3.0, 8.0])
    for j, i in enumerate(order):
        np.testing.assert_allclose(out["sum"][j], X[rows[i]].sum(dim=0))
    assert [pk.bucket_len(m) for m in (0, 8, 9, 4096, 4097)] == \
        [8, 8, 16, 4096, 8192]
