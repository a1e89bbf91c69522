"""The port's keyed fleets (`keyed/keyed.py`) against the JAX package's
KeyedEstimator on the CPU, on the same pandas DataFrames made from a
seed with numpy (a few keys, d <= 8, <= 200 rows a key): predictor
(LogisticRegression binary and multinomial, LinearRegression, Ridge),
clusterer (KMeans) and transformer (the five steps) fleets, hybrid and
host fleets, skewed buckets, unseen and null keys, duplicate index
labels, the empty table, `keyedModels`, the errors; the dict-of-columns
form against the DataFrame form; `lbfgs_lanes` against the reference's
`lbfgs` under `jax.vmap`; the lane-major kernels' plain versions
against the shared ones; `keyed_model_from_jax`.

Tolerances: labels and cluster ids equal; outputs and probabilities
atol 1e-4; coefficients rtol 1e-3 (of the largest) on keys that converge
in both; KMeans centers atol 1e-4 and n_iter equal; PCA's outputs up to
each component's sign (the two eigh routines' eigenvectors).  The
L-BFGS iteration counts differ between the two (float32 sums in other
orders take other line-search branches): they are recorded, not held
equal."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.cluster import KMeans
from sklearn.decomposition import PCA
from sklearn.linear_model import (
    ElasticNet,
    Lasso,
    LinearRegression,
    LogisticRegression,
    Ridge,
)
from sklearn.preprocessing import (
    MaxAbsScaler,
    MinMaxScaler,
    Normalizer,
    StandardScaler,
)

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.ops.solvers import lbfgs as jax_lbfgs
from spark_sklearn_tpu_torch.convert.params import keyed_model_from_jax
from spark_sklearn_tpu_torch.keyed import keyed as pk
from spark_sklearn_tpu_torch.ops import glm_kernels as gk
from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk
from spark_sklearn_tpu_torch.ops.solvers import lbfgs_lanes

CPU = port.TorchConfig(device="cpu")
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(seed=0, sizes=(30, 50, 12, 100, 70, 200), d=4):
    """A DataFrame of keys k0.. with vector rows x, a per-key linear
    signal, binary string labels yb, 3-class int labels ym and a target
    yr."""
    rng = np.random.default_rng(seed)
    kid = np.concatenate([np.full(m, i) for i, m in enumerate(sizes)])
    X = rng.normal(size=(len(kid), d)) * np.linspace(1, 3, d)
    W = rng.normal(size=(len(sizes), d))
    z = np.einsum("nd,nd->n", X, W[kid])
    noise = rng.normal(size=len(z))
    df = pd.DataFrame({"k": [f"k{i}" for i in kid], "x": list(X)})
    df["yb"] = np.where(z + 0.5 * noise > 0, "pos", "neg")
    df["ym"] = np.digitize(z + 0.5 * noise, [-1.0, 1.0])
    df["yr"] = z + 0.01 * noise
    df["yn"] = np.digitize(z + 3.0 * noise, [-1.0, 1.0])
    return df


DF = _table()


def _fit_both(est, df=DF, **kw):
    ref = sst.KeyedEstimator(sklearnEstimator=est, keyCols=["k"], xCol="x",
                             **kw).fit(df)
    got = port.KeyedEstimator(sklearnEstimator=est, keyCols=["k"],
                              xCol="x", config=CPU, **kw).fit(df)
    return ref, got


def _out(model, df):
    return model.transform(df)["output"]


def _assert_outputs(got, want, keys=None):
    """Outputs equal (labels, ids) or within ATOL; with `keys`, each
    key's output columns up to their sign (PCA)."""
    if want.dtype == object and len(want) and \
            isinstance(want.iloc[0], np.ndarray):
        g, w = np.stack(got.to_numpy()), np.stack(want.to_numpy())
        if keys is not None:
            keys = np.asarray(keys)
            for k in np.unique(keys):
                m = keys == k
                g[m] *= np.sign((g[m] * w[m]).sum(axis=0, keepdims=True))
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
        return
    if not pd.api.types.is_numeric_dtype(want) or want.dtype.kind == "i":
        if pd.api.types.is_numeric_dtype(want):
            assert got.dtype == want.dtype
        assert list(got) == list(want)
        return
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0,
                               atol=ATOL)


def _by_key(model, name):
    f = model.fleet
    keys = sorted(f["key_index"])
    return keys, np.stack([np.asarray(f["models"][name])[f["key_index"][k]]
                           for k in keys])


# ---------------------------------------------------------------------------
# predictor fleets
# ---------------------------------------------------------------------------

PREDICTORS = {
    "logreg_binary": (lambda: LogisticRegression(max_iter=100), "yb"),
    "logreg_multinomial": (lambda: LogisticRegression(max_iter=100), "ym"),
    "logreg_balanced": (lambda: LogisticRegression(
        C=0.5, class_weight="balanced", max_iter=100), "yb"),
    "logreg_dict_weights_no_intercept": (lambda: LogisticRegression(
        class_weight={0: 1.0, 1: 2.0, 2: 0.5}, fit_intercept=False,
        max_iter=100), "ym"),
    "logreg_no_penalty": (lambda: LogisticRegression(
        penalty=None, max_iter=50), "yn"),
    "linreg": (LinearRegression, "yr"),
    "linreg_no_intercept": (lambda: LinearRegression(fit_intercept=False),
                            "yr"),
    "ridge": (lambda: Ridge(alpha=3.0), "yr"),
}


@pytest.mark.parametrize("case", sorted(PREDICTORS))
def test_predictor_fleet_matches_jax(case, record_property):
    make, ycol = PREDICTORS[case]
    ref, got = _fit_both(make(), yCol=ycol)
    assert (ref.backend, got.backend) in (("tpu", "device"),
                                          ("hybrid", "hybrid"))
    assert set(got.fleet["key_index"]) == set(ref.fleet["key_index"])
    _assert_outputs(_out(got, DF), _out(ref, DF))
    keys, rc = _by_key(ref, "coef")
    _, gc = _by_key(got, "coef")
    rc = rc.reshape(gc.shape)
    if "n_iter" in got.fleet["models"]:
        _, rn = _by_key(ref, "n_iter")
        _, gn = _by_key(got, "n_iter")
        assert rn.shape == gn.shape and (gn >= 1).all()
        conv = _by_key(ref, "converged")[1] & _by_key(got, "converged")[1]
        assert conv.any()
        rc, gc = rc[conv], gc[conv]
        record_property("n_iter", {"jax": rn.tolist(), "port": gn.tolist()})
    np.testing.assert_allclose(gc, rc, rtol=0,
                               atol=1e-3 * np.abs(rc).max())


def test_fleet_runs_by_bucket_not_by_key():
    """Six keys of 12 to 200 rows make five buckets (16 ... 256): one
    fit call a bucket."""
    _, got = _fit_both(LinearRegression(), yCol="yr")
    assert got.fleet["buckets"] == [(16, 1), (32, 1), (64, 1), (128, 2),
                                    (256, 1)]


def test_skewed_group_sizes_stay_in_the_fleet():
    """One big key among many small ones (test_components.py:463)."""
    rng = np.random.default_rng(5)
    ks = np.concatenate([np.repeat([f"s{i}" for i in range(40)], 10),
                         np.repeat(["big"], 600)])
    df = pd.DataFrame({"k": ks, "x": [rng.normal(size=3)
                                      for _ in range(len(ks))]})
    df["y"] = [v.sum() + 0.01 * rng.normal() for v in df.x]
    ref, got = _fit_both(LinearRegression(), df, yCol="y")
    assert ref.backend == "tpu" and got.backend == "device"
    assert len(got.fleet["key_index"]) == 41
    assert got.fleet["buckets"] == [(16, 40), (1024, 1)]
    _assert_outputs(_out(got, df), _out(ref, df))


# ---------------------------------------------------------------------------
# clusterer and transformer fleets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init,n_init", [("k-means++", 1), ("k-means++", 2),
                                         ("random", 3)])
def test_kmeans_fleet_matches_jax(init, n_init):
    est = KMeans(n_clusters=3, init=init, n_init=n_init, random_state=4)
    ref, got = _fit_both(est, estimatorType="clusterer")
    assert (ref.backend, got.backend) == ("tpu", "device")
    a, b = _out(ref, DF), _out(got, DF)
    assert a.dtype == b.dtype == np.int64
    np.testing.assert_array_equal(b.to_numpy(), a.to_numpy())
    for name in ("centers", "inertia"):
        _, r = _by_key(ref, name)
        _, g = _by_key(got, name)
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=ATOL)
    np.testing.assert_array_equal(_by_key(got, "n_iter")[1],
                                  _by_key(ref, "n_iter")[1])


TRANSFORMERS = {
    "standard": StandardScaler, "standard_no_mean": lambda: StandardScaler(
        with_mean=False),
    "minmax_clip": lambda: MinMaxScaler(feature_range=(-1, 2), clip=True),
    "maxabs": MaxAbsScaler, "normalizer_l1": lambda: Normalizer(norm="l1"),
    "normalizer_max": lambda: Normalizer(norm="max"),
    "pca": lambda: PCA(n_components=3),
    "pca_whiten": lambda: PCA(n_components=2, whiten=True),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMERS))
def test_transformer_fleet_matches_jax(case):
    ref, got = _fit_both(TRANSFORMERS[case](), estimatorType="transformer")
    assert (ref.backend, got.backend) == ("tpu", "device")
    far = pd.DataFrame({"k": ["k0", "k5"], "x": [np.full(4, 50.0),
                                                 np.full(4, -50.0)]})
    for df in (DF, far):
        _assert_outputs(_out(got, df), _out(ref, df),
                        df["k"] if case.startswith("pca") else None)


# ---------------------------------------------------------------------------
# hybrid and host fleets
# ---------------------------------------------------------------------------

def test_missing_class_key_is_host_fitted():
    """test_components.py:440: key "b" lacks the class "mid"."""
    rng = np.random.default_rng(4)
    df = pd.DataFrame({"k": np.repeat(["a", "b"], 40),
                       "x": [rng.normal(size=3) for _ in range(80)]})
    y = np.where([v[0] > 0 for v in df.x], "pos", "neg")
    y[:5] = "mid"
    df["y"] = y
    ref, got = _fit_both(LogisticRegression(max_iter=100), df, yCol="y")
    assert ref.backend == got.backend == "hybrid"
    assert list(got.fleet["key_index"]) == [("a",)]
    assert list(got.models) == [("b",)]
    _assert_outputs(_out(got, df), _out(ref, df))
    assert set(_out(got, df)[40:]) <= {"pos", "neg"}


def test_small_keys_are_host_fitted():
    """A key below the family's rows (PCA: n_components, KMeans:
    n_clusters) goes to a host fit, which raises as sklearn does, in
    both packages; with just enough rows it stays in the fleet."""
    tiny = pd.DataFrame({"k": ["tiny"] * 2, "x": [np.zeros(4), np.ones(4)]})
    df = pd.concat([DF[["k", "x"]], tiny], ignore_index=True)
    for est, kind in ((PCA(n_components=3), "transformer"),
                      (KMeans(n_clusters=3, n_init=1), "clusterer")):
        for pkg, kw in ((sst, {}), (port, {"config": CPU})):
            with pytest.raises(ValueError):
                pkg.KeyedEstimator(sklearnEstimator=est, keyCols=["k"],
                                   xCol="x", estimatorType=kind,
                                   **kw).fit(df)
    ok = pd.concat([df, tiny.iloc[:1]], ignore_index=True)
    ref, got = _fit_both(PCA(n_components=3), ok,
                         estimatorType="transformer")
    assert (ref.backend, got.backend) == ("tpu", "device")
    _assert_outputs(_out(got, ok), _out(ref, ok), ok["k"])


@pytest.mark.parametrize("make", [
    lambda: __import__("sklearn.tree", fromlist=["x"])
    .DecisionTreeRegressor(max_depth=3),
    lambda: __import__("sklearn.svm", fromlist=["x"]).SVR(C=2.0),
    lambda: __import__("sklearn.ensemble", fromlist=["x"])
    .RandomForestRegressor(n_estimators=4, max_depth=3, random_state=0),
    lambda: __import__("sklearn.neighbors", fromlist=["x"])
    .KNeighborsRegressor(n_neighbors=3),
], ids=["tree", "svr", "forest", "knn"])
def test_host_families_fit_key_by_key(make):
    ref, got = _fit_both(make(), yCol="yr")
    assert ref.backend == got.backend == "host"
    _assert_outputs(_out(got, DF), _out(ref, DF))


def test_port_estimator_host_fits_on_the_config_device():
    """A port estimator with no device of its own is host-fitted on the
    fleet's device (here the CPU), and its keys predict there."""
    rng = np.random.default_rng(4)
    df = pd.DataFrame({"k": np.repeat(["a", "b"], 40),
                       "x": [rng.normal(size=3) for _ in range(80)]})
    y = np.where([v[0] > 0 for v in df.x], 1, 0)
    y[:5] = 2
    df["y"] = y
    got = port.KeyedEstimator(
        sklearnEstimator=port.LogisticRegression(max_iter=100),
        keyCols=["k"], xCol="x", yCol="y", config=CPU).fit(df)
    assert got.backend == "hybrid"
    assert got.models[("b",)].device == "cpu"
    ref = sst.KeyedEstimator(sklearnEstimator=LogisticRegression(
        max_iter=100), keyCols=["k"], xCol="x", yCol="y").fit(df)
    _assert_outputs(_out(got, df), _out(ref, df))


@pytest.mark.parametrize("make", [
    lambda: ElasticNet(alpha=0.1), lambda: Lasso(alpha=0.1),
    lambda: LogisticRegression(penalty="l1", solver="saga"),
    lambda: __import__("sklearn.neural_network", fromlist=["x"])
    .MLPRegressor(hidden_layer_sizes=(4,)),
    lambda: __import__("sklearn.naive_bayes", fromlist=["x"]).GaussianNB(),
    lambda: __import__("sklearn.discriminant_analysis", fromlist=["x"])
    .LinearDiscriminantAnalysis(solver="lsqr"),
    lambda: __import__("sklearn.svm", fromlist=["x"]).LinearSVR(),
    lambda: port.Pipeline([("s", port.StandardScaler()),
                           ("r", port.Ridge())]),
], ids=["elasticnet", "lasso", "logreg_l1", "mlp", "gaussian_nb", "lda",
        "linear_svr", "pipeline"])
def test_unported_fleet_family_raises(make):
    ycol = "ym" if "NB" in type(make()).__name__ or "Discr" in type(
        make()).__name__ or "Logistic" in type(make()).__name__ else "yr"
    ke = port.KeyedEstimator(sklearnEstimator=make(), keyCols=["k"],
                             xCol="x", yCol=ycol, config=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ke.fit(DF)


def test_fleet_failure_raises_instead_of_host_fits():
    """The reference re-runs a failed fleet as host fits with a warning;
    the port raises."""
    ke = port.KeyedEstimator(sklearnEstimator=Ridge(positive=True),
                             keyCols=["k"], xCol="x", yCol="yr",
                             config=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="positive"):
            ke.fit(DF)


# ---------------------------------------------------------------------------
# transform's contract
# ---------------------------------------------------------------------------

def test_unseen_and_null_keys_give_nan_or_none():
    _, reg = _fit_both(LinearRegression(), yCol="yr")
    _, tr = _fit_both(StandardScaler(), estimatorType="transformer")
    df = pd.DataFrame({"k": ["zz", None, "k1", np.nan],
                       "x": [np.zeros(4)] * 4})
    out = _out(reg, df)
    assert np.isnan(out[0]) and np.isnan(out[1]) and np.isnan(out[3])
    assert np.isfinite(out[2])
    out = _out(tr, df)
    assert out[0] is None and out[1] is None and out[3] is None
    assert out[2].shape == (4,)


def test_duplicate_index_labels_and_order():
    ref, got = _fit_both(LinearRegression(), yCol="yr")
    dup = pd.concat([DF.iloc[[5, 200, 5]], DF.iloc[[5, 99]]])
    a, b = ref.transform(dup), got.transform(dup)
    assert list(b.index) == list(dup.index)
    _assert_outputs(b["output"], a["output"])


def test_empty_table_fits_an_empty_model():
    empty = pd.DataFrame({"k": [], "x": [], "y": []})
    for est, kw in [(LinearRegression(), {"yCol": "y"}),
                    (StandardScaler(), {"estimatorType": "transformer"})]:
        km = port.KeyedEstimator(sklearnEstimator=est, keyCols=["k"],
                                 xCol="x", config=CPU, **kw).fit(empty)
        assert km.backend == "host" and len(km.keyedModels) == 0
        out = km.transform(pd.DataFrame({"k": ["a"], "x": [np.zeros(3)]}))
        assert len(out) == 1
        assert len(km.transform(empty)) == 0


def test_keyed_models_views_match_jax():
    for est, kw in [(LogisticRegression(max_iter=100), {"yCol": "ym"}),
                    (Ridge(), {"yCol": "yr"}),
                    (KMeans(n_clusters=2, n_init=1, random_state=0),
                     {"estimatorType": "clusterer"}),
                    (StandardScaler(), {"estimatorType": "transformer"})]:
        ref, got = _fit_both(est, **kw)
        rv, gv = ref.keyedModels, got.keyedModels
        assert list(gv.columns) == list(rv.columns) == ["k", "estimator"]
        assert list(gv["k"]) == list(rv["k"])
        X = np.random.default_rng(1).normal(size=(7, 4))
        for r, g in zip(rv["estimator"], gv["estimator"]):
            if "estimatorType" in kw and kw["estimatorType"] == \
                    "transformer":
                np.testing.assert_allclose(g.transform(X), r.transform(X),
                                           atol=ATOL)
            else:
                pr, pg = np.asarray(r.predict(X)), g.predict(X)
                if pr.dtype.kind == "f":
                    np.testing.assert_allclose(pg, pr, atol=ATOL)
                else:
                    np.testing.assert_array_equal(pg, pr)


def test_validation_and_missing_column_errors():
    with pytest.raises(ValueError):
        port.KeyedEstimator()
    with pytest.raises(ValueError):
        port.KeyedEstimator(sklearnEstimator=LinearRegression(),
                            estimatorType="oracle")
    with pytest.raises(ValueError):
        port.KeyedEstimator(sklearnEstimator=PCA(), yCol="y")
    from sklearn.cluster import DBSCAN
    with pytest.raises(ValueError, match="requires an estimator"):
        port.KeyedEstimator(sklearnEstimator=DBSCAN(), keyCols=["k"],
                            xCol="x", estimatorType="clusterer")
    ke = port.KeyedEstimator(sklearnEstimator=LinearRegression(),
                             keyCols=["nope"], xCol="x", yCol="y",
                             config=CPU)
    with pytest.raises(KeyError, match="missing columns"):
        ke.fit(DF)
    km = port.KeyedEstimator(sklearnEstimator=LinearRegression(),
                             keyCols=["k"], xCol="x", yCol="yr",
                             config=CPU).fit(DF)
    with pytest.raises(KeyError, match="missing columns"):
        km.transform(DF[["k"]])
    with pytest.raises(ValueError, match="different lengths"):
        ke.fit({"nope": [1, 2], "x": [1.0]})
    with pytest.raises(TypeError, match="dict of equal-length"):
        ke.fit([[1, 2]])


def test_default_device_is_cuda():
    ke = port.KeyedEstimator(sklearnEstimator=LinearRegression(),
                             keyCols=["k"], xCol="x", yCol="yr")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ke.fit(DF)


# ---------------------------------------------------------------------------
# the dict-of-columns form
# ---------------------------------------------------------------------------

def _as_dict(df):
    out = {c: list(df[c]) for c in df.columns}
    out["x"] = np.stack(df["x"].to_numpy())
    return out


@pytest.mark.parametrize("est,kw", [
    (LogisticRegression(max_iter=100), {"yCol": "yb"}),
    (Ridge(), {"yCol": "yr"}),
    (KMeans(n_clusters=3, n_init=1, random_state=0),
     {"estimatorType": "clusterer"}),
    (StandardScaler(), {"estimatorType": "transformer"}),
], ids=["logreg", "ridge", "kmeans", "scaler"])
def test_dict_form_gives_the_dataframe_form_outputs(est, kw):
    df = pd.concat([DF, pd.DataFrame({"k": ["zz"], "x": [np.ones(4)],
                                      "yb": ["pos"], "ym": [0],
                                      "yr": [0.0]})], ignore_index=True)
    ke = port.KeyedEstimator(sklearnEstimator=est, keyCols=["k"], xCol="x",
                             config=CPU, **kw)
    by_df, by_dict = ke.fit(DF), ke.fit(_as_dict(DF))
    a, b = by_df.transform(df), by_dict.transform(_as_dict(df))
    assert isinstance(b, dict) and set(b) == set(df.columns) | {"output"}
    want = a["output"].to_numpy()
    got = b["output"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        elif isinstance(w, float) and np.isnan(w) or w is None:
            assert g is None or np.isnan(g)
        else:
            assert g == w
    if want.dtype.kind in "if":
        assert got.dtype == want.dtype
    views = by_dict.keyedModels
    assert list(views) == ["k", "estimator"]
    assert list(views["k"]) == list(by_df.keyedModels["k"])


def test_group_rows_follows_pandas_groupby():
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"a": rng.integers(0, 4, 60).astype(float),
                       "b": rng.choice(["x", "yy", "a"], 60),
                       "c": rng.integers(-2, 2, 60)})
    df.loc[[3, 17], "a"] = np.nan
    for keys in (["a"], ["b"], ["b", "c"], ["c", "a", "b"]):
        got_keys, rows, null = pk.group_rows([df[c].to_numpy()
                                              for c in keys])
        want = [(k if isinstance(k, tuple) else (k,), g.index.to_numpy())
                for k, g in df.groupby(keys, sort=True)]
        assert [tuple(k) for k in got_keys] == [k for k, _ in want]
        for r, (_, w) in zip(rows, want):
            np.testing.assert_array_equal(r, w)
        assert null.sum() == (2 if "a" in keys else 0)


# ---------------------------------------------------------------------------
# the solver and the kernels' plain versions
# ---------------------------------------------------------------------------

def _lbfgs_problem(G, L, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(G, L, d)).astype(np.float32)
    y = (rng.random((G, L)) < 0.5).astype(np.int32)
    w = np.ones((G, L), np.float32)
    w[:, L - 3:] = 0.0                      # a bucket's padding rows
    X[:, L - 3:] = 0.0
    return X, y, w


@pytest.mark.parametrize("G", [1, 5])
def test_lbfgs_lanes_matches_reference_lbfgs(G, record_property):
    """One lane and many: the binary logistic sum-loss + 0.5/C ||w||^2
    per lane, the port's `lbfgs_lanes` through K2ℓ/K4ℓ's plain versions
    against `jax.vmap` of the reference's scalar `lbfgs`.  Near the
    float32 floor of the objective either may stall above tol and run to
    max_iter (no stall detector, as the reference): x is held on the
    lanes that converge in both, f on all."""
    L, d, C = 40, 5, 0.7
    X, y, w = _lbfgs_problem(G, L, d, seed=G)
    l2 = 0.5 / C

    def one(Xg, yg, wg):
        def fun(x):
            z = Xg @ x[:d] + x[d]
            per = jnp.logaddexp(0.0, z) - yg * z
            return jnp.sum(wg * per) + l2 * jnp.dot(x[:d], x[:d])
        return jax_lbfgs(fun, jnp.zeros(d + 1, jnp.float32), max_iter=100,
                         tol=1e-4)

    ref = jax.vmap(one)(jnp.asarray(X), jnp.asarray(y, jnp.float32),
                        jnp.asarray(w))
    Xt, yt, wt = map(torch.as_tensor, (X, y, w))

    def Ax(x):
        return torch.baddbmm(x[:, None, d:], Xt, x[:, :d, None])[:, :, 0]

    def AT(dZ):
        return torch.cat([torch.bmm(dZ[:, None, :], Xt)[:, 0],
                          dZ.sum(dim=1, keepdim=True)], dim=1)

    def trial(Z, Zp, al, idx=None):
        ww, yy = (wt, yt) if idx is None else (wt[idx], yt[idx])
        return gk.glm_trial_loss_lanes(Z, Zp, ww, yy, al)

    pen = torch.ones(d + 1)
    pen[d] = 0.0
    res = lbfgs_lanes(Ax, lambda Z: gk.glm_loss_grad_lanes(Z, wt, yt),
                      trial, AT, torch.zeros((G, d + 1)),
                      torch.full((G,), l2), pen, max_iter=100, tol=1e-4)
    conv = res.converged.numpy() & np.asarray(ref.converged)
    assert conv.sum() >= G - 1
    rx = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy()[conv], rx[conv], rtol=0,
                               atol=1e-3 * np.abs(rx).max())
    np.testing.assert_allclose(res.fun.numpy(), np.asarray(ref.fun),
                               rtol=1e-5)
    assert (res.grad_norm.numpy() < 1e-3).all()
    record_property("n_iter", {"jax": np.asarray(ref.n_iter).tolist(),
                               "port": res.n_iter.tolist()})


def test_lbfgs_lanes_freezes_stopped_lanes():
    """A lane that starts at its optimum (g = 0) takes no step while the
    others iterate; max_iter caps every lane."""
    G, L, d = 3, 24, 3
    X, y, w = _lbfgs_problem(G, L, d, seed=9)
    w[1] = 0.0                                # lane 1: nothing to fit
    Xt, yt, wt = map(torch.as_tensor, (X, y, w))

    def Ax(x):
        return torch.bmm(Xt, x[:, :, None])[:, :, 0]

    def AT(dZ):
        return torch.bmm(dZ[:, None, :], Xt)[:, 0]

    res = lbfgs_lanes(
        Ax, lambda Z: gk.glm_loss_grad_lanes(Z, wt, yt),
        lambda Z, Zp, al, idx=None: gk.glm_trial_loss_lanes(
            Z, Zp, wt if idx is None else wt[idx],
            yt if idx is None else yt[idx], al),
        AT, torch.zeros((G, d)), torch.zeros(G), torch.ones(d),
        max_iter=4, tol=1e-12)
    assert res.n_iter.tolist() == [4, 0, 4]
    assert (res.x[1] == 0).all()


@pytest.mark.parametrize("k", [2, 3, 7])
def test_lane_major_loss_plain_matches_shared_layout(k):
    """K2ℓ/K4ℓ's plain versions with shared labels are K2/K4's on the
    transposed logits; per-lane labels are each lane's own."""
    rng = np.random.default_rng(k)
    G, L = 4, 9
    shape = (G, L) if k == 2 else (G, L, k)
    Z = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    Zp = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    w = torch.as_tensor(rng.random((G, L)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, k, L).astype(np.int32))
    al = torch.as_tensor(rng.random((3, G)).astype(np.float32))
    loss, G_ = gk.glm_loss_grad_lanes(Z, w, y)
    ZT = Z.transpose(0, 1).contiguous()
    loss0, G0 = gk.glm_loss_grad_plain(ZT, w.T.contiguous(), y)
    np.testing.assert_allclose(loss.numpy(), loss0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(G_.transpose(0, 1).numpy(), G0.numpy(),
                               atol=1e-7)
    t = gk.glm_trial_loss_lanes(Z, Zp, w, y, al)
    t0 = gk.glm_trial_loss_plain(ZT, Zp.transpose(0, 1).contiguous(),
                                 w.T.contiguous(), y, al)
    np.testing.assert_allclose(t.numpy(), t0.numpy(), rtol=1e-6)
    yl = torch.as_tensor(rng.integers(0, k, (G, L)).astype(np.int32))
    loss_l, _ = gk.glm_loss_grad_lanes(Z, w, yl)
    for g in range(G):
        one, _ = gk.glm_loss_grad_plain(Z[g][:, None].contiguous(),
                                        w[g][:, None].contiguous(), yl[g])
        np.testing.assert_allclose(loss_l[g].numpy(), one[0].numpy(),
                                   rtol=1e-6)


def test_lane_x_assign_plain_matches_shared_x():
    """C1ℓ's plain version with every lane's rows equal is C1's, bit for
    bit; with distinct rows, each lane's own C1."""
    rng = np.random.default_rng(0)
    B, n, d, k = 3, 11, 5, 4
    X = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
    C = torch.as_tensor(rng.normal(size=(B, k, d)).astype(np.float32))
    w = torch.as_tensor(rng.random((B, n)).astype(np.float32))
    cc = (C * C).sum(dim=2)
    xx = (X * X).sum(dim=1)
    shared = kmk.kmeans_assign(X, C, xx, cc, w)
    lanes = kmk.kmeans_assign_lanes(X.expand(B, n, d).contiguous(), C,
                                    xx.expand(B, n).contiguous(), cc, w)
    for a, b in zip(shared, lanes):
        assert torch.equal(a, b)
    Xl = torch.as_tensor(rng.normal(size=(B, n, d)).astype(np.float32))
    xxl = (Xl * Xl).sum(dim=2)
    got = kmk.kmeans_assign_lanes(Xl, C, xxl, cc, w)
    for b in range(B):
        one = kmk.kmeans_assign(Xl[b], C[b:b + 1], xxl[b], cc[b:b + 1],
                                w[b:b + 1])
        for a, c in zip(got, one):
            assert torch.equal(a[b:b + 1], c)


# ---------------------------------------------------------------------------
# carried over from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("est,kw", [
    (LogisticRegression(max_iter=100), {"yCol": "ym"}),
    (LinearRegression(), {"yCol": "yr"}),
    (KMeans(n_clusters=2, n_init=1, random_state=0),
     {"estimatorType": "clusterer"}),
    (Normalizer(), {"estimatorType": "transformer"}),
    (MinMaxScaler(), {"estimatorType": "transformer"}),
], ids=["logreg", "linreg", "kmeans", "normalizer", "minmax"])
def test_keyed_model_from_jax_reproduces_its_transform(est, kw):
    ref = sst.KeyedEstimator(sklearnEstimator=est, keyCols=["k"], xCol="x",
                             **kw).fit(DF)
    got = keyed_model_from_jax(ref, device="cpu")
    assert got.backend == "device"
    _assert_outputs(_out(got, DF), _out(ref, DF))
