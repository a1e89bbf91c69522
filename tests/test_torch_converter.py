"""The port's Converter (`convert/converter.py`) and converted tree
ensembles (`convert/tree_infer.py`, TI1's plain version) against the JAX
package's `Converter.toTPU` on the CPU, on the same fitted sklearn models
of every family it covers; the `toSKLearn` round trips, `toPandas`, the
errors, and `torch_model_from_jax`.

Inputs are made from a seed with numpy (240 rows, d = 8).  Tolerances:
labels and cluster ids equal; decisions, probabilities, predictions and
transforms atol 1e-4 (float32 on both sides, other summation orders);
PCA's components up to their sign (eigenvectors of the two eigh
routines); KNN's labels and probabilities equal (no distance ties in
these inputs)."""

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.cluster import KMeans
from sklearn.decomposition import PCA
from sklearn.ensemble import (
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from sklearn.linear_model import (
    ElasticNet,
    Lasso,
    LinearRegression,
    LogisticRegression,
    Ridge,
)
from sklearn.naive_bayes import (
    BernoulliNB,
    CategoricalNB,
    ComplementNB,
    GaussianNB,
    MultinomialNB,
)
from sklearn.neighbors import KNeighborsClassifier, KNeighborsRegressor
from sklearn.neural_network import MLPClassifier, MLPRegressor
from sklearn.svm import SVC, NuSVC

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.convert import tree_infer as jti
from spark_sklearn_tpu_torch.convert import tree_infer as pti
from spark_sklearn_tpu_torch.convert.params import torch_model_from_jax
from spark_sklearn_tpu_torch.ops import tree_infer_kernels as tik

CPU = port.TorchConfig(device="cpu")
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, n=240, d=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(d, 4))
    z = X @ W + 0.3 * rng.normal(size=(n, 4))
    y4 = np.argmax(z, axis=1)
    y2 = (z[:, 0] > 0).astype(int)
    yr = X @ W[:, 0] + 0.1 * rng.normal(size=n)
    counts = rng.poisson(3.0, size=(n, d)).astype(np.float32)
    cats = rng.integers(0, 4, size=(n, d))
    return {"X": X, "y4": y4, "y2": y2, "yr": yr, "counts": counts,
            "cats": cats}


D = _data()
TR, TE = slice(0, 180), slice(180, 240)

#: id -> (estimator, X key, y key, methods compared)
CASES = {
    "logreg_multi": (lambda: LogisticRegression(max_iter=200), "X", "y4",
                     ("predict", "decision_function", "predict_proba")),
    "logreg_binary": (lambda: LogisticRegression(max_iter=200), "X", "y2",
                      ("predict", "decision_function", "predict_proba")),
    "linreg": (LinearRegression, "X", "yr", ("predict",)),
    "ridge": (lambda: Ridge(alpha=2.0), "X", "yr", ("predict",)),
    "elasticnet": (lambda: ElasticNet(alpha=0.05), "X", "yr", ("predict",)),
    "lasso": (lambda: Lasso(alpha=0.05), "X", "yr", ("predict",)),
    "svc_multi_proba": (lambda: SVC(C=2.0, gamma=0.1, probability=True,
                                    random_state=0), "X", "y4",
                        ("predict", "decision_function", "predict_proba")),
    "svc_binary_proba": (lambda: SVC(probability=True, random_state=0), "X",
                         "y2", ("predict", "decision_function",
                                "predict_proba")),
    "svc_poly": (lambda: SVC(kernel="poly", degree=2, C=0.5), "X", "y4",
                 ("predict", "decision_function")),
    "nusvc": (lambda: NuSVC(nu=0.3, gamma=0.1), "X", "y4",
              ("predict", "decision_function")),
    "mlp_multi": (lambda: MLPClassifier(hidden_layer_sizes=(16,),
                                        max_iter=80, random_state=0), "X",
                  "y4", ("predict", "predict_proba")),
    "mlp_binary": (lambda: MLPClassifier(hidden_layer_sizes=(8,),
                                         max_iter=80, random_state=0), "X",
                   "y2", ("predict", "predict_proba")),
    "mlp_regressor": (lambda: MLPRegressor(hidden_layer_sizes=(16,),
                                           max_iter=80, random_state=0),
                      "X", "yr", ("predict",)),
    "kmeans": (lambda: KMeans(n_clusters=5, n_init=2, random_state=0), "X",
               None, ("predict",)),
    "knn_uniform": (lambda: KNeighborsClassifier(n_neighbors=5), "X", "y4",
                    ("predict", "predict_proba")),
    "knn_distance": (lambda: KNeighborsClassifier(n_neighbors=4,
                                                  weights="distance"),
                     "X", "y4", ("predict", "predict_proba")),
    "knn_regressor": (lambda: KNeighborsRegressor(n_neighbors=3), "X", "yr",
                      ("predict",)),
    "gaussian_nb": (GaussianNB, "X", "y4", ("predict", "predict_proba")),
    "multinomial_nb": (lambda: MultinomialNB(alpha=0.5), "counts", "y4",
                       ("predict", "predict_proba")),
    "complement_nb": (ComplementNB, "counts", "y4",
                      ("predict", "predict_proba")),
    "bernoulli_nb": (lambda: BernoulliNB(binarize=2.5), "counts", "y4",
                     ("predict", "predict_proba")),
    "categorical_nb": (CategoricalNB, "cats", "y4",
                       ("predict", "predict_proba")),
    "pca": (lambda: PCA(n_components=3), "X", None, ("transform",)),
    "pca_whiten": (lambda: PCA(n_components=4, whiten=True), "X", None,
                   ("transform",)),
    "rf_classifier": (lambda: RandomForestClassifier(
        n_estimators=12, max_depth=5, random_state=0), "X", "y4",
        ("predict", "predict_proba", "decision_function")),
    "rf_binary": (lambda: RandomForestClassifier(
        n_estimators=6, random_state=0), "X", "y2",
        ("predict", "predict_proba", "decision_function")),
    "rf_regressor": (lambda: RandomForestRegressor(
        n_estimators=10, max_depth=6, random_state=0), "X", "yr",
        ("predict",)),
    "gb_classifier": (lambda: GradientBoostingClassifier(
        n_estimators=8, max_depth=3, random_state=0), "X", "y4",
        ("predict", "predict_proba", "decision_function")),
    "gb_binary": (lambda: GradientBoostingClassifier(
        n_estimators=8, random_state=0), "X", "y2",
        ("predict", "predict_proba", "decision_function")),
    "gb_regressor": (lambda: GradientBoostingRegressor(
        n_estimators=10, max_depth=2, random_state=0), "X", "yr",
        ("predict",)),
}


def _fit(case):
    make, xk, yk, methods = CASES[case]
    est = make()
    X = D[xk]
    if yk is None:
        est.fit(X[TR])
    else:
        est.fit(X[TR], D[yk][TR])
    return est, X[TE], methods


def _compare(got, want, method, case):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (case, method)
    if method == "predict" and (want.dtype.kind in "iUO" or case.startswith(
            ("logreg", "svc", "nusvc", "mlp_m", "mlp_b", "knn_u", "knn_d",
             "gaussian", "multi", "compl", "bern", "categ", "rf_c", "rf_b",
             "gb_c", "gb_b", "kmeans"))):
        np.testing.assert_array_equal(got, want, err_msg=case)
    elif case.startswith("pca"):
        sign = np.sign((got * want).sum(axis=0, keepdims=True))
        np.testing.assert_allclose(got * sign, want, rtol=0, atol=ATOL,
                                   err_msg=case)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_to_torch_matches_jax_converter(case):
    est, Xte, methods = _fit(case)
    jm = sst.Converter().toTPU(est)
    tm = port.Converter(config=CPU).toTorch(est)
    assert isinstance(tm, port.convert.converter.TorchModel)
    for method in methods:
        _compare(getattr(tm, method)(Xte), getattr(jm, method)(Xte), method,
                 case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_model_from_jax(case):
    """A JAX TpuModel carried over predicts what the JAX one does."""
    est, Xte, methods = _fit(case)
    jm = sst.Converter().toTPU(est)
    tm = torch_model_from_jax(jm, device="cpu")
    for method in methods:
        _compare(getattr(tm, method)(Xte), getattr(jm, method)(Xte), method,
                 case)


ROUND_TRIPS = ["logreg_multi", "logreg_binary", "linreg", "ridge",
               "elasticnet", "svc_multi_proba", "svc_binary_proba", "nusvc",
               "mlp_multi", "mlp_binary", "mlp_regressor", "kmeans",
               "knn_uniform", "knn_regressor", "gaussian_nb",
               "multinomial_nb", "complement_nb", "bernoulli_nb",
               "categorical_nb", "pca"]


@pytest.mark.parametrize("case", ROUND_TRIPS)
def test_to_sklearn_round_trip_matches_jax(case):
    est, Xte, methods = _fit(case)
    back = port.Converter().toSKLearn(port.Converter(config=CPU).toTorch(est))
    ref = sst.Converter().toSKLearn(sst.Converter().toTPU(est))
    assert type(back) is type(ref) is type(est)
    assert back.get_params() == ref.get_params()
    for method in methods:
        _compare(getattr(back, method)(Xte), getattr(ref, method)(Xte),
                 method, case)


def test_aliases_and_legacy_context():
    c = port.Converter(object(), config=CPU)
    assert port.Converter.toTPU is port.Converter.toTorch
    assert port.Converter.toSpark is port.Converter.toTorch
    est = LinearRegression().fit(D["X"][TR], D["yr"][TR])
    np.testing.assert_allclose(c.toTPU(est).predict(D["X"][TE]),
                               est.predict(D["X"][TE]), atol=ATOL)


def test_default_device_is_cuda():
    est = LinearRegression().fit(D["X"][TR], D["yr"][TR])
    if torch.cuda.is_available():
        assert port.Converter().toTorch(est).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.Converter().toTorch(est)


def test_unsupported_and_refused_conversions():
    from sklearn.dummy import DummyClassifier
    from sklearn.ensemble import GradientBoostingClassifier as GBC

    conv = port.Converter(config=CPU)
    X, y = D["X"][TR], D["y4"][TR]
    with pytest.raises(ValueError, match="Cannot convert"):
        conv.toTorch(DummyClassifier().fit(X, y))
    with pytest.raises(ValueError, match="precomputed|kernel"):
        conv.toTorch(SVC(kernel="precomputed").fit(X @ X.T, y))
    with pytest.raises(ValueError, match="multi-output"):
        conv.toTorch(RandomForestRegressor(n_estimators=2).fit(
            X, np.stack([y, y], axis=1)))
    with pytest.raises(ValueError, match="multilabel"):
        conv.toTorch(MLPClassifier(hidden_layer_sizes=(4,), max_iter=5)
                     .fit(X, np.stack([y % 2, y // 2], axis=1)))
    with pytest.raises(ValueError, match="not compiled|metric"):
        conv.toTorch(KNeighborsClassifier(metric="manhattan").fit(X, y))
    with pytest.raises(ValueError, match="multi-output"):
        conv.toTorch(KNeighborsRegressor().fit(X, np.stack([y, y], 1)))
    with pytest.raises(ValueError, match="custom init"):
        conv.toTorch(GBC(n_estimators=2, init=LogisticRegression())
                     .fit(X, y % 2))
    tm = conv.toTorch(RandomForestClassifier(n_estimators=2).fit(X, y))
    with pytest.raises(ValueError, match="inference-only"):
        conv.toSKLearn(tm)
    svc = conv.toTorch(SVC().fit(X, y))
    del svc._sv_class_starts
    with pytest.raises(ValueError, match="class grouping"):
        conv.toSKLearn(svc)
    with pytest.raises(ValueError, match="must be fitted"):
        conv.toTorch(LinearRegression())


def test_to_pandas_cells_match_jax():
    import scipy.sparse as sp
    m = sp.random(3, 5, density=0.5, format="csr", random_state=0)
    df = pd.DataFrame({
        "a": [1, 2, 3],
        "v": [np.ones(2), np.zeros(2), np.arange(2.0)],
        "s": [port.CSRMatrix.from_scipy(m[i]) for i in range(3)],
        "t": [torch.arange(3.0)] * 3,
    })
    out = port.Converter().toPandas(df)
    ref = sst.Converter().toPandas(df.drop(columns="t").assign(
        s=[sst.CSRMatrix.from_scipy(m[i]) for i in range(3)]))
    for c in ("a", "v", "s"):
        for g, w in zip(out[c], ref[c]):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(out["t"][0], np.arange(3.0))
    as_dict = port.Converter().toPandas({c: list(df[c]) for c in df})
    np.testing.assert_array_equal(as_dict["s"][1], out["s"][1])


# ---------------------------------------------------------------------------
# TI1's plain version on hand-made trees
# ---------------------------------------------------------------------------

class _Tree:
    """sklearn's Tree arrays, written out by hand."""

    def __init__(self, feature, threshold, left, right, value):
        self.feature = np.asarray(feature)
        self.threshold = np.asarray(threshold, np.float64)
        self.children_left = np.asarray(left)
        self.children_right = np.asarray(right)
        self.value = np.asarray(value, np.float64)
        self.node_count = len(self.feature)
        depth = {0: 0}
        for v in range(self.node_count):
            for c in (self.children_left[v], self.children_right[v]):
                if c >= 0:
                    depth[c] = depth[v] + 1
        self.max_depth = max(depth.values())


def _hand_trees(n_out):
    rng = np.random.default_rng(3)
    leaf = _Tree([-2], [-2.0], [-1], [-1], rng.random((1, 1, n_out)))
    stump = _Tree([2, -2, -2], [0.1, -2, -2], [1, -1, -1], [2, -1, -1],
                  rng.random((3, 1, n_out)))
    # depth 3 on the left, a leaf on the right
    deep = _Tree([0, 1, 3, -2, -2, -2, -2],
                 [0.0, -0.5, 0.7, -2, -2, -2, -2],
                 [1, 2, 3, -1, -1, -1, -1], [6, 5, 4, -1, -1, -1, -1],
                 rng.random((7, 1, n_out)))
    return [leaf, deep, stump, deep, leaf, stump]


def _jax_reduce(packed, X, mode, K=1, init=None, lr=1.0):
    import jax.numpy as jnp
    v = np.asarray(jti.ensemble_leaf_values(packed, jnp.asarray(X)))
    if mode == "forest_proba":
        p = v / np.maximum(v.sum(axis=2, keepdims=True), 1e-12)
        return p.mean(axis=0)
    if mode == "mean":
        return v[:, :, 0].mean(axis=0)
    S = v.shape[0] // K
    return init[None, :] + lr * v[:, :, 0].reshape(S, K, -1).sum(axis=0).T


@pytest.mark.parametrize("mode,n_out,K", [("forest_proba", 2, 1),
                                          ("forest_proba", 5, 1),
                                          ("mean", 1, 1), ("boost", 1, 1),
                                          ("boost", 1, 3)])
def test_tree_ensemble_plain_matches_reference_on_hand_trees(mode, n_out,
                                                             K):
    """A single leaf, a stump and a tree deeper than the others, mixed:
    TI1's plain version against the reference's leaf values reduced."""
    trees = _hand_trees(n_out)
    packed = pti.pack_trees(trees)
    jpacked = jti.pack_trees(trees)
    for k in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(packed[k], jpacked[k])
    assert packed["max_depth"] == jpacked["max_depth"] == 3
    X = np.random.default_rng(4).normal(size=(50, 4)).astype(np.float32)
    init = np.linspace(-1, 1, K).astype(np.float32)
    t = pti.to_device(packed, "cpu")
    got = tik.tree_ensemble(
        torch.as_tensor(X), *(t[a] for a in pti.ARRAYS), t["max_depth"],
        mode, K=K, init=torch.as_tensor(init), lr=0.3)
    want = _jax_reduce(packed, X, mode, K, init, 0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_node_visits_count_the_walks():
    trees = _hand_trees(1)
    t = pti.to_device(pti.pack_trees(trees), "cpu")
    X = torch.as_tensor(np.random.default_rng(5).normal(size=(40, 4)),
                        dtype=torch.float32)
    internal, leaves, inner_nodes, leaf_nodes = tik.node_visits(
        X, *(t[a] for a in pti.ARRAYS[:4]), t["max_depth"])
    assert leaves == len(trees) * 40
    # 1 + 2 + 3 internal nodes of the stumps and deep trees at most, and
    # at least the roots; every tree reaches a leaf
    assert 4 <= inner_nodes <= 2 * 1 + 2 * 3
    assert len(trees) <= leaf_nodes <= 2 * 1 + 2 * 2 + 2 * 4
    # a single leaf costs no internal visit, a stump one, the deep tree
    # one to three
    assert 2 * 40 + 2 * 40 <= internal <= 2 * 40 + 2 * 3 * 40


def test_tree_ensemble_wrapper_refuses_bad_inputs_on_cpu_types():
    t = pti.to_device(pti.pack_trees(_hand_trees(2)), "cpu")
    X = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        tik.tree_ensemble(X.to("meta"), *(t[a] for a in pti.ARRAYS), 3,
                          "forest_proba")
