"""The port's KMeans against the JAX package's on the CPU, and the two
draws it needs (`gumbel`, `choice`) against `jax.random`: the uniform
bits equal, each of Gumbel's two logs within 2 ulp of XLA's, the seeded
choices and center indices equal; the lane-batched fit (centers,
inertia, n_iter per lane) against `jax.vmap` of the JAX `fit`, for
`init` "k-means++" and "random"; the search with its default scorer and
a supervised one against the JAX search; `kmeans_from_jax`; C1's plain
version on ties and NaN, and its distances against a numpy float32 loop
in the order the kernel keeps (bit for bit); and the search's surface
without labels.

Tolerances: n_iter equal; centers atol 1e-4 and inertia rtol 1e-5
(float32 sums in another order); Gumbel values atol 1e-5; mean_test
scores rtol 1e-5."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans as SkKMeans
from sklearn.model_selection import KFold as SkKFold

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.models import cluster as jcl
from spark_sklearn_tpu_torch.convert.params import kmeans_from_jax
from spark_sklearn_tpu_torch.models import cluster as pcl
from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk
from spark_sklearn_tpu_torch.ops import random as prng
from spark_sklearn_tpu_torch.parallel.taskgrid import build_fold_masks

CPU = port.TorchConfig(device="cpu")
N_FOLDS = 3
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_gumbel_matches_jax(seed):
    key, pkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    u = np.asarray(jax.random.uniform(key, (4000,), minval=TINY,
                                      maxval=1.0))
    pu = prng.uniform(pkey, (4000,), minval=TINY, maxval=1.0).numpy()
    np.testing.assert_array_equal(pu.view(np.uint32), u.view(np.uint32))
    inner = np.array(-jnp.log(jnp.asarray(u)))
    assert _ulps((-torch.log(torch.as_tensor(pu))).numpy(), inner).max() <= 2
    outer = np.array(-jnp.log(jnp.asarray(inner)))
    assert _ulps((-torch.log(torch.as_tensor(inner))).numpy(),
                 outer).max() <= 2
    np.testing.assert_allclose(prng.gumbel(pkey, (4000,)).numpy(),
                               np.asarray(jax.random.gumbel(key, (4000,))),
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_choice_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w = rng.random((4, 250)).astype(np.float32)
    w[:, ::5] = 0.0                                   # some never drawn
    p = w / (w.sum(axis=1, keepdims=True) + 1e-12)
    key = jax.random.PRNGKey(seed)
    ref = np.stack([np.asarray(jax.random.choice(
        key, 250, (9,), replace=False, p=jnp.asarray(row))) for row in p])
    got = prng.choice(prng.PRNGKey(seed), 250, 9, torch.as_tensor(p))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.all(w[np.arange(4)[:, None], got.numpy()] > 0)
    with pytest.raises(ValueError, match="larger sample"):
        prng.choice(prng.PRNGKey(0), 5, 6, torch.ones(5) / 5)


def _blobs(seed=0, n=300, d=4, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 4
    return (centers[rng.integers(0, k, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("init,n_init", [("k-means++", 1),
                                         ("k-means++", 2), ("random", 3)])
def test_fit_matches_jax(init, n_init):
    X = _blobs()
    train, _ = build_fold_masks(list(SkKFold(N_FOLDS).split(X)), len(X))
    tols = [1e-6, 1e-3, 1e-1]
    w = np.tile(train, (len(tols), 1))
    tol = np.repeat(np.asarray(tols, np.float32), N_FOLDS)
    static = {"n_clusters": 4, "init": init, "n_init": n_init,
              "random_state": 3}
    data, meta = jcl.KMeansFamily.prepare_data(X, None)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    ref = jax.vmap(lambda t, wt: jcl.KMeansFamily.fit(
        {"tol": t}, static, jd, wt, meta))(jnp.asarray(tol), jnp.asarray(w))
    got = pcl.KMeansFamily.fit_task_batched(
        {"tol": torch.as_tensor(tol)}, {**static, "__n_folds__": N_FOLDS},
        {k: torch.as_tensor(v) for k, v in data.items()},
        torch.as_tensor(w), meta)
    np.testing.assert_array_equal(got["n_iter"].numpy(),
                                  np.asarray(ref["n_iter"]))
    assert len(set(got["n_iter"].tolist())) > 1       # lanes stop apart
    np.testing.assert_allclose(got["centers"].numpy(),
                               np.asarray(ref["centers"]), atol=1e-4)
    np.testing.assert_allclose(got["inertia"].numpy(),
                               np.asarray(ref["inertia"]), rtol=1e-5)


@pytest.mark.parametrize("init", ["k-means++", "random"])
def test_seeded_centers_are_the_reference_rows(init):
    """The first run's initial centers are the very rows the reference
    draws (each center a row of X, found by its exact value)."""
    X = _blobs(seed=2, n=200)
    w = np.ones((1, len(X)), np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    if init == "random":
        idx = np.asarray(jax.random.choice(
            key, len(X), (6,), replace=False,
            p=jnp.asarray(w[0] / (w[0].sum() + 1e-12))))
    else:
        k0, k1 = jax.random.split(key)
        idx = [int(jnp.argmax(jnp.log(jnp.asarray(w[0]) + 1e-12)
                              + jax.random.gumbel(k0, (len(X),))))]
        min_d2 = np.sum((X - X[idx[0]]) ** 2, axis=1)
        kk = k1
        for _ in range(5):
            kk, sub = jax.random.split(kk)
            logits = np.where(min_d2 > 0, np.log(min_d2 + 1e-30), -np.inf)
            idx.append(int(jnp.argmax(jnp.asarray(logits, jnp.float32)
                                      + jax.random.gumbel(sub,
                                                          (len(X),)))))
            min_d2 = np.minimum(min_d2, np.sum((X - X[idx[-1]]) ** 2, 1))
    C0 = pcl.KMeansFamily._seed(prng.fold_in(prng.PRNGKey(5), 0), init,
                                torch.as_tensor(X), torch.as_tensor(w), 6)
    np.testing.assert_array_equal(C0[0].numpy(), X[np.asarray(idx)])


def _search_both(scoring, y=None):
    X = _blobs(seed=1)
    grid = {"tol": [1e-5, 1e-3, 1e-1]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sst.GridSearchCV(SkKMeans(n_clusters=4, random_state=0), grid,
                               cv=N_FOLDS, scoring=scoring, refit=False,
                               backend="tpu").fit(X, y)
    got = port.GridSearchCV(port.KMeans(n_clusters=4, random_state=0),
                            grid, cv=N_FOLDS, scoring=scoring, refit=False,
                            config=CPU).fit(X, y)
    return ref.cv_results_, got


def test_search_default_scorer_matches_jax():
    ref, got = _search_both(None)
    np.testing.assert_allclose(got.cv_results_["mean_test_score"],
                               ref["mean_test_score"], rtol=1e-5)
    assert np.all(got.cv_results_["mean_test_score"] < 0)
    assert [c["n_iter_exec"] for c in got.chunks_]


def test_search_with_numeric_y_and_a_supervised_scorer():
    X = _blobs(seed=1)
    y = X[:, 0].astype(np.float32)
    ref, got = _search_both("neg_mean_absolute_error", y)
    np.testing.assert_allclose(
        got.cv_results_["mean_test_score"], ref["mean_test_score"],
        rtol=1e-5)


def test_labels_the_search_cannot_use():
    X = _blobs(seed=1)
    labels = np.array(["a", "b"] * 150, dtype=object)
    gs = port.GridSearchCV(port.KMeans(n_clusters=3, random_state=0),
                           {"tol": [1e-4]}, cv=3, config=CPU).fit(X, labels)
    assert np.isfinite(gs.best_score_)
    with pytest.raises(ValueError, match="needs labels"):
        port.GridSearchCV(port.KMeans(n_clusters=3), {"tol": [1e-4]}, cv=3,
                          scoring="r2", config=CPU).fit(X, labels)
    with pytest.raises(ValueError, match="needs labels"):
        port.GridSearchCV(port.KMeans(n_clusters=3), {"tol": [1e-4]}, cv=3,
                          scoring="r2", config=CPU).fit(X)


def test_refit_holder_and_kmeans_from_jax():
    X = _blobs(seed=4)
    gs = port.GridSearchCV(port.KMeans(n_clusters=4, random_state=0),
                           {"tol": [1e-4, 1e-2]}, cv=3, config=CPU).fit(X)
    best = gs.best_estimator_
    assert best.cluster_centers_.shape == (4, 4)
    np.testing.assert_array_equal(gs.predict(X), best.labels_)
    np.testing.assert_allclose(-best.score(X), best.inertia_, rtol=1e-5)
    sk = SkKMeans(n_clusters=4, init=best.cluster_centers_, n_init=1,
                  max_iter=1).fit(X)
    np.testing.assert_array_equal(best.predict(X), sk.predict(X))
    data, meta = jcl.KMeansFamily.prepare_data(X, None)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    model = jcl.KMeansFamily.fit({}, {"n_clusters": 4, "random_state": 0},
                                 jd, jnp.ones(len(X), jnp.float32), meta)
    carried = kmeans_from_jax({k: np.asarray(v) for k, v in model.items()},
                              device="cpu")
    assert carried["n_iter"].dtype == torch.int32
    np.testing.assert_array_equal(
        pcl.KMeansFamily.predict(carried, {}, torch.as_tensor(X),
                                 meta).numpy(),
        np.asarray(jcl.KMeansFamily.predict(model, {}, jd["X"], meta)))


def test_assign_plain_ties_and_nan():
    """C1's plain version: the first center on a tie, the first NaN where
    one is (jnp.argmin's rule), NaN in min_d2 and the lane's sum; a NaN
    in X makes every center NaN, so its row takes center 0."""
    X = torch.tensor([[1.0, 1.0], [0.0, 2.0], [float("nan"), 1.0]])
    C = torch.tensor([[[1.0, 1.0], [float("nan"), 0.0]],     # NaN at j=1
                      [[0.0, 1.0], [0.0, 1.0]]])              # a tie
    xx, cc = (X * X).sum(dim=1), (C * C).sum(dim=2)
    w = torch.ones((2, 3))
    assign, min_d2, inertia = kmk.kmeans_assign(X, C, xx, cc, w)
    np.testing.assert_array_equal(assign.numpy(), [[1, 1, 0], [0, 0, 0]])
    assert torch.isnan(min_d2[0]).all() and torch.isnan(inertia).all()
    np.testing.assert_array_equal(min_d2[1, :2].numpy(), [1.0, 1.0])
    assert torch.isnan(min_d2[1, 2])
    for b in range(2):
        ref = jnp.argmin(jnp.asarray(kmk.assign_distances(X, C, xx, cc)[b]),
                         -1)
        np.testing.assert_array_equal(assign[b].numpy(), np.asarray(ref))
    finite = kmk.kmeans_assign(X[:2], C[1:], xx[:2], cc[1:], w[1:, :2])
    np.testing.assert_array_equal(finite[2].numpy(), [2.0])


@pytest.mark.parametrize("n,d,B,k", [(37, 1, 2, 3), (64, 5, 3, 8),
                                     (50, 54, 2, 9)])
def test_assign_distances_follow_the_stated_order(n, d, B, k):
    """C1's distances, bit for bit, are a float32 loop over t = 0 .. d-1
    of acc + X[:, t] C[:, :, t], a product and a sum a step, then
    max((xx - 2 acc) + cc, 0): the order the kernel keeps on the card."""
    rng = np.random.default_rng(n + d)
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = rng.standard_normal((B, k, d)).astype(np.float32)
    xx = (X * X).sum(axis=1, dtype=np.float32)
    cc = (C * C).sum(axis=2, dtype=np.float32)
    acc = np.zeros((B, n, k), np.float32)
    for t in range(d):
        prod = X[None, :, None, t] * C[:, None, :, t]
        acc = acc + prod
    want = np.maximum((xx[None, :, None] - np.float32(2.0) * acc)
                      + cc[:, None, :], np.float32(0.0))
    got = kmk.assign_distances(*(torch.as_tensor(a) for a in (X, C, xx,
                                                              cc))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    a, m, _ = kmk.kmeans_assign_plain(
        *(torch.as_tensor(v) for v in (X, C, xx, cc)),
        torch.ones((B, n)))
    np.testing.assert_array_equal(a.numpy(), want.argmin(axis=2))
    np.testing.assert_array_equal(m.numpy().view(np.uint32),
                                  want.min(axis=2).view(np.uint32))
