"""The port's evaluation suite against the JAX package's (which fits and
scores with scikit-learn, run here as its own tests run it), on the same
numpy inputs from a seed, on the CPU.  Tolerances:

* the link-prediction dataset: bit for bit;
* ``logistic_fit`` against scikit-learn run to convergence (``tol=1e-10``,
  ``max_iter=10_000``): within 1e-5 of the largest coefficient;
* the metrics against scikit-learn's: within 1e-12, ties included;
* ``link_prediction_scores`` against the JAX package's on ≥ 20k rows: AUC
  within 2e-3, accuracy and F1 within 5e-3 (scikit-learn stops lbfgs at
  ``max_iter=200``, short of the optimum Newton reaches);
* node classification F1 within 1e-2 (the same, and ties at the top-k);
* reconstruction accuracy: equal; modularity within 1e-12;
* clustering on planted communities: the same best k and modularity,
  silhouette and Davies–Bouldin within 1e-6 relative;
* PCA within 1e-4, up to the sign of each component.
"""

import os

import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression
from sklearn.metrics import (accuracy_score, davies_bouldin_score, f1_score,
                             roc_auc_score, silhouette_score)

from force2vec_tpu.eval import clustering as jclust
from force2vec_tpu.eval import linkpred as jlink
from force2vec_tpu.eval import nodeclass as jnode
from force2vec_tpu.eval import reconstruction as jrecon
from force2vec_tpu.eval import visualize as jvis
from force2vec_tpu.graphs import io as jio
from force2vec_tpu.graphs.csr import Graph as JaxGraph
from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.eval import _fit
from force2vec_tpu_torch.eval import clustering as tclust
from force2vec_tpu_torch.eval import linkpred as tlink
from force2vec_tpu_torch.eval import nodeclass as tnode
from force2vec_tpu_torch.eval import reconstruction as trecon
from force2vec_tpu_torch.eval import visualize as tvis
from force2vec_tpu_torch.graphs import (load_graph, read_embeddings,
                                        synth_powerlaw_graph,
                                        write_embeddings)
from force2vec_tpu_torch.graphs.csr import Graph
from force2vec_tpu_torch.graphs.tools import write_mtx

KARATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "karate.mtx")
CPU = "cpu"


def _jax(g):
    return JaxGraph(g.n, g.rowptr, g.colids, g.values)


def planted_graph(sizes, p_in, p_out, seed):
    """Symmetric stochastic block model: (Graph, community of each
    vertex)."""
    rng = np.random.default_rng(seed)
    comm = np.repeat(np.arange(len(sizes)), sizes)
    n = len(comm)
    p = np.where(comm[:, None] == comm[None, :], p_in, p_out)
    a = np.triu(rng.random((n, n)) < p, k=1)
    rows, cols = np.nonzero(a | a.T)
    return Graph.from_coo(rows, cols, None, n=n), comm


def community_embedding(comm, dim, spread, seed):
    """Community centers at unit scale, each vertex ``spread`` noise away."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(comm.max() + 1, dim))
    return (centers[comm] + spread * rng.normal(size=(len(comm), dim))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def lp_graph():
    """~10k edges: a link-prediction dataset of ~30k rows."""
    g, comm = planted_graph([300] * 4, 0.05, 0.002, seed=1)
    return g, community_embedding(comm, 16, 1.0, seed=2)


# -- the dataset ----------------------------------------------------------------


@pytest.mark.parametrize("dist", ["hadamard", "l1", "l2", "average"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_link_prediction_data_bit_for_bit(dist, seed):
    g = synth_powerlaw_graph(n=500, avg_deg=8, seed=seed + 3)
    emb = np.random.default_rng(seed).normal(size=(g.n, 12)).astype(np.float32)
    Xj, yj = jlink.make_link_prediction_data(_jax(g), emb, dist=dist, seed=seed)
    Xt, yt = tlink.make_link_prediction_data(g, emb, dist=dist, seed=seed)
    assert Xt.dtype == Xj.dtype and yt.dtype == yj.dtype
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)
    # the same features built by torch from the same rows
    Xd, yd = tlink.link_prediction_dataset(g, torch.from_numpy(emb), dist=dist,
                                           seed=seed, device=CPU)
    np.testing.assert_array_equal(Xd.numpy(), Xj)
    np.testing.assert_array_equal(yd.numpy(), yj)


def test_link_prediction_dataset_shape_karate():
    g = load_graph(KARATE)
    emb = np.random.default_rng(0).normal(size=(g.n, 8)).astype(np.float32)
    X, y = tlink.make_link_prediction_data(g, emb)
    n_pos = int(y.sum())
    assert n_pos == g.nnz // 2  # one positive per upper-triangle edge
    assert (len(y) - n_pos) >= n_pos  # ~2 negatives per positive (capped)
    assert X.shape == (len(y), 8)
    u, v, _ = tlink.link_prediction_pairs(g)
    neg = y == 0
    assert not tlink._is_edge(g, u[neg], v[neg]).any()
    assert (u[neg] != v[neg]).all()


# -- the fit and the metrics -----------------------------------------------------


def _sk_fit(X, y, C=1.0):
    m = LogisticRegression(C=C, tol=1e-10, max_iter=10_000).fit(X, y)
    return np.concatenate([m.coef_[0], m.intercept_])


@pytest.mark.parametrize("n,d,C,bias", [(400, 6, 1.0, 0.0),
                                        (5000, 24, 1.0, 1.5),
                                        (3000, 10, 0.05, -0.7)])
def test_logistic_fit_matches_sklearn(n, d, C, bias):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, d)) * rng.uniform(0.2, 3.0, d)
    w = rng.normal(size=d)
    y = (X @ w + bias + rng.logistic(size=n) > 0).astype(np.int64)
    coef, b = _fit.logistic_fit(torch.from_numpy(X), torch.from_numpy(y), C=C)
    got = np.concatenate([coef[0].numpy(), b.numpy()])
    want = _sk_fit(X, y, C)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_logistic_fit_batched_one_vs_rest():
    """K problems in one solve equal K separate fits; a column of all 0
    (all 1) gets probability exactly 0 (1)."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(800, 8)).astype(np.float32)
    Y = (X @ rng.normal(size=(8, 4)) + rng.normal(size=(800, 4)) > 0.5)
    Y = np.concatenate([Y, np.zeros((800, 1)), np.ones((800, 1))], 1)
    coef, b = _fit.logistic_fit(torch.from_numpy(X), torch.from_numpy(Y))
    for k in range(4):
        want = _sk_fit(X.astype(np.float64), Y[:, k])
        got = np.concatenate([coef[k].numpy(), b[k:k + 1].numpy()])
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    prob = torch.sigmoid(torch.from_numpy(X).double() @ coef.T + b)
    assert (prob[:, 4] == 0).all() and (prob[:, 5] == 1).all()
    assert (coef[4:] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 3000)
    pred = np.where(rng.random(3000) < 0.7, y, 1 - y)
    # scores on a coarse grid: many ties, within and across the classes
    score = np.round(y * 0.3 + rng.random(3000), 1)
    t = torch.from_numpy
    assert abs(_fit.accuracy(t(y), t(pred)) - accuracy_score(y, pred)) <= 1e-12
    macro, micro = _fit.f1_scores(t(y), t(pred))
    assert abs(macro - f1_score(y, pred, average="macro")) <= 1e-12
    assert abs(micro - f1_score(y, pred, average="micro")) <= 1e-12
    assert abs(_fit.roc_auc(t(y), t(score)) - roc_auc_score(y, score)) <= 1e-12
    # one predicted class only: the labels are those of y ∪ pred
    ones = np.ones_like(y)
    macro, _ = _fit.f1_scores(t(y), t(ones))
    assert abs(macro - f1_score(y, ones, average="macro")) <= 1e-12
    # multilabel, with a column neither true nor predicted anywhere
    Y = (rng.random((500, 6)) < 0.3).astype(np.int64)
    P = (rng.random((500, 6)) < 0.3).astype(np.int64)
    Y[:, 2] = P[:, 2] = 0
    macro, micro = _fit.multilabel_f1_scores(t(Y), t(P))
    for got, avg in ((macro, "macro"), (micro, "micro")):
        assert abs(got - f1_score(Y, P, average=avg, zero_division=0)) <= 1e-12


# -- the scores against the JAX package -----------------------------------------


def test_link_prediction_scores_match_jax(lp_graph):
    g, emb = lp_graph
    X, _ = tlink.make_link_prediction_data(g, emb)
    assert len(X) >= 20_000
    want = jlink.link_prediction_scores(_jax(g), emb)
    got = tlink.link_prediction_scores(g, emb, device=CPU)
    assert set(got) == set(want) == {"accuracy", "f1_macro", "f1_micro", "auc"}
    assert got["auc"] > 0.6  # the embedding carries the communities
    assert abs(got["auc"] - want["auc"]) <= 2e-3
    for k in ("accuracy", "f1_macro", "f1_micro"):
        assert abs(got[k] - want[k]) <= 5e-3, (k, got, want)


def _multilabel_data(n, dim, classes, seed):
    """An embedding and 1–3 labels per node correlated with it, and a
    labels file's worth of lists (class ids not contiguous)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    score = emb @ rng.normal(size=(dim, len(classes))) + rng.normal(
        size=(n, len(classes)))
    labels = []
    for i in range(n):
        order = np.argsort(-score[i])
        k = 1 + int(score[i, order[1]] > 1.0) + int(score[i, order[2]] > 2.0)
        labels.append([int(classes[j]) for j in order[:k]])
    return emb, labels


def test_node_classification_matches_jax():
    emb, labels = _multilabel_data(2400, 16, [1, 2, 3, 5, 8, 13], seed=3)
    labels[7] = []  # an unlabeled node is left out
    want = jnode.node_classification_scores(emb, labels, seed=0)
    got = tnode.node_classification_scores(emb, labels, seed=0, device=CPU)
    assert set(got) == set(want)
    for tf in want:
        for k in ("f1_macro", "f1_micro"):
            assert abs(got[tf][k] - want[tf][k]) <= 1e-2, (tf, k, got, want)
    assert got[0.25]["f1_micro"] > 0.5


def test_node_classification_class_absent_from_training():
    """A class with no positive among the training rows scores as
    scikit-learn's constant predictor (probability 0)."""
    emb, labels = _multilabel_data(400, 8, [0, 1, 2], seed=4)
    for i in (11, 200, 333):
        labels[i] = labels[i] + [9]
    order = np.random.default_rng(0).permutation(400)
    assert not {11, 200, 333} & set(order[:20].tolist())
    want = jnode.node_classification_scores(emb, labels, (0.05,), seed=0)
    got = tnode.node_classification_scores(emb, labels, (0.05,), seed=0,
                                           device=CPU)
    for k in ("f1_macro", "f1_micro"):
        assert abs(got[0.05][k] - want[0.05][k]) <= 1e-2, (k, got, want)


def test_node_labels_reader(tmp_path):
    p = tmp_path / "labels.txt"
    p.write_text("1 0\n2 1\n2 3\n3 1\n9 4\nbad\n")
    assert tnode.read_node_labels(str(p), 4) == [[0], [1, 3], [1], []]
    assert tnode.read_node_labels(str(p), 4) == jnode.read_node_labels(str(p), 4)


@pytest.mark.parametrize("num_vertices", [50, 10_000])
def test_graph_reconstruction_matches_jax(num_vertices):
    g = synth_powerlaw_graph(n=600, avg_deg=8, seed=11)
    emb = np.random.default_rng(1).random((g.n, 16)).astype(np.float32)
    for x in (emb, community_embedding(np.arange(g.n) % 5, 16, 0.5, 3)):
        want = jrecon.graph_reconstruction_accuracy(_jax(g), x, num_vertices)
        got = trecon.graph_reconstruction_accuracy(g, x, num_vertices,
                                                   device=CPU)
        assert got == want


def test_modularity_matches_jax():
    g = synth_powerlaw_graph(n=800, avg_deg=10, seed=2)
    rng = np.random.default_rng(0)
    for k in (1, 2, 7, 50):
        a = rng.integers(0, k, g.n)
        assert abs(tclust.modularity(g, a) - jclust.modularity(_jax(g), a)) <= 1e-12
    karate = load_graph(KARATE)
    assert abs(tclust.modularity(karate, np.zeros(karate.n, dtype=int))) < 1e-12


@pytest.fixture(scope="module")
def planted4():
    g, comm = planted_graph([60, 50, 40, 50], 0.3, 0.01, seed=5)
    return g, comm, community_embedding(comm, 8, 0.3, seed=6) * 5.0


def test_clustering_scores_match_jax(planted4):
    g, comm, emb = planted4
    want = jclust.clustering_scores(_jax(g), emb, k_range=range(2, 8),
                                    labels=comm)
    got = tclust.clustering_scores(g, emb, k_range=range(2, 8), labels=comm,
                                   device=CPU)
    assert got["best_k"] == want["best_k"] == 4.0
    assert abs(got["best_modularity"] - want["best_modularity"]) <= 1e-12
    assert abs(got["best_modularity"] - tclust.modularity(g, comm)) <= 1e-12
    for k in ("silhouette", "davies_bouldin"):
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), k


def test_kmeans_recovers_planted(planted4):
    _, comm, emb = planted4
    gen = torch.Generator().manual_seed(0)
    lab = tclust.kmeans(torch.from_numpy(emb).double(), 4, gen).numpy()
    # the same partition up to a relabeling
    pairs = set(zip(comm.tolist(), lab.tolist()))
    assert len(pairs) == 4 and len({b for _, b in pairs}) == 4


def test_silhouette_davies_bouldin_match_sklearn():
    """Overlapping clusters, uneven sizes and a cluster of one point."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(300, 5))
    lab = rng.integers(0, 4, 300) * 10 + 3
    lab[17] = 99
    xt = torch.from_numpy(x)
    for got, want in ((tclust.silhouette_score(xt, lab),
                       silhouette_score(x, lab)),
                      (tclust.davies_bouldin_score(xt, lab),
                       davies_bouldin_score(x, lab))):
        assert abs(got - want) <= 1e-6 * abs(want)
    with pytest.raises(ValueError):
        tclust.silhouette_score(xt, np.zeros(300, int))


def test_project_2d_pca_matches_jax():
    rng = np.random.default_rng(2)
    emb = (rng.normal(size=(200, 6)) * [5, 3, 1, 0.5, 0.2, 0.1]).astype(np.float32)
    want = jvis.project_2d(emb, "pca")
    got = tvis.project_2d(emb, "pca", device=CPU)
    assert got.shape == (200, 2)
    for j in range(2):
        sign = np.sign(got[:, j] @ want[:, j])
        np.testing.assert_allclose(sign * got[:, j], want[:, j], atol=1e-4)
    two = emb[:, :2]
    np.testing.assert_array_equal(tvis.project_2d(torch.from_numpy(two)), two)


def test_draw_communities_writes_file(tmp_path):
    emb = np.random.default_rng(0).normal(size=(34, 8))
    out = str(tmp_path / "vis.pdf")
    tvis.draw_communities(emb, np.arange(34) % 3, out, device=CPU)
    assert os.path.getsize(out) > 0


# -- the slice: a graph file in, an .embd out, scored ---------------------------


def _train_file_embedding(tmp_path, g, iters, dim=16):
    """Write ``g`` as .mtx, load it, train the sync trainer on the CPU,
    write the .embd and read it back."""
    mtx = str(tmp_path / "g.mtx")
    write_mtx(g, mtx)
    loaded = load_graph(mtx)
    np.testing.assert_array_equal(loaded.colids, g.colids)
    cfg = TrainConfig(dim=dim, batch_size=32, model="tdist", ns=5)
    emb = SyncForce2Vec(loaded, cfg, min_width=4, hub_width=16,
                        device=CPU).train(iters=iters, seed=1)
    embd = str(tmp_path / "g.embd")
    write_embeddings(embd, emb)
    back = read_embeddings(embd)
    np.testing.assert_array_equal(back, jio.read_embeddings(embd))
    np.testing.assert_allclose(back, emb.numpy(), rtol=5e-6, atol=1e-30)
    return loaded, back


def test_slice_file_to_scores_matches_jax(tmp_path):
    """Planted graph → .mtx → train → .embd → scores: the port's scores of
    the read-back embedding against the JAX package's (≥ 20k rows)."""
    g, _ = planted_graph([250] * 4, 0.06, 0.002, seed=9)
    loaded, emb = _train_file_embedding(tmp_path, g, iters=60)
    want = jlink.link_prediction_scores(_jax(loaded), emb)
    got = tlink.link_prediction_scores(loaded, emb, device=CPU)
    assert len(tlink.link_prediction_pairs(loaded)[2]) >= 20_000
    assert got["auc"] > 0.6
    assert abs(got["auc"] - want["auc"]) <= 2e-3
    for k in ("accuracy", "f1_macro", "f1_micro"):
        assert abs(got[k] - want[k]) <= 5e-3, (k, got, want)
    assert trecon.graph_reconstruction_accuracy(
        loaded, emb, 300, device=CPU) == jrecon.graph_reconstruction_accuracy(
        _jax(loaded), emb, 300)


def test_karate_trained_beats_random(tmp_path):
    """On the vendored karate club, a trained embedding predicts links and
    reconstructs the graph clearly better than a random one."""
    g, emb = _train_file_embedding(tmp_path, load_graph(KARATE), iters=300)
    rand = np.random.default_rng(0).normal(size=emb.shape).astype(np.float32)
    trained = tlink.link_prediction_scores(g, emb, device=CPU)
    random_scores = tlink.link_prediction_scores(g, rand, device=CPU)
    assert trained["auc"] > random_scores["auc"] + 0.1
    acc = trecon.graph_reconstruction_accuracy(g, emb, 34, device=CPU)
    acc_rand = trecon.graph_reconstruction_accuracy(g, rand, 34, device=CPU)
    assert acc > acc_rand + 0.1
    out = tclust.clustering_scores(g, emb, k_range=range(2, 8), device=CPU)
    assert out["best_modularity"] > 0.1
