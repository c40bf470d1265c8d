"""Raw files of every loader's format, written from a seed.

For runs without the real data (offline tests, the card's smoke run): each
writer puts files of a loader's own format where the loader reads them, so
the loader's whole parse runs on them.  Graphs are power-law and
homophilous (:func:`undirected_pairs`), features carry the class.

:func:`write_loader_files` writes a small dataset for any of
:data:`LOADERS` and returns the loader's keyword arguments;
:func:`write_reddit` and :func:`write_graphsaint` write Reddit's and
Flickr's formats at any size, their published shapes included.
"""

from __future__ import annotations

import io
import json
import os
import os.path as osp
import tarfile
import zipfile

import numpy as np
import scipy.sparse as sp
import torch

# the loaders :func:`write_loader_files` writes for, in ``sgl_tpu``'s order
LOADERS = (
    "Nell", "Amazon", "Coauthor", "Reddit", "Flickr", "AmazonProduct", "Actor", "WebKB", "Airports", "Github",
    "Facebook", "Twitch", "Wikics", "LINKXDataset", "KarateClub", "Custom_Homo", "Custom_Hetero",
)
# published shapes: (nodes, stored nonzeros, features, classes, split sizes)
REDDIT = dict(num_nodes=232_965, nnz=114_615_892, num_features=602, num_classes=41, split=(153_431, 23_831, 55_703))
FLICKR = dict(num_nodes=89_250, nnz=899_756, num_features=500, num_classes=7, split=(44_625, 22_312, 22_313))
# the label rates NELL ships, and how many nodes its official split needs
NELL_MIN_NODES = 1_600


def _generator(rng, device) -> torch.Generator:
    """A torch generator on ``device``, seeded from the numpy ``rng``."""
    return torch.Generator(device).manual_seed(int(rng.integers(2**62)))


def undirected_pairs(num_nodes: int, num_pairs: int, rng, labels=None, homophily: float = 0.8,
                     skew: float = 0.35, device="cpu") -> np.ndarray:
    """``num_pairs`` distinct node pairs ``(u, v)``, ``u < v``, as ``(P, 2)``
    int64 sorted by ``(u, v)``, drawn on ``device`` from a seed that
    ``rng`` gives (the draws differ between the CPU and the card).

    Each end is drawn with a power-law preference: node ranks follow
    ``floor(N·r^(1/(1-skew)))`` for uniform ``r``, so rank ``k``'s degree
    falls as ``k^-skew``, over a random rank order.  With ``labels``, the
    second end is drawn within the first end's class with probability
    ``homophily``, by the same law over the class's nodes in rank order.
    Each round of draws is sized by the share of new pairs the last one
    gave, so hub pairs drawn again do not make it crawl.
    """
    gen = _generator(rng, device)
    dev = gen.device
    n = num_nodes
    alpha = 1.0 / (1.0 - skew)

    def ranks(size, count):  # f32 may round count·r^alpha up to count
        r = torch.rand(size, generator=gen, device=dev) ** alpha
        return torch.minimum((count * r).long(), torch.as_tensor(count, device=dev) - 1)

    hub = torch.randperm(n, generator=gen, device=dev)  # rank -> node
    if labels is not None:
        labels = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=dev)
        rank = torch.empty(n, dtype=torch.long, device=dev)
        rank[hub] = torch.arange(n, device=dev)
        by_class = torch.argsort(labels * n + rank)  # class by class, in rank order
        counts = torch.bincount(labels)
        start = counts.cumsum(0) - counts
    keys = torch.empty(0, dtype=torch.long, device=dev)
    new_share = 0.9  # of the pairs drawn, the share not drawn before
    while keys.numel() < num_pairs:
        m = int((num_pairs - keys.numel()) / new_share * 1.1) + 16
        u, v = hub[ranks(m, n)], hub[ranks(m, n)]
        if labels is not None:
            same = torch.nonzero(torch.rand(m, generator=gen, device=dev) < homophily).flatten()
            cu = labels[u[same]]
            v[same] = by_class[start[cu] + ranks(same.numel(), counts[cu])]
        keep = u != v
        fresh = torch.unique(torch.minimum(u, v)[keep] * n + torch.maximum(u, v)[keep])
        if keys.numel():  # the pairs not drawn before, merged in
            fresh = fresh[keys[torch.searchsorted(keys, fresh).clamp_max(keys.numel() - 1)] != fresh]
            keys = torch.sort(torch.cat([keys, fresh])).values
        else:
            keys = fresh
        new_share = max(fresh.numel() / m, 1e-3)
    if keys.numel() > num_pairs:
        drop = torch.randperm(keys.numel(), generator=gen, device=dev)[: keys.numel() - num_pairs]
        kept = torch.ones(keys.numel(), dtype=torch.bool, device=dev)
        kept[drop] = False
        keys = keys[kept]
    return torch.stack([keys // n, keys % n], dim=1).cpu().numpy()


def class_features(labels, num_features: int, rng, noise: float = 1.0, device="cpu") -> np.ndarray:
    """f32 features: the node's class center plus Gaussian noise, drawn on
    ``device`` from a seed that ``rng`` gives."""
    gen = _generator(rng, device)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=gen.device)
    centers = torch.randn(int(labels.max()) + 1, num_features, generator=gen, device=gen.device)
    x = torch.randn(labels.numel(), num_features, generator=gen, device=gen.device)
    return (x * noise + centers[labels]).cpu().numpy()


def _symmetric(pairs: np.ndarray):
    """Both directions of every pair: ``(rows, cols)`` int32."""
    u, v = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    return np.concatenate([u, v]), np.concatenate([v, u])


def _split_by_counts(num_nodes: int, split, rng):
    perm = rng.permutation(num_nodes)
    a, b = split[0], split[0] + split[1]
    return perm[:a], perm[a:b], perm[b:]


def write_reddit(raw_dir: str, num_nodes: int = REDDIT["num_nodes"], nnz: int = REDDIT["nnz"],
                 num_features: int = REDDIT["num_features"], num_classes: int = REDDIT["num_classes"],
                 split=REDDIT["split"], seed: int = 0, zipped: bool = False, device="cpu") -> dict:
    """DGL's Reddit files: ``reddit_graph.npz`` (a symmetric COO adjacency
    of ``nnz`` stored ones, ``nnz`` even, without self loops) and
    ``reddit_data.npz`` (``feature``, ``label``, ``node_types`` 1/2/3 in
    ``split``'s counts), uncompressed; with ``zipped``, both inside
    ``reddit.zip`` instead, as the download brings them.  The graph and
    the features are drawn on ``device`` (a card draws Reddit's in a
    second).  Returns the stored nonzeros, the labels and the node types."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num_nodes)
    rows, cols = _symmetric(undirected_pairs(num_nodes, nnz // 2, rng, labels=y, device=device))
    adj = sp.coo_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)), shape=(num_nodes, num_nodes))
    node_types = np.zeros(num_nodes, np.int32)
    for t, idx in enumerate(_split_by_counts(num_nodes, split, rng), start=1):
        node_types[idx] = t
    x = class_features(y, num_features, rng, noise=2.0, device=device)
    os.makedirs(raw_dir, exist_ok=True)
    graph_file, data_file = io.BytesIO(), io.BytesIO()
    if zipped:
        sp.save_npz(graph_file, adj, compressed=False)
        np.savez(data_file, feature=x, label=y, node_types=node_types)
        with zipfile.ZipFile(osp.join(raw_dir, "reddit.zip"), "w") as zf:
            zf.writestr("reddit_graph.npz", graph_file.getvalue())
            zf.writestr("reddit_data.npz", data_file.getvalue())
    else:
        sp.save_npz(osp.join(raw_dir, "reddit_graph.npz"), adj, compressed=False)
        np.savez(osp.join(raw_dir, "reddit_data.npz"), feature=x, label=y, node_types=node_types)
    return dict(nnz=int(rows.shape[0]), y=y, node_types=node_types)


def write_graphsaint(raw_dir: str, num_nodes: int = FLICKR["num_nodes"], nnz: int = FLICKR["nnz"],
                     num_features: int = FLICKR["num_features"], num_classes: int = FLICKR["num_classes"],
                     split=FLICKR["split"], multilabel: bool = False, seed: int = 0, device="cpu") -> dict:
    """GraphSAINT's files (Flickr's shape by default): ``adj_full.npz`` (the
    CSR arrays of a symmetric adjacency of ``nnz`` stored ones),
    ``feats.npy``, ``class_map.json`` (a class id a node, or with
    ``multilabel`` a 0/1 list whose first 1 is the class) and ``role.json``
    (``tr``/``va``/``te`` in ``split``'s counts); the graph and the
    features drawn on ``device``.  Returns the stored nonzeros and the
    labels."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num_nodes)
    rows, cols = _symmetric(undirected_pairs(num_nodes, nnz // 2, rng, labels=y, device=device))
    adj = sp.csr_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)), shape=(num_nodes, num_nodes))
    os.makedirs(raw_dir, exist_ok=True)
    np.savez(osp.join(raw_dir, "adj_full.npz"), data=adj.data, indices=adj.indices, indptr=adj.indptr,
             shape=np.asarray(adj.shape))
    np.save(osp.join(raw_dir, "feats.npy"), class_features(y, num_features, rng, noise=2.0, device=device))
    if multilabel:
        extra = rng.random((num_nodes, num_classes)) < 0.2
        hot = np.where(np.arange(num_classes)[None, :] > y[:, None], extra, False)
        hot[np.arange(num_nodes), y] = True  # y is the first 1: the argmax
        class_map = {str(i): row.astype(int).tolist() for i, row in enumerate(hot)}
    else:
        class_map = {str(i): int(v) for i, v in enumerate(y)}
    with open(osp.join(raw_dir, "class_map.json"), "w") as f:
        json.dump(class_map, f)
    tr, va, te = _split_by_counts(num_nodes, split, rng)
    with open(osp.join(raw_dir, "role.json"), "w") as f:
        json.dump({"tr": tr.tolist(), "va": va.tolist(), "te": te.tolist()}, f)
    return dict(nnz=int(rows.shape[0]), y=y)


def write_nell_tarball(raw_dir: str, name: str = "nell.0.001", seed: int = 0, **shape) -> str:
    """``nell_data.tar.gz`` as the download brings it: the Planetoid-format
    files of ``name`` (``planetoid.write_raw_files``'s, at ``shape``) under
    ``nell_data/``, beside another label rate's, which the loader must
    leave.  Returns the tarball's path."""
    import tempfile

    from sgl_tpu_torch.datasets.planetoid import write_raw_files

    os.makedirs(raw_dir, exist_ok=True)
    path = osp.join(raw_dir, "nell_data.tar.gz")
    with tempfile.TemporaryDirectory() as tmp:
        write_raw_files(osp.join(tmp, "nell_data"), name, seed=seed, **shape)
        with open(osp.join(tmp, "nell_data", "ind.nell.other.graph"), "wb") as f:
            f.write(b"not this label rate")
        with tarfile.open(path, "w:gz") as tf:
            tf.add(osp.join(tmp, "nell_data"), arcname="nell_data")
    return path


def _graph(n: int, avg_degree: int, rng, y):
    return undirected_pairs(n, max(1, n * avg_degree // 2), rng, labels=y)


def _write_gnn_benchmark(path, n, d, c, avg_degree, rng) -> None:
    y = rng.integers(0, c, n)
    attr = sp.csr_matrix(np.where(class_features(y, d, rng) > 1.0, rng.integers(1, 4, (n, d)), 0))
    pairs = _graph(n, avg_degree, rng, y)  # one direction only: the loader makes it undirected
    adj = sp.csr_matrix((np.ones(pairs.shape[0], np.float32), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    np.savez(path, attr_data=attr.data, attr_indices=attr.indices, attr_indptr=attr.indptr,
             attr_shape=np.asarray(attr.shape), adj_data=adj.data, adj_indices=adj.indices,
             adj_indptr=adj.indptr, adj_shape=np.asarray(adj.shape), labels=y)


def _write_geom_gcn(raw_dir, n, d, c, avg_degree, rng, one_hot: bool) -> None:
    y = rng.integers(0, c, n)
    x = class_features(y, d, rng)
    if one_hot:  # Actor: the columns of each node's largest features
        feats = [",".join(str(j) for j in np.sort(np.argsort(-row)[:3])) for row in x]
    else:
        feats = [",".join(f"{v:.4f}" for v in row) for row in x]
    order = rng.permutation(n)  # rows need not come in id order
    lines = ["node_id\tfeature\tlabel"] + [f"{i}\t{feats[i]}\t{y[i]}" for i in order]
    with open(osp.join(raw_dir, "out1_node_feature_label.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    pairs = _graph(n, avg_degree, rng, y)
    pairs = pairs[rng.permutation(pairs.shape[0])]
    with open(osp.join(raw_dir, "out1_graph_edges.txt"), "w") as f:
        f.write("node_id\tnode_id\n" + "".join(f"{a}\t{b}\n" for a, b in pairs))


def _write_airports(raw_dir, name, n, c, avg_degree, rng) -> None:
    ids = rng.choice(10 * n, n, replace=False) + 100  # the files' own node ids
    y = rng.integers(0, c, n)
    with open(osp.join(raw_dir, f"labels-{name}-airports.txt"), "w") as f:
        f.write("node label\n" + "".join(f"{i} {v}\n" for i, v in zip(ids, y)))
    pairs = _graph(n, avg_degree, rng, y)
    with open(osp.join(raw_dir, f"{name}-airports.edgelist"), "w") as f:
        f.write("".join(f"{ids[a]} {ids[b]}\n" for a, b in pairs))


def _write_musae(path, n, d, c, avg_degree, rng) -> None:
    y = rng.integers(0, c, n)
    pairs = _graph(n, avg_degree, rng, y)
    np.savez(path, edges=pairs[rng.permutation(pairs.shape[0])], features=class_features(y, d, rng), target=y)


def _write_wikics(raw_dir, n, d, c, avg_degree, rng) -> None:
    y = rng.integers(0, c, n)
    pairs = _graph(n, avg_degree, rng, y)
    flip = rng.random(pairs.shape[0]) < 0.5  # links point either way
    src = np.where(flip, pairs[:, 1], pairs[:, 0])
    dst = np.where(flip, pairs[:, 0], pairs[:, 1])
    links = [[] for _ in range(n)]
    for a, b in zip(src.tolist(), dst.tolist()):
        links[a].append(b)
    data = {"features": np.round(class_features(y, d, rng), 4).tolist(), "labels": y.tolist(), "links": links}
    with open(osp.join(raw_dir, "data.json"), "w") as f:
        json.dump(data, f)


def _write_linkx(path, n, avg_degree, rng) -> None:
    from scipy.io import savemat

    # local_info: student/faculty, gender (0 unknown, 1, 2), major, minor,
    # dorm, year, high school
    gender = rng.integers(0, 3, n)
    info = np.stack([rng.integers(1, 3, n), gender, rng.integers(0, 6, n), rng.integers(0, 6, n),
                     rng.integers(0, 4, n), rng.integers(2004, 2010, n), rng.integers(0, 8, n)], axis=1)
    pairs = _graph(n, avg_degree, rng, gender)
    rows, cols = _symmetric(pairs)
    a = sp.csc_matrix((np.ones(rows.shape[0]), (rows, cols)), shape=(n, n))
    savemat(path, {"A": a, "local_info": info.astype(np.float64)})


def _write_custom_homo(raw_dir, n, d, c, avg_degree, rng) -> None:
    y = rng.integers(0, c, n)
    pairs = _graph(n, avg_degree, rng, y)
    rows, cols = _symmetric(pairs)
    np.save(osp.join(raw_dir, "x.npy"), class_features(y, d, rng))
    np.savez(osp.join(raw_dir, "adj_matrix.npz"), row=rows, col=cols,
             data=rng.uniform(0.5, 1.5, rows.shape[0]).astype(np.float32))
    np.save(osp.join(raw_dir, "label.npy"), np.eye(c, dtype=np.float32)[y])  # one-hot rows
    tr, va, te = _split_by_counts(n, (n // 2, n // 4), rng)
    np.savez(osp.join(raw_dir, "indices.npz"), train_idx=tr, val_idx=va, test_idx=te)


CUSTOM_HETERO = dict(predict="paper", node_types=["paper", "author"],
                     edge_types=[("paper", "cites", "paper"), ("author", "writes", "paper")])


def _write_custom_hetero(raw_dir, n, d, c, avg_degree, rng) -> None:
    n_author = n // 2
    y = rng.integers(0, c, n)
    np.save(osp.join(raw_dir, "x_paper.npy"), class_features(y, d, rng))
    np.save(osp.join(raw_dir, "x_author.npy"), rng.standard_normal((n_author, d), dtype=np.float32))
    np.save(osp.join(raw_dir, "label_paper.npy"), y)
    cites = _graph(n, avg_degree, rng, y)
    np.savez(osp.join(raw_dir, "adj_paper__cites__paper.npz"), row=cites[:, 0], col=cites[:, 1])
    e = n * avg_degree // 2
    np.savez(osp.join(raw_dir, "adj_author__writes__paper.npz"), row=rng.integers(0, n_author, e),
             col=rng.integers(0, n, e))


def write_loader_files(loader: str, root: str, num_nodes: int = 300, num_features: int = 16,
                       num_classes: int = 4, avg_degree: int = 6, seed: int = 0, downloaded: bool = False) -> dict:
    """Write a small dataset of ``loader``'s format (one of :data:`LOADERS`)
    where ``loader(root=root, **kwargs)`` reads it; return ``kwargs``.

    With ``downloaded``, the two archives are written as the download
    brings them and the loader unpacks them: Reddit's ``reddit.zip`` and
    NELL's ``nell_data.tar.gz``.  NELL's official split needs
    :data:`NELL_MIN_NODES` nodes, which it gets whatever ``num_nodes``.
    ``KarateClub`` is built in: nothing is written.
    """
    n, d, c, deg = num_nodes, num_features, num_classes, avg_degree
    rng = np.random.default_rng(seed)

    def raw(*parts):
        path = osp.join(root, *parts, "raw")
        os.makedirs(path, exist_ok=True)
        return path

    if loader == "Nell":
        name = "nell.0.001"
        m = max(n, NELL_MIN_NODES)
        shape = dict(num_nodes=m, num_features=d, num_classes=c, num_edges=m * deg // 2, density=0.3)
        if downloaded:
            write_nell_tarball(raw("Nell", name), name, seed=seed, **shape)
        else:
            from sgl_tpu_torch.datasets.planetoid import write_raw_files

            write_raw_files(raw("Nell", name), name, seed=seed, **shape)
        return {"name": name}
    if loader in ("Amazon", "Coauthor"):
        name, stem = ("photo", "amazon_electronics_photo") if loader == "Amazon" else ("cs", "ms_academic_cs")
        _write_gnn_benchmark(osp.join(raw(loader.lower(), name), f"{stem}.npz"), n, d, c, deg, rng)
        return {"name": name}
    if loader == "Reddit":
        write_reddit(raw("reddit", "reddit"), n, n * deg, d, c, (n // 2, n // 4, n - n // 2 - n // 4), seed=seed,
                     zipped=downloaded)
        return {}
    if loader in ("Flickr", "AmazonProduct"):
        name = "flickr" if loader == "Flickr" else "amazon_product"
        write_graphsaint(raw(name, name), n, n * deg, d, c, (n // 2, n // 4, n - n // 2 - n // 4),
                         multilabel=loader == "AmazonProduct", seed=seed)
        return {}
    if loader == "Actor":
        _write_geom_gcn(raw("actor", "actor"), n, d, c, deg, rng, one_hot=True)
        return {}
    if loader == "WebKB":
        _write_geom_gcn(raw("webkb", "cornell"), n, d, c, deg, rng, one_hot=False)
        return {"name": "cornell"}
    if loader == "Airports":
        _write_airports(raw("airports", "usa"), "usa", n, c, deg, rng)
        return {"name": "usa"}
    if loader in ("Github", "Facebook"):
        name = loader.lower()
        _write_musae(osp.join(raw(name, name), f"{name}.npz"), n, d, c, deg, rng)
        return {}
    if loader == "Twitch":
        _write_musae(osp.join(raw("twitch", "EN"), "EN.npz"), n, d, c, deg, rng)
        return {"name": "EN"}
    if loader == "Wikics":
        _write_wikics(raw("wikics", "wikics"), n, d, c, deg, rng)
        return {}
    if loader == "LINKXDataset":
        _write_linkx(osp.join(raw("linkx", "reed98"), "Reed98.mat"), n, deg, rng)
        return {"name": "reed98"}
    if loader == "KarateClub":
        return {}
    if loader == "Custom_Homo":
        _write_custom_homo(raw("mygraph"), n, d, c, deg, rng)
        return {"name": "mygraph"}
    if loader == "Custom_Hetero":
        _write_custom_hetero(raw("myhetero"), n, d, c, deg, rng)
        h = CUSTOM_HETERO
        return {"name": "myhetero", "type_of_node_to_predict": h["predict"], "node_types": h["node_types"],
                "edge_types_tuple": h["edge_types"]}
    raise ValueError(f"no raw-file writer for {loader!r}; one of {LOADERS}")
