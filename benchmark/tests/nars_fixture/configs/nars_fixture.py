"""Plain reference of ``nars_fixture.json``'s heterogeneous configuration,
NARS with SIGN (Yu et al., arXiv:2011.09679, as SGL runs it), and the
hooks through which it brings its own inputs, cached features and
compared rows (``reference.ModelRef.hook``).

Inputs (:func:`make_inputs`): node types and relations of the
configuration's sizes, drawn from the seed; features on the predict class
alone, class-centred; every other type's features the mean of its
predict-class neighbours' (zeros where it has none), worked out once in
float64 and handed to both sides as inputs; labels and the split on the
predict class.

Cached features (:func:`reference_features`): for each fixed relation
subset, its union subgraph over the types its relations join (every node
of each, in the configuration's type order, re-indexed), made undirected
with each pair once; ``D^-1/2 (A + I) D^-1/2`` and its hops over the
stacked features; the predict class's rows of each hop.  Stacked
``(K+1, S, N_pred, D)``, subsets in the configuration's order.

Model: the aggregator weighs each (hop, feature, subset) and takes the
mean over subsets; each hop then goes through its own projection MLP
(``D -> h``, ReLU after every projection but the first's) and the
concatenation through the head MLP (``(K+1)·h -> h -> C``).  Each MLP has
one shared PReLU slope (0.25) and dropout 0.5 after its hidden layers (the
program's MLP default, which NARS_SIGN keeps).  Parameters are drawn in
the program's order from a CPU generator: the aggregator's ``(K+1, D, S)``
weight ``variance_scaling(1, fan_avg, uniform)`` with Flax's fans (``D·(K+1)``
in, ``S·(K+1)`` out), the MLPs' layers ``variance_scaling(2, fan_avg,
uniform)``, biases zero; dropout bits from a generator on the device, the
projections' in hop order, then the head's."""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

import inputs as bench_inputs
import reference as ref

DROPOUT = 0.5
EDGE_CHUNK = 1 << 20  # edges a step of the neighbour mean, on the host


@dataclasses.dataclass
class HeteroInputs:
    """What the seed made, in the harness's interface (``num_rows``, ``y``,
    the split, ``host_bytes``): ``node_counts`` by type in the graph's
    order, ``edges[relation] = (src, dst)`` local ids (int64), ``x`` by
    type (f32), ``y`` and the split on ``predict_class``."""

    node_counts: dict
    edges: dict
    x: dict
    predict_class: str
    subsets: list
    y: np.ndarray
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray

    @property
    def num_rows(self) -> int:
        return self.node_counts[self.predict_class]

    @property
    def host_bytes(self) -> int:
        """The features a job's precompute uploads: each subset's types'
        (its subgraphs' edges besides, left out of this lower bound)."""
        return sum(self.x[t].nbytes for s in self.subsets for t in _types(self.node_counts, s))


def _types(node_counts: dict, subset) -> list:
    """The node types a relation subset joins, in the graph's order."""
    ends = {t for rel in subset for t in (rel.split("__")[0], rel.split("__")[-1])}
    return [t for t in node_counts if t in ends]


def _predict_class(cfg: dict) -> str:
    return cfg["task"]["args"]["predict_class"]


def bipartite_pairs(n_src: int, n_dst: int, count: int, rng, skew: float, device):
    """``count`` distinct pairs ``(u, v)``, each end drawn with a power-law
    preference over a random rank order of its type: ``(src, dst)`` int64."""
    gen = torch.Generator(device).manual_seed(int(rng.integers(2**62)))
    dev = gen.device
    alpha = 1.0 / (1.0 - skew)
    hubs = [torch.randperm(n, generator=gen, device=dev) for n in (n_src, n_dst)]

    def ends(hub, size):
        n = hub.numel()
        r = torch.rand(size, generator=gen, device=dev) ** alpha
        return hub[torch.minimum((n * r).long(), torch.as_tensor(n - 1, device=dev))]

    assert count <= n_src * n_dst
    keys = torch.empty(0, dtype=torch.long, device=dev)
    while keys.numel() < count:
        m = int((count - keys.numel()) * 1.5) + 16
        keys = torch.unique(torch.cat([keys, ends(hubs[0], m) * n_dst + ends(hubs[1], m)]))
    keys = keys[torch.randperm(keys.numel(), generator=gen, device=dev)[:count].sort().values]
    return (keys // n_dst).cpu().numpy(), (keys % n_dst).cpu().numpy()


def neighbour_mean(n: int, ids, pred_ids, x_pred: np.ndarray) -> np.ndarray:
    """Each of ``n`` nodes' mean over its predict-class neighbours' rows of
    ``x_pred`` (pairs ``(ids, pred_ids)``), summed in float64 on the host
    in edge order, zeros where it has none; f32."""
    x = torch.as_tensor(x_pred).double()
    ids, pred_ids = torch.as_tensor(ids), torch.as_tensor(pred_ids)
    total = torch.zeros(n, x.shape[1], dtype=torch.float64)
    for s in range(0, ids.numel(), EDGE_CHUNK):
        total.index_add_(0, ids[s:s + EDGE_CHUNK], x[pred_ids[s:s + EDGE_CHUNK]])
    deg = torch.bincount(ids, minlength=n).clamp(min=1).double()
    return (total / deg[:, None]).float().numpy()


def make_inputs(cfg: dict, seed: int, device) -> HeteroInputs:
    rng = np.random.default_rng(seed)
    counts, pc = dict(cfg["node_types"]), _predict_class(cfg)
    y = rng.integers(0, int(cfg["num_classes"]), counts[pc])
    edges = {}
    for rel, count in cfg["relations"].items():
        st, _, dt = rel.split("__")
        if st == dt == pc:  # homophilous, as the homogeneous cells' graphs
            pairs = bench_inputs.undirected_pairs(counts[pc], int(count), rng, labels=y,
                                                  homophily=float(cfg["homophily"]), skew=float(cfg["skew"]),
                                                  device=device)
            edges[rel] = (pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64))
        else:
            edges[rel] = bipartite_pairs(counts[st], counts[dt], int(count), rng, float(cfg["skew"]), device)
    tr, va, te = bench_inputs.split_by_counts(counts[pc], cfg["split"], rng)
    x = {pc: bench_inputs.class_features(y, int(cfg["num_features"]), rng, noise=float(cfg["feature_noise"]),
                                         device=device)}
    for t in counts:
        if t == pc:
            continue
        ids, pred = [], []
        for rel, (s, d) in edges.items():
            st, _, dt = rel.split("__")
            for a, b in (((st, dt), (s, d)), ((dt, st), (d, s))):
                if a == (t, pc):
                    ids.append(b[0])
                    pred.append(b[1])
        ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
        pred = np.concatenate(pred) if pred else np.zeros(0, np.int64)
        x[t] = neighbour_mean(counts[t], ids, pred, x[pc])
    return HeteroInputs(counts, edges, x, pc, [list(s) for s in cfg["subsets"]], y.astype(np.int64), tr, va, te)


def reference_features(cfg: dict, inputs: HeteroInputs, device, prec: str):
    """``(K+1, S, N_pred, D)``: each subset's own hops, predict-class rows."""
    k, pc = cfg["model_args"]["prop_steps"], inputs.predict_class
    out = []
    for subset in inputs.subsets:
        types = _types(inputs.node_counts, subset)
        assert pc in types, f"subset {subset} does not touch {pc!r}"
        offset = dict(zip(types, np.cumsum([0] + [inputs.node_counts[t] for t in types])))
        n = int(sum(inputs.node_counts[t] for t in types))
        src, dst = [], []
        for rel in subset:
            st, _, dt = rel.split("__")
            s, d = inputs.edges[rel]
            src.append(torch.as_tensor(s, device=device) + int(offset[st]))
            dst.append(torch.as_tensor(d, device=device) + int(offset[dt]))
        src, dst = torch.cat(src), torch.cat(dst)
        keys = torch.unique(torch.cat([src * n + dst, dst * n + src]))  # each direction of a pair once
        adj = ref.normalized_adjacency(SimpleNamespace(num_nodes=n, src=keys // n, dst=keys % n), device, prec)
        x = np.concatenate([inputs.x[t] for t in types])
        lo, rows = int(offset[pc]), inputs.num_rows
        out.append(torch.stack([h[lo:lo + rows] for h in ref.hops(adj, x, k, prec)]))
        del adj, keys, src, dst
    return torch.stack(out, dim=1)


def sample_rows(cfg: dict, inputs: HeteroInputs, seed: int, count: int = 4096, hubs: int = 64) -> np.ndarray:
    """The ``hubs`` predict-class rows of most edges, over every relation,
    and uniform draws from the seed, sorted."""
    n, pc = inputs.num_rows, inputs.predict_class
    deg = np.zeros(n, np.int64)
    for rel, (s, d) in inputs.edges.items():
        st, _, dt = rel.split("__")
        for ids, t in ((s, st), (d, dt)):
            if t == pc:
                deg += np.bincount(ids, minlength=n)
    top = np.argsort(deg, kind="stable")[-hubs:]
    rest = np.setdiff1d(np.arange(n), top)
    draw = np.random.default_rng([seed, 7]).choice(rest, size=min(count - hubs, rest.shape[0]), replace=False)
    return np.sort(np.concatenate([top, draw]))


def _mlp_dims(cfg: dict, fan_in: int, out: int) -> list:
    a = cfg["model_args"]
    return [fan_in] + [a["hidden_dim"]] * (a["num_layers"] - 1) + [out]


def _mlps(cfg: dict) -> dict:
    """Each MLP's name and widths, in the program's order."""
    a = cfg["model_args"]
    k1, h = a["prop_steps"] + 1, a["hidden_dim"]
    nets = {f"msg_op.projections.{i}": _mlp_dims(cfg, a["feat_dim"], h) for i in range(k1)}
    nets["base_model"] = _mlp_dims(cfg, k1 * h, a["output_dim"])
    return nets


def init(cfg: dict, gen) -> dict:
    a = cfg["model_args"]
    k1, d, s = a["prop_steps"] + 1, a["feat_dim"], a["random_subgraph_num"]
    limit = math.sqrt(6.0 / (d * k1 + s * k1))
    p = {"aggregator.weight": torch.nn.init.uniform_(torch.empty(k1, d, s), -limit, limit, generator=gen)}
    for name, dims in _mlps(cfg).items():
        for j, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
            p[f"{name}.layers.{j}.weight"] = ref.xavier_relu_uniform_(torch.empty(fan_out, fan_in), gen)
            p[f"{name}.layers.{j}.bias"] = torch.zeros(fan_out)
        p[f"{name}.prelu.negative_slope"] = torch.tensor(0.25)
    return p


def _mlp(p: dict, name: str, x, layers: int, train: bool, gen, prec: str):
    slope = p[f"{name}.prelu.negative_slope"]
    for j in range(layers):
        x = ref.matmul(x, p[f"{name}.layers.{j}.weight"].T, prec) + p[f"{name}.layers.{j}.bias"]
        if j < layers - 1:
            x = torch.where(x >= 0, x, slope * x)
            if train:
                x = ref.dropout(x, DROPOUT, gen)
    return x


def forward(cfg: dict, params: dict, feats, train: bool, gen, prec: str):
    """``feats`` is the batch's ``(K+1, S, B, D)`` stack."""
    layers = cfg["model_args"]["num_layers"]
    agg = (feats.permute(0, 2, 3, 1) * params["aggregator.weight"][:, None]).mean(dim=-1)  # (K+1, B, D)
    outs = []
    for i in range(agg.shape[0]):
        o = _mlp(params, f"msg_op.projections.{i}", agg[i], layers, train, gen, prec)
        outs.append(o if i == 0 else torch.relu(o))
    return _mlp(params, "base_model", torch.cat(outs, dim=-1), layers, train, gen, prec)


def rows(feats, idx):
    return feats[:, :, idx]


def forward_flops_per_row(cfg: dict) -> int:
    """The aggregator's weighted mean (``2·S·(K+1)·D``), then every MLP's
    products."""
    a = cfg["model_args"]
    agg = 2 * a["random_subgraph_num"] * (a["prop_steps"] + 1) * a["feat_dim"]
    return agg + sum(2 * i * o for dims in _mlps(cfg).values() for i, o in zip(dims[:-1], dims[1:]))
