"""The clustering plots of the port on the CPU: its PNG writer and reader,
its raster figure against matplotlib's drawing of ``sgl_tpu``'s ``plot``,
``plotClusters`` end to end, and two class members ``sgl_tpu`` has
(``MessageOp.learnable``, ``SparseAdj.nnz_padded``)."""

import io

import numpy as np
import pytest
import torch

import sgl_tpu.ops.message_ops as J
from sgl_tpu.graph import symmetric_normalized_weights as j_sym
from sgl_tpu.tasks.clustering_metrics import clustering_metrics as JMetrics
from sgl_tpu_torch.graph import Graph, symmetric_normalized_weights
from sgl_tpu_torch.ops import message_ops as P
from sgl_tpu_torch.tasks.clustering_metrics import PLOT_COLORS, clustering_metrics
from sgl_tpu_torch.utils.figure import Figure, read_png, to_rgba, write_png
from tests.conftest import random_graph

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mpl():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.image
    import matplotlib.pyplot

    return matplotlib.pyplot, matplotlib.image


def points(n=400, labels=10, seed=0):
    """2-D points in overlapping clouds, labels 0..``labels``-1 (those of 8
    and more are not drawn)."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, labels, n)
    return rng.normal(size=(n, 2)) * 3 + lab[:, None] * 1.5, lab


def rgb(color) -> np.ndarray:
    return np.rint(np.asarray(to_rgba(color)[:3]) * 255).astype(np.uint8)


def test_png_round_trip(tmp_path):
    """An RGBA array written by ``write_png`` reads back bit for bit through
    the port's reader and through ``matplotlib.image.imread``."""
    _, image = mpl()
    rgba = np.random.default_rng(0).integers(0, 256, (37, 53, 4), dtype=np.uint8)
    path = tmp_path / "a.png"
    write_png(path, rgba)
    np.testing.assert_array_equal(read_png(path), rgba)
    np.testing.assert_array_equal(np.rint(image.imread(path) * 255).astype(np.uint8), rgba)


def test_png_reader_undoes_every_filter(tmp_path):
    """A PNG that matplotlib writes (libpng picks a filter for each row)
    reads as ``imread`` reads it; a corrupt chunk is refused."""
    plt, image = mpl()
    x, lab = points(120)
    fig = plt.figure()
    JMetrics.plot(x, fig, list(PLOT_COLORS), 40, lab)
    path = tmp_path / "m.png"
    fig.savefig(path, dpi=30)
    plt.close(fig)
    raw = path.read_bytes()
    np.testing.assert_array_equal(read_png(path), np.rint(image.imread(path) * 255).astype(np.uint8))
    bad = bytearray(raw)
    bad[40] ^= 0xFF  # in the chunk after IHDR
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError):
        read_png(tmp_path / "bad.png")


def _matplotlib_picture(x, lab) -> np.ndarray:
    plt, image = mpl()
    fig = plt.figure()
    JMetrics.plot(x, fig, list(PLOT_COLORS), 40, lab)
    fig.axes[0].axis("off")
    buf = io.BytesIO()
    fig.savefig(buf, dpi=120)
    plt.close(fig)
    buf.seek(0)
    return np.rint(image.imread(buf, format="png") * 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_plot_matches_matplotlib(seed):
    """The port's ``plot`` on its ``Figure`` against ``sgl_tpu``'s ``plot``
    on a matplotlib Agg figure at 120 dpi, the axis off on both: the same
    size (768 × 576), IoU of the non-white pixels ≥ 0.9, each label's
    colour centroid within 2 px and pixel count within 15% (measured: the
    masks equal)."""
    x, lab = points(seed=seed)
    want = _matplotlib_picture(x, lab)
    fig = Figure()
    clustering_metrics.plot(x, fig, PLOT_COLORS, 40, lab)
    fig.gca().axis("off")
    got = fig.render(120)
    assert got.shape == want.shape == (576, 768, 4)
    inked_got, inked_want = (got[..., :3] != 255).any(-1), (want[..., :3] != 255).any(-1)
    assert (inked_got & inked_want).sum() / (inked_got | inked_want).sum() >= 0.9
    for color in PLOT_COLORS:
        mask_got, mask_want = (got[..., :3] == rgb(color)).all(-1), (want[..., :3] == rgb(color)).all(-1)
        assert mask_want.sum() > 0, color
        assert abs(int(mask_got.sum()) - int(mask_want.sum())) <= 0.15 * mask_want.sum(), color
        assert np.abs(np.argwhere(mask_got).mean(0) - np.argwhere(mask_want).mean(0)).max() <= 2.0, color


def test_plot_draws_on_a_matplotlib_figure():
    """The port's ``plot`` on a matplotlib figure (duck-typed) puts the same
    offsets in each collection as ``sgl_tpu``'s, from a tensor too."""
    plt, _ = mpl()
    x, lab = points()
    figs = [plt.figure() for _ in range(2)]
    JMetrics.plot(x, figs[0], list(PLOT_COLORS), 40, lab)
    clustering_metrics.plot(torch.as_tensor(x), figs[1], PLOT_COLORS, 40, torch.as_tensor(lab))
    want, got = (f.axes[0].collections for f in figs)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.get_offsets(), w.get_offsets())
        np.testing.assert_array_equal(g.get_facecolor(), w.get_facecolor())
    for f in figs:
        plt.close(f)


def test_plot_clusters_on_the_cpu(tmp_path):
    """``plotClusters(..., device="cpu")`` on ``tests/test_tasks.py``'s
    input (labels 0..9 here): it writes a decodable 768 × 576 PNG, returns
    its path, and draws no point of label 8 or 9: the picture equals the
    plot of the labels under 8 alone."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(40, 8)).astype(np.float32)
    labels = rng.integers(0, 10, 40)
    cm = clustering_metrics(labels, labels)
    path = str(tmp_path / "plot.png")
    assert cm.plotClusters(emb, labels, path=path, device="cpu") == path
    picture = read_png(path)
    assert picture.shape == (576, 768, 4)
    y = cm.tsne_.embedding_.numpy()
    keep = labels < 8
    assert 0 < keep.sum() < labels.size
    fig = Figure()
    # the limits come from the drawn points only, as in matplotlib
    clustering_metrics.plot(y[keep], fig, PLOT_COLORS, 40, labels[keep])
    fig.gca().axis("off")
    np.testing.assert_array_equal(picture, fig.render(120))


def test_plot_clusters_needs_a_device_or_cuda(tmp_path):
    """Without CUDA, ``plotClusters`` with no device raises (nothing drops
    to the CPU); with CUDA its t-SNE runs there."""
    from sgl_tpu_torch.tasks import TSNE

    if torch.cuda.is_available():
        assert TSNE().device.type == "cuda"
        return
    labels = np.arange(12) % 3
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clustering_metrics(labels, labels).plotClusters(np.zeros((12, 4), np.float32), labels,
                                                        path=str(tmp_path / "p.png"))
    assert not (tmp_path / "p.png").exists()


# every message op of both packages, built with the same settings
MESSAGE_OPS = {
    "LastMessageOp": {}, "SumMessageOp": {}, "MeanMessageOp": {}, "MaxMessageOp": {}, "MinMessageOp": {},
    "ConcatMessageOp": {}, "OverSmoothDistanceWeightedOp": {},
    "ProjectedConcatMessageOp": dict(hidden_dim=8, num_layers=2),
    "SimpleWeightedMessageOp": dict(combination_type="alpha", alpha=0.85),
    "LearnableWeightedMessageOp": dict(combination_type="gate", prop_steps=3),
    "IterateLearnableWeightedMessageOp": dict(combination_type="recursive"),
}
PORT_ONLY_ARGS = {"ProjectedConcatMessageOp": dict(feat_dim=8), "LearnableWeightedMessageOp": dict(feat_dim=8),
                  "IterateLearnableWeightedMessageOp": dict(feat_dim=8)}


@pytest.mark.parametrize("name", sorted(MESSAGE_OPS))
def test_message_op_learnable_matches(name):
    jop = getattr(J, name)(start=0, end=4, **MESSAGE_OPS[name],
                           **({"feat_dim": 8} if name == "LearnableWeightedMessageOp" else {}))
    op = getattr(P, name)(0, 4, **MESSAGE_OPS[name], **PORT_ONLY_ARGS.get(name, {}))
    assert isinstance(op.learnable, bool)
    assert op.learnable == jop.learnable


@pytest.mark.parametrize("pad_multiple", [1, 256])
def test_sparse_adj_nnz_padded_matches(pad_multiple):
    """``nnz_padded`` of the normalized adjacency, ``sgl_tpu``'s and the
    port's, from the same graph: both count the padding edges."""
    from sgl_tpu.graph import Graph as JGraph

    g = random_graph()
    src, dst, val = (np.asarray(a)[: g.num_edges] for a in (g.src, g.dst, g.val))
    jg = JGraph.from_coo(src, dst, val, num_nodes=g.num_nodes, pad_multiple=pad_multiple)
    pg = Graph.from_coo(src, dst, val, num_nodes=g.num_nodes, pad_multiple=pad_multiple)
    want = j_sym(jg).nnz_padded
    got = symmetric_normalized_weights(pg, device=CPU).nnz_padded
    assert isinstance(got, int) and got == want == pg.num_edges_padded + g.num_nodes
