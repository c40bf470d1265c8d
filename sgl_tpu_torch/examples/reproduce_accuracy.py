"""Reproduce the published accuracy bands in one command — counterpart of
``examples/reproduce_accuracy.py``.

Each workload fetches its dataset through the loaders' ``raw_urls`` when
the raw files are absent, runs the shipped configuration on the card (or
on ``--device``) and compares the result with the published band:

    python -m sgl_tpu_torch.examples.reproduce_accuracy [--root ./data/] [--workloads ...] [--device cpu]

Offline, a workload whose dataset cannot be fetched reports NO DATA, and
the run fails unless ``--allow-missing`` or ``--no-check``.
"""

from __future__ import annotations

import argparse
import sys


def run_sgc_pubmed(root: str, epochs: int = 200, split: str = "official", device=None):
    """SGC on pubmed (the SGC paper's setting)."""
    from sgl_tpu_torch.datasets import Planetoid
    from sgl_tpu_torch.models import SGC
    from sgl_tpu_torch.tasks import NodeClassification

    ds = Planetoid("pubmed", root, split)
    model = SGC(prop_steps=3, feat_dim=ds.num_features, output_dim=ds.num_classes)
    return NodeClassification(ds, model, lr=0.1, weight_decay=5e-5, epochs=epochs, device=device,
                              verbose=False).test_acc


def run_gamlp_products(root: str, epochs: int = 200, split: str = "official", device=None):
    """GAMLP on ogbn-products.  ``split`` is accepted for a uniform
    signature: OGB ships only the official split."""
    from sgl_tpu_torch.datasets import Ogbn
    from sgl_tpu_torch.models import GAMLP
    from sgl_tpu_torch.tasks import NodeClassification

    ds = Ogbn("products", root, "official")
    model = GAMLP(prop_steps=3, feat_dim=ds.num_features, output_dim=ds.num_classes, hidden_dim=512, num_layers=3)
    return NodeClassification(ds, model, lr=0.1, weight_decay=5e-5, epochs=epochs, device=device, verbose=False,
                              train_batch_size=50000, eval_batch_size=100000).test_acc


def run_nafs_linkpred_pubmed(root: str, epochs: int = 0, split: str = "official", device=None):
    """Training-free NAFS link prediction on pubmed; ``epochs`` unused."""
    from sgl_tpu_torch.datasets import Planetoid
    from sgl_tpu_torch.tasks import LinkPredictionNAFS

    ds = Planetoid("pubmed", root, split)
    return LinkPredictionNAFS(ds, hops=20, method="mean", verbose=False, device=device).test_roc_auc


def run_nafs_cluster_pubmed(root: str, epochs: int = 0, split: str = "official", device=None):
    """Training-free NAFS node clustering on pubmed; ``epochs`` unused."""
    from sgl_tpu_torch.datasets import Planetoid
    from sgl_tpu_torch.tasks import NodeClusteringNAFS

    ds = Planetoid("pubmed", root, split)
    return NodeClusteringNAFS(ds, hops=20, method="mean", verbose=False, device=device).acc


def _planetoid_classifier(model_cls, name, root, epochs, split, device, **model_kw):
    from sgl_tpu_torch.datasets import Planetoid
    from sgl_tpu_torch.tasks import NodeClassification

    ds = Planetoid(name, root, split)
    model = model_cls(prop_steps=3, feat_dim=ds.num_features, output_dim=ds.num_classes, **model_kw)
    return NodeClassification(ds, model, lr=0.1, weight_decay=5e-5, epochs=epochs, device=device,
                              verbose=False).test_acc


def run_sign_cora(root, epochs=200, split="official", device=None):
    from sgl_tpu_torch.models import SIGN

    return _planetoid_classifier(SIGN, "cora", root, epochs, split, device, hidden_dim=128, num_layers=2)


def run_sign_citeseer(root, epochs=200, split="official", device=None):
    from sgl_tpu_torch.models import SIGN

    return _planetoid_classifier(SIGN, "citeseer", root, epochs, split, device, hidden_dim=128, num_layers=2)


def run_ssgc_cora(root, epochs=200, split="official", device=None):
    from sgl_tpu_torch.models import SSGC

    return _planetoid_classifier(SSGC, "cora", root, epochs, split, device)


def run_ssgc_citeseer(root, epochs=200, split="official", device=None):
    from sgl_tpu_torch.models import SSGC

    return _planetoid_classifier(SSGC, "citeseer", root, epochs, split, device)


def run_gbp_cora(root, epochs=200, split="official", device=None):
    from sgl_tpu_torch.models import GBP

    return _planetoid_classifier(GBP, "cora", root, epochs, split, device, hidden_dim=128, num_layers=2)


def run_gbp_citeseer(root, epochs=200, split="official", device=None):
    from sgl_tpu_torch.models import GBP

    return _planetoid_classifier(GBP, "citeseer", root, epochs, split, device, hidden_dim=128, num_layers=2)


NAS_SMOKE_TRIALS = 20  # the mock-network test shrinks this


def run_nas_cora(root, epochs=50, split="official", device=None):
    """A ``NAS_SMOKE_TRIALS``-trial PaSca search on cora (OpenBox when it is
    installed, else the built-in evolutionary search); the best trial's
    accuracy."""
    from sgl_tpu_torch.datasets import Planetoid
    from sgl_tpu_torch.search import ConfigManager, run_nas

    ds = Planetoid("cora", root, split)
    configer = ConfigManager(arch=[2, 1, 1, 2, 0, 0, 0])
    configer._setParameters(ds, device, 128, epochs=epochs, lr=0.1, wd=5e-5, restarts=1)
    history = run_nas(configer, max_runs=NAS_SMOKE_TRIALS, optimizer="auto", seed=1, verbose=False)
    return -history.best_accuracy_trial.objs[0]


def run_dist_sgc_pubmed(root, epochs=200, split="official", device=None):
    """SGC on pubmed through the distributed runtime: the ring
    pre-propagation and data-parallel training on the ranks the process
    group holds (``torchrun``), a (1, 1) mesh for a process alone, whose
    one-rank group is torn down at the end."""
    import torch.distributed as dist

    from sgl_tpu_torch.datasets import Planetoid
    from sgl_tpu_torch.models import SGCDist
    from sgl_tpu_torch.parallel import init_distributed
    from sgl_tpu_torch.tasks import NodeClassificationDist

    ds = Planetoid("pubmed", root, split)
    model = SGCDist(prop_steps=3, feat_dim=ds.num_features, output_dim=ds.num_classes)
    alone = not dist.is_initialized() and not init_distributed()
    n = 1 if alone else dist.get_world_size()
    shape = (max(n // 2, 1), 2) if n >= 2 else (1, 1)
    try:
        return NodeClassificationDist(ds, model, lr=0.1, weight_decay=5e-5, epochs=epochs, mesh_shape=shape,
                                      device=device, verbose=False).test_acc
    finally:
        if alone and dist.is_initialized():
            dist.destroy_process_group()


# workload -> (runner, metric name, (low, high) published band, provenance)
WORKLOADS = {
    "sgc_pubmed": (run_sgc_pubmed, "test acc", (0.77, 0.82), "SGC paper (ICML'19): 0.789-0.799"),
    "gamlp_products": (run_gamlp_products, "test acc", (0.82, 0.87), "GAMLP paper (KDD'22): 0.8459"),
    "nafs_linkpred_pubmed": (
        run_nafs_linkpred_pubmed, "roc-auc", (0.93, 1.0),
        "NAFS paper (ICML'22): matches/beats GAE (pubmed AUC ~0.964)",
    ),
    "nafs_cluster_pubmed": (
        run_nafs_cluster_pubmed, "cluster acc", (0.60, 1.0),
        "NAFS paper (ICML'22): pubmed clustering acc ~0.69 without training",
    ),
    "sign_cora": (
        run_sign_cora, "test acc", (0.78, 0.85), "SIGN paper (ICML-W'20) / common planetoid reproductions: ~0.82",
    ),
    "sign_citeseer": (run_sign_citeseer, "test acc", (0.68, 0.76), "common planetoid reproductions: ~0.72"),
    "ssgc_cora": (run_ssgc_cora, "test acc", (0.80, 0.86), "S2GC paper (ICLR'21): 0.830"),
    "ssgc_citeseer": (run_ssgc_citeseer, "test acc", (0.70, 0.77), "S2GC paper (ICLR'21): 0.736"),
    "gbp_cora": (run_gbp_cora, "test acc", (0.80, 0.87), "GBP paper (NeurIPS'20): 0.839"),
    "gbp_citeseer": (run_gbp_citeseer, "test acc", (0.69, 0.76), "GBP paper (NeurIPS'20): 0.729"),
    "nas_cora": (
        run_nas_cora, "best acc", (0.75, 0.88),
        "PaSca (WWW'22) search space on cora: discovered archs ~0.83; "
        "20-trial smoke bands generously below the 3500-trial result",
    ),
    "dist_sgc_pubmed": (
        run_dist_sgc_pubmed, "test acc", (0.77, 0.82), "same SGC band through the distributed runtime",
    ),
}


def main(workloads=None, root: str = "./data/", epochs: int = 200, split: str = "official",
         check_bands: bool = True, device=None):
    """Run the selected workloads on ``device`` (default: the GPU); return
    ``[(name, metric, value, in_band)]``, ``value`` None where the dataset
    could not be had.  ``split``, ``epochs`` and ``check_bands`` let small
    fixtures drive the same flow; the defaults are the shipped settings."""
    rows = []
    for name in workloads or list(WORKLOADS):
        runner, metric, (lo, hi), _provenance = WORKLOADS[name]
        try:
            value = float(runner(root, epochs=epochs, split=split, device=device))
        except IOError as exc:  # dataset unreachable: report it and go on
            print(f"[{name}] dataset unavailable: {exc}")
            rows.append((name, metric, None, None))
            continue
        rows.append((name, metric, value, (lo <= value <= hi) if check_bands else None))
    width = max(len(n) for n, *_ in rows)
    print(f"{'workload':<{width}}  {'metric':<9} {'value':>7}  band          verdict")
    for name, metric, value, in_band in rows:
        lo, hi = WORKLOADS[name][2]
        if value is None:
            verdict, shown = "NO DATA", "      -"
        else:
            verdict = "-" if in_band is None else ("PASS" if in_band else "FAIL")
            shown = f"{value:>7.4f}"
        print(f"{name:<{width}}  {metric:<9} {shown}  [{lo:.2f}, {hi:.2f}]  {verdict}")
    return rows


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default="./data/")
    ap.add_argument("--workloads", nargs="+", choices=list(WORKLOADS), default=None)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--no-check", action="store_true", help="report values without band verdicts")
    ap.add_argument("--allow-missing", action="store_true",
                    help="exit 0 even when some datasets could not be had (by default a NO DATA row "
                         "fails the run when the bands are checked)")
    args = ap.parse_args(argv)
    results = main(workloads=args.workloads, root=args.root, epochs=args.epochs, check_bands=not args.no_check,
                   device=args.device)
    failed = any(in_band is False for *_, in_band in results)
    missing = any(value is None for _, _, value, _ in results)
    return 1 if failed or (missing and not args.no_check and not args.allow_missing) else 0


if __name__ == "__main__":
    sys.exit(cli())
