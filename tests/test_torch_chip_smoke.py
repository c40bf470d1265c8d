"""The host-side helpers of ``chip_smoke.py`` that need no card."""

import sys

import numpy as np
import pytest
import torch

from chip_smoke import (
    GRAPH_STEPS,
    LABEL_WIDTHS,
    NARS_MODEL,
    NAS_OGB,
    NAS_SMALL_ARCHS,
    csr_bound,
    expected_hetero_launches,
    expected_nas_launches,
    expected_label_launches,
    expected_ooc_launches,
    kernels_line,
    nafs_bound,
    ptxas_summary,
    segment_bound,
)
from sgl_tpu_torch.datasets import random_power_law_graph
from sgl_tpu_torch.dev.ooc_probe import busy_ms
from sgl_tpu_torch.graph import symmetric_normalized_weights_host
from sgl_tpu_torch.kernels import (
    prepare_out_of_core,
    prepare_out_of_core_2d,
    spmm_2d_resident,
    spmm_out_of_core,
    spmm_out_of_core_2d,
)
from sgl_tpu_torch.kernels.segment_reduce import INSTANTIATIONS

# ``nvcc -Xptxas -v`` output for two entries of the CSR kernel, one of them
# spilling, with a device function's properties in between
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__8bed0cad_11_spmm_csr_cu_b44ff5c715spmm_csr_kernelI13__nv_bfloat16fLi4ELb1EEEvPKiS3_PKfPKT_PT0_ll' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__8bed0cad_11_spmm_csr_cu_b44ff5c715spmm_csr_kernelI13__nv_bfloat16fLi4ELb1EEEvPKiS3_PKfPKT_PT0_ll
    24 bytes stack frame, 36 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 24 bytes cumulative stack size
ptxas info    : Compile time = 52.967 ms
ptxas info    : Function properties for helper
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__8bed0cad_11_spmm_csr_cu_b44ff5c715spmm_csr_kernelIffLi4ELb0EEEvPKiS3_PKfPKT_PT0_ll' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__8bed0cad_11_spmm_csr_cu_b44ff5c715spmm_csr_kernelIffLi4ELb0EEEvPKiS3_PKfPKT_PT0_ll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 32768 bytes smem, 424 bytes cmem[0]
"""


def test_ptxas_summary_reads_registers_and_spills_per_entry():
    assert ptxas_summary(PTXAS_LOG) == [
        "spmm_csr_kernel<13__nv_bfloat16fLi4ELb1E>: 32 registers, 0 B static shared memory, "
        "spill 36 B stored / 40 B loaded",
        "spmm_csr_kernel<ffLi4ELb0E>: 48 registers, 32768 B static shared memory, "
        "spill 0 B stored / 0 B loaded",
    ]
    assert ptxas_summary("nvcc: nothing compiled\n") == []


def _meta(rows, cols, dtype):
    return torch.empty(rows, cols, dtype=dtype, device="meta")


@pytest.mark.parametrize("key,nbytes", [
    # 4(N+1) + E*W*s_m + E*s_w + N*D*4 (+ N*D*4 read back when accumulating)
    ("bf16_acc", 1_536_795_396), ("bf16_hilo", 2_765_590_788), ("f32", 2_765_590_788),
    ("bf16_hilo_w2", 2_786_390_716), ("f32_w2", 2_786_390_716), ("bf16_w", 1_444_795_360),
])
def test_segment_bound_counts_the_bench_shape_bytes(key, nbytes):
    n, e, d = 200_000, 5_199_982, 128
    dtype, halves, n_w, accumulate, _ = INSTANTIATIONS[key]
    w = _meta(e, 1, torch.bfloat16)[:, 0]
    kw = dict(halves=halves, wh=w if n_w >= 1 else None, wl=w if n_w == 2 else None)
    b = segment_bound(_meta(e, halves * d, dtype), kw, n, d, accumulate)
    assert b["nbytes"] == nbytes and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_kernels_line_lists_every_instantiation_with_every_key():
    r = dict(abs_err=0.0, rel_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes", library_ms=None)
    two = {"f32": dict(r), "bf16": dict(r)}
    products = {k: dict(r, launches=30) for k in ("f32", "bf16")}
    dev_results = {k: dict(r) for k in [*INSTANTIATIONS, "gather_sum"]}
    dev_launches = {k: 1 for k in dev_results}
    zoo = {"f32": 24, "bf16": 3, "fixup_f32": 24, "fixup_bf16": 3}
    probe = dict(ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes", library_ms=3.0)
    label = dict(launches=292, fixup_launches=292, widths={d: dict(probe, max_abs_err=0.0, max_rel_err=0.0)
                                                           for d in LABEL_WIDTHS},
                 gradient={"forward": dict(probe), "backward": dict(probe, launches=1)},
                 multi=dict(per_r_ms=1.0, multi_ms=1.1, gather_ms=9.0, bound_ms=0.2, per_r_bound_ms=0.21))
    at_batch = {k: dict(probe, max_abs_err=0.0, max_rel_err=0.0) for k in ("f32", "bf16")}
    hetero = dict(launches={"f32": 9, "bf16": 3, "fixup_f32": 0, "fixup_bf16": 0},
                  times={"nars": at_batch, "graph": at_batch})
    form = dict(probe, launches=40, fixup_launches=20, hop_s=0.5, max_abs_err=0.0, max_rel_err=0.0)
    ooc = dict(products={"1d f32": dict(form, key="f32"), "2d f32": dict(form, key="f32"),
                         "2d bf16": dict(form, key="bf16", launches=20)},
               papers=dict(launches=3, fixup_launches=3, peak_bytes=1))
    nas = dict(launches=210, fixup_launches=210)
    work = {k: dict(probe, launches=112, fixup_launches=0, hop_ms=2.0, max_abs_err=0.0, max_rel_err=0.0)
            for k in ("f32", "bf16")}
    dist = dict(work=work, ring_launches={"f32": {"gloo (1, 2) GAMLP f32": [[6, 3], [6, 3]]},
                                          "bf16": {"gloo (1, 2) SGC bf16": [[6, 3], [6, 3]]}})
    shape = dict(probe, n=10, nnz=40, d=602, launches=5, max_abs_err=0.0, max_rel_err=0.0, write_s=9.0, panel=32,
                 library_ratio=0.5)
    loaders = dict(launches=77, reddit=dict(shape), flickr=dict(shape, d=500, max_rel_err=0.125))
    plot = dict(launches=3, fixup_launches=0)
    line = kernels_line(two, {"f32": 3, "bf16": 3}, {"f32": (0, 0, 0), "bf16": (0, 0, 0)}, two, products,
                        dev_launches, dev_results, zoo, label, hetero, ooc, nas, dist, loaders, plot)
    kernels = line["kernels"]
    # phase 14's on K1 alone: NAFS's hops before the clustering plot
    assert (kernels[0]["plot_launches"], kernels[0]["plot_fixup_launches"]) == (3, 0)
    assert all("plot_launches" not in k for k in kernels[1:])
    # phase 13's on K1 alone: the loaders' launches, K1 at Reddit's and Flickr's shapes
    assert kernels[0]["loader_launches"] == 77 and "loader_launches" not in kernels[1]
    assert kernels[0]["shapes"]["reddit"]["d"] == 602 and kernels[0]["shapes"]["flickr"]["d"] == 500
    assert kernels[0]["shapes"]["reddit"]["panel"] == 32 and kernels[0]["shapes"]["reddit"]["library_ratio"] == 0.5
    assert "write_s" not in kernels[0]["shapes"]["reddit"] and kernels[0]["max_rel_err"] == 0.125
    # phase 12's on K3 and K4: each run's ring launches a rank, and the bucket work
    assert kernels[2]["ring_launches"] == {"gloo (1, 2) GAMLP f32": [[6, 3], [6, 3]]}
    assert kernels[3]["ring_work"]["hop_ms"] == 2.0 and "ring_work" not in kernels[0]
    assert kernels[2]["ring_replaces"] == ["sgl_tpu/parallel/spmm_dist.py:777", "sgl_tpu/parallel/spmm_dist.py:132"]
    # phase 11's, NAS, on K1 alone
    assert (kernels[0]["nas_launches"], kernels[0]["nas_fixup_launches"]) == (210, 210)
    assert all("nas_launches" not in k for k in kernels[1:])
    # phase 10's on K3 and K4: each out-of-core form's launches a hop, with its times
    k3, k4 = kernels[2], kernels[3]
    assert k3["name"] == "spmm_csr_acc_f32" and k4["name"] == "spmm_csr_acc_bf16"
    assert k3["ooc_launches"] == {"1d f32": [40, 20], "2d f32": [40, 20], "papers100m pipeline": [3, 3]}
    assert k4["ooc_launches"] == {"2d bf16": [20, 20]} and k4["ooc"]["2d bf16"]["hop_s"] == 0.5
    assert k3["papers100m"]["peak_bytes"] == 1 and "papers100m" not in k4
    # each out-of-core form's kernel-vs-twin error counts toward its row's
    ooc["products"]["2d bf16"]["max_rel_err"] = 0.25
    assert kernels_line(two, {"f32": 3, "bf16": 3}, {"f32": (0, 0, 0), "bf16": (0, 0, 0)}, two, products,
                        dev_launches, dev_results, zoo, label, hetero, ooc, nas, dist,
                        loaders, plot)["kernels"][3]["max_rel_err"] == 0.25
    # phase 9's on K1 and K2, with their times at the NARS and graph-level batches
    assert [(k["hetero_launches"], k["hetero_fixup_launches"]) for k in kernels[:2]] == [(9, 0), (3, 0)]
    assert all(k["nars_batch"]["ms"] == 1.0 and k["graph_batch"]["bound_by"] == "bytes" for k in kernels[:2])
    assert "hetero_launches" not in kernels[2]
    # phase 7's launches of the CSR kernel sit beside the main path's
    assert [(k["zoo_launches"], k["zoo_fixup_launches"]) for k in kernels[:2]] == [(24, 24), (3, 3)]
    # phase 8's on K1 (f32) alone, with its label widths and its gradient
    assert kernels[0]["label_launches"] == 292 and "label_launches" not in kernels[1]
    assert set(kernels[0]["label_widths"]) == {"3", "47", "64"}
    assert kernels[0]["gradient"]["backward"]["launches"] == 1
    assert kernels[0]["nafs_product"]["per_r_ms"] == 1.0
    assert len(kernels) == 11 and len({k["name"] for k in kernels}) == 11
    for k in kernels:
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms"} <= set(k), k
        assert k["route"] == "cuda" and k["launches"] > 0
    assert {k["replaces"].split(":")[0] for k in kernels[4:]} == {
        "dev/exp_acc_alias.py", "dev/exp_spmm.py", "dev/exp_gather_dma.py"}


def test_expected_label_launches_follow_the_task_settings():
    """C&S: SGC(3)'s 3 hops, 10 correct and 10 smooth layers; label reuse:
    SGC(2) on the first features, on each of 12 epochs, and once more on
    each of the 6 epochs after the 5th; NAFS: hops 1..19 for six r; GAE:
    SGC(3) on the training graph."""
    assert expected_label_launches() == {
        "C&S": 23, "label reuse": 38, "predictor": 0, "NAFS clustering": 114,
        "NAFS link prediction": 114, "GAE": 3,
    }


def test_nafs_bound_counts_one_wide_pass():
    n, e, r, d = 100_000, 2_099_010, 6, 128
    b = nafs_bound(n, e, r, d)
    assert b["nbytes"] == 4 * (n + 1) + 4 * e + 4 * e * r + 2 * n * r * d * 4
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["nbytes"] / 3.35e12 * 1e3)


def test_expected_hetero_launches_are_one_propagation_each_without_fixups():
    """Each run propagates one block-diagonal batch: ``prop_steps``
    products of the f32 kernel (the bf16 one for GraphSGC), and no row of
    these graphs is long enough for the fix-up."""
    k, kg = NARS_MODEL["prop_steps"], GRAPH_STEPS
    assert (k, kg) == (3, 3)
    none = {"f32": 0, "bf16": 0}
    assert expected_hetero_launches() == {
        "Fast NARS": dict(launches={"f32": 3, "bf16": 0}, fixups=none),
        "NARS_SIGN": dict(launches={"f32": 3, "bf16": 0}, fixups=none),
        "GraphSIGN": dict(launches={"f32": 3, "bf16": 0}, fixups=none),
        "GraphSGC bf16": dict(launches={"f32": 0, "bf16": 3}, fixups=none),
    }


@pytest.mark.parametrize("elem", [4, 2])
def test_csr_bound_counts_one_pass_of_the_batch(elem):
    n, e, d = 1_248_000, 29_548_000, 128
    b = csr_bound(n, e, d, elem)
    assert b["nbytes"] == 4 * (n + 1) + 8 * e + 2 * n * d * elem
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["nbytes"] / 3.35e12 * 1e3)


@pytest.mark.parametrize("layout", ["1d", "2d", "resident"])
def test_expected_ooc_launches_count_what_a_hop_launches(monkeypatch, layout):
    """The launch counts phase 10 holds each out-of-core hop to, worked out
    from the layout, equal the accumulating launches (and fix-ups, for the
    parts or cells with a long row) that one hop makes."""
    ooc = sys.modules["sgl_tpu_torch.kernels.spmm_ooc"]
    calls = []
    real = ooc.spmm_csr_acc
    monkeypatch.setattr(ooc, "spmm_csr_acc", lambda part, x, acc: calls.append(part.plan.num_long > 0)
                        or real(part, x, acc))
    adj = symmetric_normalized_weights_host(random_power_law_graph(3_000, 8, 8, seed=0))
    x = torch.as_tensor(random_power_law_graph(3_000, 8, 8, seed=0).x)
    if layout == "1d":
        oc = prepare_out_of_core(adj, max_edges_per_part=2048)
        spmm_out_of_core(oc, x, device="cpu")
    else:
        oc = prepare_out_of_core_2d(adj, max_edges_per_part=2048, src_blocks=3, feat_dim=8)
        if layout == "2d":
            spmm_out_of_core_2d(oc, x, device="cpu", max_device_acc_bytes=1)  # a part a group
        else:
            spmm_2d_resident(oc, x)
    launches, fixups = expected_ooc_launches(oc)
    assert launches == len(calls) > 1 and fixups == sum(calls) > 0


def test_busy_ms_is_the_union_of_intervals():
    assert busy_ms([]) == 0.0
    assert busy_ms([(0, 1000), (500, 1500), (3000, 4000)]) == pytest.approx(2.5)
    assert busy_ms([(0, 4000), (1000, 2000)]) == pytest.approx(4.0)


def _cfg(post_steps, post_types=1):
    return dict(prop_steps=2, prop_types=1, mesg_types=0, num_layers=1, post_steps=post_steps,
                post_types=post_types, pmsg_types=0)


@pytest.mark.parametrize("split_rows", [True, False])
def test_expected_nas_launches_are_hops_computed_plus_post_steps(split_rows):
    """The cache's hops computed plus each post-propagating trial's post
    steps (a trial without a post graph op adds none), and as many fix-ups
    when the graph's plan has split rows."""
    from sgl_tpu_torch.search import History, PropagationCache

    history = History()
    for cfg in (_cfg(3), _cfg(1), _cfg(0), _cfg(4, post_types=0), _cfg(10)):
        history.add(cfg, [-0.5, 0.1], 1.0)
    cache = PropagationCache()
    cache.hops_computed = 17
    assert expected_nas_launches(history, cache, split_rows) == (31, 31 if split_rows else 0)


def test_expected_nas_launches_count_what_a_search_launches(monkeypatch):
    """On the CPU, with every product of the search counted by hand: a
    short run of the seeded evolutionary search launches what the formula
    says (pre-hops through the cache, then each trial's post-propagation)."""
    from sgl_tpu_torch.datasets import PlantedPartition
    from sgl_tpu_torch.search import ConfigManager, run_nas

    mod = sys.modules["sgl_tpu_torch.kernels.spmm_csr"]
    real = mod.spmm_csr
    calls = []
    monkeypatch.setattr(mod, "spmm_csr", lambda adj, x: calls.append(mod._plan(adj).num_long > 0)
                        or real(adj, x))
    ds = PlantedPartition(num_nodes=150, feat_dim=8, seed=1)
    configer = ConfigManager([2, 1, 1, 2, 3, 1, 0], prop_steps=(1, 4), num_layers=(1, 2))
    configer._setParameters(ds, "cpu", 8, epochs=2, lr=0.01, wd=5e-4, restarts=1)
    history = run_nas(configer, max_runs=6, seed=1, verbose=False)
    launches, fixups = expected_nas_launches(history, configer._prop_cache, any(calls))
    assert launches == len(calls) > 6 and fixups == sum(calls)


def test_nas_phase_settings():
    """ogbn-arxiv's published shape; the small graph's archs cover every
    message type, post message type and graph-op type."""
    assert (NAS_OGB["num_nodes"], NAS_OGB["num_edges"], NAS_OGB["feat_dim"], NAS_OGB["num_classes"]) == (
        169_343, 1_166_243, 128, 40)
    assert sum(NAS_OGB["split"]) == NAS_OGB["num_nodes"]
    assert sorted(a[2] for a in NAS_SMALL_ARCHS) == list(range(9))
    assert set(a[6] for a in NAS_SMALL_ARCHS) == set(range(6))
    assert set(a[1] for a in NAS_SMALL_ARCHS) == {1, 2, 3, 4} and all(a[4] and a[5] for a in NAS_SMALL_ARCHS)


def test_write_ogb_raw_at_a_small_shape(tmp_path):
    """The raw files phase 11 writes load through ``Ogbn`` with the
    written edges, labels and split (at a small shape)."""
    from chip_smoke import write_ogb_raw
    from sgl_tpu_torch.datasets import Ogbn
    from sgl_tpu_torch.datasets.utils import undirect_and_clean

    shape = dict(NAS_OGB, num_nodes=500, num_edges=2000, split=(250, 100, 150))
    raw = write_ogb_raw(str(tmp_path), shape)
    ds = Ogbn("arxiv", str(tmp_path))
    assert raw["edges"].shape == (2000, 2) and ds.num_node == 500 and ds.num_classes <= 40
    s, d = undirect_and_clean(raw["edges"][:, 0], raw["edges"][:, 1])
    assert ds.graph.num_edges == s.shape[0]
    assert np.array_equal(ds.y, raw["y"]) and np.array_equal(ds.val_idx, raw["split"]["valid"])
    np.testing.assert_allclose(ds.x, raw["x"], rtol=1e-5, atol=1e-5)


def test_bucket_bytes_count_one_accumulating_launch():
    """A ring bucket's compulsory bytes: the row pointer, col and val, each
    source row a nonzero reads once, each non-empty f32 row read and written
    once; an empty row and an unread source row cost nothing."""
    import torch

    from chip_smoke import bucket_bytes
    from sgl_tpu_torch.kernels import CsrPart

    rowptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    part = CsrPart(rowptr, torch.zeros(5, dtype=torch.int32), torch.ones(5), 0, 3, 3)
    # two non-empty rows, one source row (column 0)
    assert bucket_bytes(part, 8, 4) == 4 * 4 + 8 * 5 + 1 * 8 * 4 + 2 * 2 * 8 * 4
    assert bucket_bytes(part, 8, 2) == 4 * 4 + 8 * 5 + 1 * 8 * 2 + 2 * 2 * 8 * 4
    # the same rows reading columns 0, 2 and 2 again: two source rows
    part = CsrPart(rowptr, torch.tensor([0, 2, 2, 0, 2], dtype=torch.int32), torch.ones(5), 0, 3, 3)
    assert bucket_bytes(part, 8, 4) == 4 * 4 + 8 * 5 + 2 * 8 * 4 + 2 * 2 * 8 * 4


def test_first_step_check_holds_adam_and_finds_the_rounding_flip():
    """Adam's first step from the same parameters on gradients a rounding
    apart: the parameters agree where |g + wd·p| is clear of eps and the
    rounding, the one element where it is not differs most, and a wrong
    weight decay fails the replay (on the units with no gradient)."""
    import torch

    from chip_smoke import first_step_check
    from sgl_tpu_torch.tasks.utils import adam_l2

    rng = np.random.default_rng(0)
    lr, wd = 0.1, 5e-5
    p0 = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    g = (rng.standard_normal((64, 32)) * 1e-3).astype(np.float32)
    g[0, :8] = 0  # dead units: g + wd·p = wd·p
    g[1, 0] = np.float32(-wd * float(p0[1, 0]))  # g + wd·p within a rounding of 0

    def step(grad, weight_decay=wd):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = adam_l2([p], lr, weight_decay)
        p.grad = torch.from_numpy(grad.copy())
        opt.step()
        return {"params_before": {"w": p0}, "grads": {"w": grad}, "params": {"w": p.detach().numpy().copy()}}

    base = step(g)
    g_run = (g * np.float32(1 + 1e-6)).astype(np.float32)
    g_run[1, 0] += np.float32(1e-9)  # a rounding of the largest gradients, a tenth of eps
    c = first_step_check(base, step(g_run), lr, wd)
    assert c["start_err"] == 0 and c["grad_err"] <= 1e-5 and c["replay_err"] <= 1e-5 and c["held_err"] <= 1e-5
    assert 0.9 * c["total"] < c["held"] < c["total"] == g.size
    assert c["worst"]["rel"] > 1e-3 and abs(c["worst"]["g_l2"][0]) < 1e-9
    assert first_step_check(base, step(g_run, 2 * wd), lr, wd)["replay_err"] > 1e-4


def test_dist_runs_cover_every_backend_and_ring_size():
    """Phase 12's runs: NCCL alone, gloo at two and four ranks; the ring at
    P = 1, 2 and 4; GAMLP in every run, so the first steps compare."""
    from chip_smoke import DIST_GAMLP, DIST_RUNS

    assert [(w, m, b) for _, w, m, b, _ in DIST_RUNS] == [(1, (1, 1), "nccl"), (2, (1, 2), "gloo"),
                                                          (4, (2, 2), "gloo")]
    rings = {tuple(r.get("mesh", m))[1] for _, _, m, _, runs in DIST_RUNS for r in runs}
    assert rings == {1, 2, 4}
    assert all(DIST_GAMLP in runs for *_, runs in DIST_RUNS)


def _counting(fn, counts, fixups, key_of):
    """``fn`` counting a launch (and a fix-up for a plan with long rows)
    where the card's kernel would launch: the CPU launches nothing."""
    from sgl_tpu_torch.kernels.spmm_csr import _plan

    def wrapped(adj, x, *rest):
        key = key_of(x)
        counts[key] += 1
        if _plan(adj).num_long:
            fixups[key] += 1
        return fn(adj, x, *rest)
    return wrapped


def test_loaders_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 13 on the CPU at small shapes, the card's control flow: every
    check holds but those that the work ran on the card.  One intra-op
    thread: torch's spinning thread pools, eight in each of the tier-1
    run's six workers, slow every worker many times over when they meet."""
    import chip_smoke as cs
    from sgl_tpu_torch.examples import (
        gamlp_products,
        graph_classification,
        hetero_nars,
        nafs_link_predict,
        nafs_node_cluster,
        papers100m_pipeline,
        sgc_pubmed,
    )
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr, spmm_ooc
    from sgl_tpu_torch.kernels.spmm_csr import spmm_csr
    from sgl_tpu_torch.tasks import node_clustering

    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    failures = []
    monkeypatch.setattr(cs, "check", lambda ok, msg: ok or failures.append(str(msg)))
    monkeypatch.setattr(cs, "time_ms", lambda fn, warmup=3, iters=20, device=None: (fn(), 1.0)[1])
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    for mod in (sgc_pubmed, gamlp_products, hetero_nars, graph_classification, nafs_link_predict,
                nafs_node_cluster, papers100m_pipeline):
        monkeypatch.setattr(mod, "resolve_device", lambda device=None: cpu)
    counts, fixups = spmm_csr.launches, spmm_csr.fixup_launches
    # the module, which the package's function of the same name hides
    monkeypatch.setattr(sys.modules["sgl_tpu_torch.kernels.spmm_csr"], "spmm_csr", _counting(
        spmm_csr, counts, fixups, lambda x: "bf16" if x.dtype == torch.bfloat16 else "f32"))
    # NAFS as on the card: a CSR layout, whose products reach spmm_csr
    monkeypatch.setattr(node_clustering, "_layout", lambda graph, r, device: prepare_csr(
        symmetric_normalized_weights(graph, r=r, device=device)))
    monkeypatch.setattr(spmm_ooc, "spmm_csr_acc", _counting(
        spmm_ooc.spmm_csr_acc, counts, fixups, lambda x: "acc_bf16" if x.dtype == torch.bfloat16 else "acc_f32"))
    monkeypatch.setattr(cs, "LOADER_SMALL", dict(num_nodes=120, num_features=8, num_classes=3, avg_degree=4))
    monkeypatch.setattr(cs, "REDDIT_SHAPE", dict(num_nodes=3_000, nnz=40_000, num_features=602, num_classes=41,
                                                 split=(1_976, 307, 717)))
    monkeypatch.setattr(cs, "FLICKR_SHAPE", dict(num_nodes=2_000, nnz=16_000, num_features=500, num_classes=7,
                                                 split=(1_000, 500, 500)))
    monkeypatch.setattr(cs, "REDDIT_F64_ROWS", 64)
    monkeypatch.setattr(cs, "REDDIT_PLAIN_BLOCKS", 4)
    monkeypatch.setattr(cs, "EXAMPLE_EPOCHS", 2)
    monkeypatch.setattr(cs, "EXAMPLE_PUBMED", dict(num_nodes=1_600, num_features=60, num_edges=3_000))
    monkeypatch.setattr(cs, "PAPERS_DATA", dict(NAS_OGB, num_nodes=2_000, num_edges=9_000, feat_dim=16,
                                                num_classes=6, split=(1_000, 400, 600)))
    monkeypatch.setattr(cs, "PAPERS_ARGS", ["--epochs", "1", "--batch", "500", "--part-edges", "4096",
                                            "--src-blocks", "2"])
    try:
        out = cs.loaders_phase(cpu)
    finally:
        torch.set_num_threads(threads)
    assert failures and all("not on the card" in f for f in failures), [f for f in failures
                                                                        if "not on the card" not in f]
    # the smoke's every step ran: 17 loaders, both shapes, 3 backends, 7 examples
    assert sorted(out["small"]) == sorted(cs.raw_files.LOADERS)
    assert out["reddit"]["stored_nnz"] == 40_000 and out["reddit"]["runs"]["GAMLP"]["launches"] == 3
    assert out["reddit"]["launches"] == 5 and all(k in out[n] for n in ("reddit", "flickr") for k in cs.SHAPE_KEYS)
    assert out["flickr"]["launches"] == 2 and out["flickr"]["bound_by"] in ("bytes", "operations")
    assert out["backend"]["launches"] == {"auto": 1, "segment": 0}
    assert len(out["examples"]) == 7 and out["examples"]["papers100m_pipeline --data"]["kernel"] == "acc_f32"
    assert out["launches"] >= 2 * 17
    assert "refused by the stub" in capsys.readouterr().out


def test_plot_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 14 on the CPU at a small Planetoid shape (400 nodes), the
    card's control flow: NAFS's products reach a counting ``spmm_csr``, the
    t-SNE runs in full; every check holds but those that the work ran on
    the card."""
    import chip_smoke as cs
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr
    from sgl_tpu_torch.kernels.spmm_csr import spmm_csr
    from sgl_tpu_torch.tasks import node_clustering

    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    failures = []
    monkeypatch.setattr(cs, "check", lambda ok, msg: ok or failures.append(str(msg)))
    monkeypatch.setattr(cs, "smi_line", lambda: "a card, 700.00 W")
    monkeypatch.setattr(cs, "time_ms", lambda fn, warmup=3, iters=20, device=None: (fn(), 1.0)[1])
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    counts, fixups = spmm_csr.launches, spmm_csr.fixup_launches
    monkeypatch.setattr(sys.modules["sgl_tpu_torch.kernels.spmm_csr"], "spmm_csr",
                        _counting(spmm_csr, counts, fixups, lambda x: "f32"))
    monkeypatch.setattr(node_clustering, "_layout", lambda graph, r, device: prepare_csr(
        symmetric_normalized_weights(graph, r=r, device=device)))
    monkeypatch.setattr(cs, "PLOT_PUBMED", dict(num_nodes=400, num_features=32, num_edges=800, num_test=100))
    monkeypatch.setattr(cs, "PLOT_CHECK_ROWS", 64)
    monkeypatch.setattr(cs, "PLOT_TRUST_ROWS", 150)
    try:
        out = cs.plot_phase(cpu)
    finally:
        torch.set_num_threads(threads)
    assert failures and all("not on the card" in f for f in failures), [f for f in failures
                                                                        if "not on the card" not in f]
    assert (out["launches"], out["iterations"]) == (cs.PLOT_HOPS, 1000)
    assert out["p_err"] <= cs.PLOT_P_TOL and out["grad_errs"]["init"]["net"] <= cs.PLOT_GRAD_TOL
    assert out["grad_errs"]["final"]["terms"] <= cs.PLOT_GRAD_TOL
    assert out["kl"] < out["kl_after_exploration"] and 0.5 < out["trustworthiness"] <= 1.0
    assert len(out["inked"]) == 3 and min(out["inked"].values()) > 0
    assert "[14] a card, 700.00 W" in capsys.readouterr().out
