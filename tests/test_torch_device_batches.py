"""The task loop's batches built on the device
(``sgl_tpu_torch.tasks.node_classification._batches`` in an epoch's
``_order``) are ``batch_iterator``'s, element for element, with the same
draws from the generator; and a job on them, whose steps' results are read
twice an epoch, gives to the bit what the loop over ``batch_iterator`` with
a read after every batch gave: in ``NodeClassification``, in
``NodeClassificationWithLabelUse`` (label use and label reuse) and in
``HeteroNodeClassification``, each held to its own old loop."""

import time

import numpy as np
import pytest
import torch

from sgl_tpu_torch.datasets import SyntheticHeteroDataset
from sgl_tpu_torch.datasets.synthetic import PlantedPartition
from sgl_tpu_torch.models import GAMLP, NARS_SIGN
from sgl_tpu_torch.tasks import HeteroNodeClassification, NodeClassification, NodeClassificationWithLabelUse
from sgl_tpu_torch.tasks.node_classification import _batches, _order, _sync
from sgl_tpu_torch.tasks.utils import (
    adam_l2,
    add_labels,
    batch_iterator,
    make_eval_step,
    make_logits_fn,
    make_train_step,
    set_seed,
)
from sgl_tpu_torch.utils.hop_store import HostHops

EPOCHS = 3


@pytest.mark.parametrize("n, batch_size, shuffle", [
    (10, 4, True),  # a wrapped tail, shuffled
    (10, 4, False),  # a wrapped tail, in order
    (12, 4, True),  # whole batches
    (7, 1, True),
    (10, None, True),  # full batch: no draw
    (10, 10, True),
    (10, 15, False),
    (0, None, False),  # an empty split: one empty batch
], ids=["wrap-shuffled", "wrap-ordered", "whole", "one-row", "none", "equal-n", "over-n", "empty"])
@pytest.mark.parametrize("host", [False, True], ids=["device", "host-store"])
def test_device_batches_are_batch_iterators(n, batch_size, shuffle, host):
    idx = np.random.default_rng(5).permutation(1000)[:n]
    rng, want_rng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(EPOCHS):
        order = _order(n, batch_size, rng, torch.device("cpu")) if shuffle else None
        got = list(_batches(torch.as_tensor(idx), batch_size, order, idx if host else None))
        want = list(batch_iterator(idx, batch_size, shuffle, want_rng))
        assert len(got) == len(want)
        for (b, w, kept, fb), (b_want, w_want) in zip(got, want):
            assert b.dtype == torch.int64 and w.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), b_want)
            np.testing.assert_array_equal(w.numpy(), w_want)
            assert kept == float(w_want.sum())
            if host:
                assert isinstance(fb, np.ndarray)
                np.testing.assert_array_equal(fb, b_want)
            else:
                assert fb is b
    assert rng.bit_generator.state == want_rng.bit_generator.state


class _ReadEveryBatch(NodeClassification):
    """The task loop as it was before its batches moved to the device: the
    batches of ``batch_iterator`` uploaded one by one, each step's loss and
    accuracy and each eval batch's sums read as it ends."""

    def _execute(self) -> float:
        ds, model, device = self._dataset, self._model, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        np_rng = np.random.default_rng(self._seed)
        model.preprocess(ds.graph, ds.x, dtype=self._precompute_dtype, device=device)
        labels = ds.to_device(device).y
        train_idx, val_idx, test_idx = (np.asarray(i) for i in (ds.train_idx, ds.val_idx, ds.test_idx))
        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        optimizer = adam_l2(net.parameters(), self._lr, self._weight_decay)
        train_step = make_train_step(net, optimizer, self._loss_fn)
        eval_step = make_eval_step(net)

        def eval_on(idx):
            correct, total = 0.0, 0.0
            for b_idx, w in batch_iterator(idx, self._eval_batch_size, shuffle=False, rng=np_rng):
                b = torch.as_tensor(b_idx, device=device)
                c, t = eval_step(model.batch_input(b), labels[b], torch.as_tensor(w, device=device))
                correct += float(c)
                total += float(t)
            return correct / max(total, 1.0)

        best_val, best_test = 0.0, 0.0
        for _ in range(self._epochs):
            t = time.perf_counter()
            losses, accs, weights = [], [], []
            for b_idx, w in batch_iterator(train_idx, self._train_batch_size, shuffle=True, rng=np_rng):
                b = torch.as_tensor(b_idx, device=device)
                loss, acc = train_step(model.batch_input(b), labels[b], torch.as_tensor(w, device=device),
                                       dropout_gen)
                losses.append(float(loss))
                accs.append(float(acc))
                weights.append(float(w.sum()))
            self.epoch_seconds.append(time.perf_counter() - t)
            self.train_losses.append(float(np.average(losses, weights=weights)))
            acc_val, acc_test = eval_on(val_idx), eval_on(test_idx)
            self.epoch_accuracies.append((float(np.average(accs, weights=weights)), acc_val, acc_test))
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test
                self._on_best(net)
        acc_val, acc_test = self._postprocess(net, labels, val_idx, test_idx)
        return acc_test if acc_val > best_val else best_test


@pytest.fixture(scope="module")
def ds():
    d = PlantedPartition(num_nodes=300, feat_dim=16, p_in=0.08, seed=3)
    assert (len(d.train_idx), len(d.val_idx), len(d.test_idx)) == (90, 60, 150)
    return d


def _gamlp(ds, host_store: bool):
    model = GAMLP(prop_steps=3, feat_dim=ds.num_features, output_dim=ds.num_classes, hidden_dim=16,
                  num_layers=2, dropout=0.5)
    if host_store:
        model.preprocess(ds.graph, ds.x, device="cpu")
        model.attach_host_hops(HostHops([h.numpy() for h in model.processed_feature], device="cpu"))
    return model


@pytest.mark.parametrize("train_batch, eval_batch, host_store", [
    (32, 50, False),  # 3 train batches, a wrapped tail in each split
    (None, None, False),  # full batch
    (32, 50, True),  # a host hop store, given host indices
], ids=["mini-batch", "full-batch", "host-store"])
def test_a_job_reads_twice_an_epoch_what_a_read_every_batch_gave(ds, train_batch, eval_batch, host_store):
    kw = dict(lr=0.01, weight_decay=5e-5, epochs=EPOCHS, device="cpu", seed=7, train_batch_size=train_batch,
              eval_batch_size=eval_batch, verbose=False)
    got = NodeClassification(ds, _gamlp(ds, host_store), **kw)
    want = _ReadEveryBatch(ds, _gamlp(ds, host_store), **kw)
    assert len(got.train_losses) == EPOCHS
    assert got.train_losses == want.train_losses
    assert got.epoch_accuracies == want.epoch_accuracies
    assert got.test_acc == want.test_acc


def _reuse_labels_read_every_batch(model, net, graph, features, unlabeled, num_classes, device, batch_size=None):
    pred = make_logits_fn(net, batch_size, model.row_dim)(model.processed_feature)
    soft = torch.softmax(pred, dim=-1).cpu().numpy()
    features[unlabeled, -num_classes:] = soft[unlabeled]
    model.preprocess(graph, features, device=device)


class _LabelUseReadEveryBatch(NodeClassificationWithLabelUse):
    """``NodeClassificationWithLabelUse``'s loop before it shared the task
    loop: the batches of ``batch_iterator`` uploaded one by one, each
    step's results and each eval batch's sums read as it ends; its records
    kept as the shared loop keeps them."""

    def _execute(self) -> float:
        ds, model, device = self._dataset, self._model, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        np_rng = np.random.default_rng(self._seed)
        labels_np = np.asarray(ds.y).reshape(-1)
        labels = torch.as_tensor(labels_np, dtype=torch.int64, device=device)
        train_idx = np.asarray(ds.train_idx)
        val_idx = np.asarray(ds.val_idx)
        test_idx = np.asarray(ds.test_idx)
        num_classes = ds.num_classes

        features0 = (
            add_labels(ds.x, labels_np, train_idx[:0], num_classes)
            if self._use_labels
            else np.asarray(ds.x)
        )
        model.preprocess(ds.graph, features0, device=device)
        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        optimizer = adam_l2(net.parameters(), self._lr, self._weight_decay)
        train_step = make_train_step(net, optimizer, self._loss_fn)
        eval_step = make_eval_step(net)

        def on_device(a):
            return torch.as_tensor(a, device=device)

        def eval_on(idx):
            correct, total = 0.0, 0.0
            for b_idx, w in batch_iterator(idx, self._eval_batch_size, shuffle=False, rng=np_rng):
                b = on_device(b_idx)
                c, t = eval_step(model.batch_input(b), labels[b], on_device(w))
                correct += float(c)
                total += float(t)
            return correct / max(total, 1.0)

        best_val, best_test = 0.0, 0.0
        train_pred_idx = train_idx
        for epoch in range(self._epochs):
            if self._use_labels:
                mask = np_rng.random(train_idx.shape[0]) < self._mask_rate
                train_labels_idx = train_idx[mask]
                train_pred_idx = train_idx[~mask]
                features = add_labels(ds.x, labels_np, train_labels_idx, num_classes)
            else:
                features = np.asarray(ds.x)

            t0 = time.perf_counter()
            model.preprocess(ds.graph, features, device=device)
            if self._label_iters > 0 and epoch > self._reuse_start_epoch:
                unlabeled = np.concatenate([train_pred_idx, val_idx, test_idx])
                for _ in range(self._label_iters):
                    _reuse_labels_read_every_batch(model, net, ds.graph, features, unlabeled, num_classes, device,
                                                   self._eval_batch_size)
            _sync(device)
            self.propagate_seconds.append(time.perf_counter() - t0)

            t = time.perf_counter()
            losses, accs, weights = [], [], []
            for b_idx, w in batch_iterator(
                train_pred_idx, self._train_batch_size, shuffle=True, rng=np_rng
            ):
                b = on_device(b_idx)
                loss, acc = train_step(model.batch_input(b), labels[b], on_device(w), dropout_gen)
                losses.append(float(loss))
                accs.append(float(acc))
                weights.append(float(w.sum()))
            self.epoch_seconds.append(time.perf_counter() - t)
            self.train_losses.append(float(np.average(losses, weights=weights)))
            acc_val = eval_on(val_idx)
            acc_test = eval_on(test_idx)
            self.epoch_accuracies.append((float(np.average(accs, weights=weights)), acc_val, acc_test))
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test

        outputs = make_logits_fn(net, self._eval_batch_size, model.row_dim)(model.processed_feature)
        pred = model.postprocess(ds.graph, outputs).argmax(dim=1)

        def acc(idx):
            idx = on_device(idx)
            return float((pred[idx] == labels[idx]).float().mean())

        acc_val, acc_test = acc(val_idx), acc(test_idx)
        if acc_val > best_val:
            best_val, best_test = acc_val, acc_test
        self.net = net
        return best_test


class _HeteroReadEveryBatch(HeteroNodeClassification):
    """``HeteroNodeClassification``'s loop before it shared the task loop,
    as ``_LabelUseReadEveryBatch`` keeps the label-use one."""

    def _execute(self, random_subgraph_num, subgraph_edge_type_num, subgraph_list, record_subgraph_weight):
        ds, model, device = self._dataset, self._model, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        np_rng = np.random.default_rng(self._seed)

        t0 = time.perf_counter()
        model.preprocess(
            ds,
            self._predict_class,
            random_subgraph_num=random_subgraph_num,
            subgraph_edge_type_num=subgraph_edge_type_num,
            subgraph_list=subgraph_list,
            seed=self._seed,
            device=device,
        )
        _sync(device)
        self.preprocess_seconds = time.perf_counter() - t0

        labels_np = np.asarray(ds.data[self._predict_class].y).reshape(-1)
        labels = torch.as_tensor(labels_np, dtype=torch.int64, device=device)
        train_idx = np.asarray(ds.train_idx)
        val_idx = np.asarray(ds.val_idx)
        test_idx = np.asarray(ds.test_idx)

        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        optimizer = adam_l2(net.parameters(), self._lr, self._weight_decay)
        train_step = make_train_step(net, optimizer, self._loss_fn)
        eval_step = make_eval_step(net)

        def on_device(a):
            return torch.as_tensor(a, device=device)

        def eval_on(idx):
            correct, total = 0.0, 0.0
            for b_idx, w in batch_iterator(idx, self._eval_batch_size, shuffle=False, rng=np_rng):
                b = on_device(b_idx)
                c, t = eval_step(model.batch_input(b), labels[b], on_device(w))
                correct += float(c)
                total += float(t)
            return correct / max(total, 1.0)

        best_val, best_test = 0.0, 0.0
        best_weight = None
        for _ in range(self._epochs):
            t = time.perf_counter()
            losses, accs, weights = [], [], []
            for b_idx, w in batch_iterator(train_idx, self._train_batch_size, shuffle=True, rng=np_rng):
                b = on_device(b_idx)
                loss, acc = train_step(model.batch_input(b), labels[b], on_device(w), dropout_gen)
                losses.append(float(loss))
                accs.append(float(acc))
                weights.append(float(w.sum()))
            self.epoch_seconds.append(time.perf_counter() - t)
            self.train_losses.append(float(np.average(losses, weights=weights)))
            acc_val = eval_on(val_idx)
            acc_test = eval_on(test_idx)
            self.epoch_accuracies.append((float(np.average(accs, weights=weights)), acc_val, acc_test))
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test
                if record_subgraph_weight:
                    best_weight = model.subgraph_weight()
        self.net = net
        return best_test, best_weight


def _assert_same_job(got, want):
    assert len(got.train_losses) == len(got.epoch_seconds) == len(got.epoch_accuracies) == EPOCHS
    assert got.train_losses == want.train_losses
    assert got.epoch_accuracies == want.epoch_accuracies
    assert got.test_acc == want.test_acc


@pytest.mark.parametrize("train_batch, eval_batch, reuse", [
    (32, 50, {}),  # ~45 rows to predict an epoch: a wrapped tail
    (None, None, {}),  # full batch
    (32, 50, dict(label_iters=1, reuse_start_epoch=0)),  # label reuse from the second epoch
], ids=["label-use-mini-batch", "label-use-full-batch", "label-reuse"])
def test_label_use_reads_twice_an_epoch_what_its_read_every_batch_loop_gave(ds, train_batch, eval_batch, reuse):
    kw = dict(lr=0.01, weight_decay=5e-5, epochs=EPOCHS, device="cpu", seed=7, train_batch_size=train_batch,
              eval_batch_size=eval_batch, verbose=False, **reuse)

    def model():
        return GAMLP(prop_steps=3, feat_dim=ds.num_features + ds.num_classes, output_dim=ds.num_classes,
                     hidden_dim=16, num_layers=2, dropout=0.5)

    _assert_same_job(NodeClassificationWithLabelUse(ds, model(), **kw),
                     _LabelUseReadEveryBatch(ds, model(), **kw))


@pytest.fixture(scope="module")
def hetero_ds():
    d = SyntheticHeteroDataset(seed=1)
    assert (len(d.train_idx), len(d.val_idx), len(d.test_idx)) == (60, 30, 30)
    return d


@pytest.mark.parametrize("train_batch, eval_batch", [
    (32, 16),  # 2 train batches, a wrapped tail in each split
    (None, None),  # full batch
], ids=["nars-sign-mini-batch", "nars-sign-full-batch"])
def test_hetero_reads_twice_an_epoch_what_its_read_every_batch_loop_gave(hetero_ds, train_batch, eval_batch):
    kw = dict(lr=0.05, weight_decay=5e-5, epochs=EPOCHS, device="cpu", seed=7, train_batch_size=train_batch,
              eval_batch_size=eval_batch, random_subgraph_num=2, subgraph_edge_type_num=2, verbose=False)
    f = hetero_ds.data["paper"].x.shape[1]
    got = HeteroNodeClassification(hetero_ds, "paper", NARS_SIGN(2, f, hetero_ds.num_classes, 16, 2, 2), **kw)
    want = _HeteroReadEveryBatch(hetero_ds, "paper", NARS_SIGN(2, f, hetero_ds.num_classes, 16, 2, 2), **kw)
    _assert_same_job(got, want)
