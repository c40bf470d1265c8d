"""The task loop's batches built on the device
(``sgl_tpu_torch.tasks.node_classification._batches`` in an epoch's
``_order``) are ``batch_iterator``'s, element for element, with the same
draws from the generator; and a job on them, whose steps' results are read
twice an epoch, gives to the bit what the loop over ``batch_iterator`` with
a read after every batch gave."""

import time

import numpy as np
import pytest
import torch

from sgl_tpu_torch.datasets.synthetic import PlantedPartition
from sgl_tpu_torch.models import GAMLP
from sgl_tpu_torch.tasks import NodeClassification
from sgl_tpu_torch.tasks.node_classification import _batches, _order
from sgl_tpu_torch.tasks.utils import (
    adam_l2,
    batch_iterator,
    make_eval_step,
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
