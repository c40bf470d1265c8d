"""Distributed node classification — counterpart of
``sgl_tpu/tasks/node_classification_dist.py``.

One process per rank on a ``(data, graph)`` mesh (``torchrun``, an explicit
rendezvous, or alone as a one-rank mesh): the pre-propagation runs as a ring
over the ``graph`` axis, training runs data-parallel over ``data`` with the
gradients all-reduced, and the post-propagation runs on the ring again.
The layout follows the device, as ``sgl_tpu``'s follows the TPU: on CUDA
the chunked layout, whose buckets are K3/K4 launches; on the CPU the segment
layout.  The hop stack stays node-sharded by default (``ShardedHops``).
Every rank ends with the same ``test_acc`` and the same trained ``net``;
``state`` keeps its ``state_dict``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from sgl_tpu_torch.models.base import SGAPModel, eager_aggregate
from sgl_tpu_torch.tasks.base_task import BaseTask
from sgl_tpu_torch.tasks.utils import adam_l2, batch_iterator, set_seed, weighted_cross_entropy
from sgl_tpu_torch.utils.config import TrainConfig


def _host_state(tensors: dict) -> dict:
    """Host copies of a name → tensor mapping."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class NodeClassificationDist(BaseTask):
    def __init__(
        self,
        dataset,
        model: SGAPModel,
        lr: Optional[float] = None,
        weight_decay: Optional[float] = None,
        epochs: Optional[int] = None,
        mesh_shape: Optional[Tuple[int, int]] = None,
        loss_fn=weighted_cross_entropy,
        seed: Optional[int] = None,
        train_batch_size: Optional[int] = None,
        verbose: bool = True,
        sharded_hops: bool = True,
        precompute_dtype: Optional[torch.dtype] = None,  # torch.bfloat16: half the ring's bytes and the hops
        config: Optional[TrainConfig] = None,  # defaults for the Nones above
        device=None,
    ):
        super().__init__()
        from sgl_tpu_torch.parallel import make_mesh, rank_device

        r = (config or TrainConfig()).resolve(
            lr=lr, weight_decay=weight_decay, epochs=epochs, seed=seed,
            train_batch_size=train_batch_size,
        )
        self._dataset = dataset
        self._model = model
        self._lr = r["lr"]
        self._weight_decay = r["weight_decay"]
        self._epochs = r["epochs"]
        self._loss_fn = loss_fn
        self._seed = r["seed"]
        self._train_batch_size = r["train_batch_size"]
        self._verbose = verbose
        # False keeps the replicated (K+1, N, D) stack on every rank
        self._sharded_hops = sharded_hops
        self._precompute_dtype = precompute_dtype
        self._mesh = make_mesh(mesh_shape, device_type=None if device is None else torch.device(device).type)
        self._device = rank_device(device)
        #: wall seconds of the distributed pre-propagation (device work included)
        self.preprocess_seconds: float = 0.0
        #: each ring step's ``kernel_ms`` and ``transfer_ms`` over the
        #: pre-propagation's hops, and the ``route`` the blocks took
        self.ring_stats: dict = {}
        #: the pre-propagation's layout (``DistChunkedAdj`` on CUDA, else ``DistAdj``)
        self.dadj = None
        #: the first data-parallel step: its ``loss``, and host copies of the
        #: ``params_before`` it, the summed ``grads`` and the ``params`` after it
        self.first_step: dict = {}
        #: wall seconds of each data-parallel step (ended by reading its loss)
        self.step_seconds: List[float] = []
        #: wall seconds of each epoch's steps
        self.epoch_seconds: List[float] = []
        self._test_acc = self._execute()

    test_acc = property(lambda self: self._test_acc)

    def _execute(self) -> float:
        from sgl_tpu_torch.parallel import (
            k_hop_propagate_dist,
            make_parallel_train_step,
            partition_adj,
            partition_adj_chunked,
            replicate_state,
        )
        from sgl_tpu_torch.parallel.mesh import all_gather, all_reduce_, axis_size

        ds, model, mesh, device = self._dataset, self._model, self._mesh, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        np_rng = np.random.default_rng(self._seed)
        n_graph = axis_size(mesh, "graph")
        n_data = axis_size(mesh, "data")
        graph_group = mesh.get_group("graph")

        # stage 1: the pre-propagation over the graph axis
        partition = partition_adj_chunked if device.type == "cuda" else partition_adj
        t0 = time.perf_counter()
        dadj = self.dadj = partition(model.pre_graph_op.construct_adj(ds.graph, device), n_graph)
        x_in = torch.as_tensor(np.asarray(ds.x))
        if self._precompute_dtype is not None:
            x_in = x_in.to(self._precompute_dtype)  # bf16 rides the ring as bf16
        hops = k_hop_propagate_dist(
            mesh, dadj, x_in, model.pre_graph_op.prop_steps, axis="graph",
            keep_sharded=self._sharded_hops, device=device, stats=self.ring_stats,
        )
        if self._sharded_hops:
            model.processed_feature = hops if model.pre_msg_learnable else hops.aggregate(
                lambda h: eager_aggregate(model.pre_msg_op, h)
            )
        elif model.pre_msg_learnable:
            model.processed_feature = hops.movedim(0, 1).contiguous() if model.node_major else hops
        else:
            model.processed_feature = eager_aggregate(model.pre_msg_op, hops)
        _sync(device)
        self.preprocess_seconds = time.perf_counter() - t0
        if self._verbose:
            print(f"Distributed preprocessing done in {self.preprocess_seconds:.4f}s")

        labels = ds.to_device(device).y
        train_idx = np.asarray(ds.train_idx)
        val_idx = np.asarray(ds.val_idx)
        test_idx = np.asarray(ds.test_idx)

        # stage 2: data-parallel training
        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        replicate_state(net, mesh)
        optimizer = adam_l2(net.parameters(), self._lr, self._weight_decay)
        step, shard_batch = make_parallel_train_step(
            net, optimizer, mesh, loss_fn=self._loss_fn, node_major_feats=model.node_major,
        )

        def on_device(a):
            return torch.as_tensor(a, device=device)

        @torch.no_grad()
        def head(rows_l):
            f = rows_l.movedim(0, 1) if rows_l.dim() == 3 and model.node_major else rows_l
            return net(f, train=False)

        pf = model.processed_feature
        if self._sharded_hops:
            def eval_accs(idxs):
                # one forward over this rank's rows, shared by every split;
                # each rank counts the hits among the ids it owns
                preds = pf.map_rows(head).argmax(dim=1)
                out = []
                for idx in idxs:
                    ok, mine = pf.owned(idx, preds)
                    hits = (mine == labels[on_device(idx)[ok]]).sum().float()
                    out.append(float(all_reduce_(hits, graph_group)) / max(len(idx), 1))
                return out
        else:
            def eval_accs(idxs):
                return [float((head(model.batch_input(on_device(idx))).argmax(dim=1)
                               == labels[on_device(idx)]).sum()) / max(len(idx), 1) for idx in idxs]

        def pad_batch(b_idx, w):
            """Pad to a multiple of the data axis with zero-weight rows
            (cyclically, for a batch smaller than the axis)."""
            rem = (-len(b_idx)) % n_data
            if rem:
                b_idx = np.concatenate([b_idx, np.resize(b_idx, rem)])
                w = np.concatenate([w, np.zeros(rem, w.dtype)])
            return b_idx, w

        best_val, best_test = 0.0, 0.0
        self.train_losses = []
        for epoch in range(self._epochs):
            t = time.perf_counter()
            losses = []
            for b_idx, w in batch_iterator(train_idx, self._train_batch_size, shuffle=True, rng=np_rng):
                t_step = time.perf_counter()
                b_idx, w = pad_batch(np.asarray(b_idx), np.asarray(w))
                b = on_device(b_idx)
                f, lab, wt = shard_batch(model.batch_input(b), labels[b], on_device(w))
                before = None if self.first_step else _host_state(net.state_dict())
                loss, _ = step(f, lab, wt, dropout_gen)
                if before is not None:
                    self.first_step = dict(
                        loss=float(loss), params_before=before, params=_host_state(net.state_dict()),
                        grads=_host_state({k: v.grad for k, v in net.named_parameters() if v.grad is not None}),
                    )
                losses.append(float(loss))  # waits for the step
                self.step_seconds.append(time.perf_counter() - t_step)
            self.epoch_seconds.append(time.perf_counter() - t)
            self.train_losses.append(float(np.mean(losses)))
            acc_val, acc_test = eval_accs((val_idx, test_idx))
            if self._verbose:
                print(
                    f"Epoch: {epoch + 1:03d} loss_train: {np.mean(losses):.4f} "
                    f"acc_val: {acc_val:.4f} acc_test: {acc_test:.4f} "
                    f"time: {time.perf_counter() - t:.4f}s"
                )
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test

        # stage 3: the post-propagation, on the ring again
        if model.post_graph_op is not None:
            if self._sharded_hops:
                # only the (N, C) logits assemble, never the hop stack
                outputs = all_gather(pf.map_rows(head), graph_group)[: ds.num_node]
                if pf.new_of is not None:
                    outputs = outputs[pf.new_of]
            else:
                outputs = head(model.batch_input(torch.arange(ds.num_node, device=device)))
            post_dadj = partition(model.post_graph_op.construct_adj(ds.graph, device), n_graph)
            post_hops = k_hop_propagate_dist(
                mesh, post_dadj, torch.softmax(outputs, dim=1), model.post_graph_op.prop_steps,
                axis="graph", device=device,
            )
            pred = eager_aggregate(model.post_msg_op, post_hops).argmax(dim=1)

            def acc(idx):
                return float((pred[on_device(idx)] == labels[on_device(idx)]).sum()) / max(len(idx), 1)

            acc_val, acc_test = acc(val_idx), acc(test_idx)
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test

        if self._verbose:
            print(f"Best val: {best_val:.4f}, best test: {best_test:.4f}")
        self.net = net
        self.state = net.state_dict()  # the trained weights are kept
        return best_test
