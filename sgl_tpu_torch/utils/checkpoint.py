"""Checkpoint and resume — counterpart of ``sgl_tpu/utils/checkpoint.py``.

* :func:`save_pytree` / :func:`load_pytree`: an atomic pickle of a nested
  dict / list / tuple whose tensors are stored as numpy arrays (bf16 as
  its int16 bits), so the file loads without torch;
* :func:`save_train_state` / :func:`load_train_state`: a full resume
  point, the net's ``state_dict``, the optimizer's ``state_dict`` and the
  ``torch.Generator`` state (dropout's draws continue where they stopped);
* :class:`HopCheckpointer`: a pre-propagation that saves each hop, so a
  killed precompute resumes at the last completed hop.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device


@dataclasses.dataclass
class _Bf16Bits:
    """A bf16 tensor in a checkpoint: numpy has no bf16, so its int16 bits."""

    bits: np.ndarray


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Bf16Bits(t.view(torch.int16).numpy().copy())
        return t.numpy().copy()
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _to_tensors(tree: Any) -> Any:
    """The inverse of :func:`_to_host`: numpy arrays back to CPU tensors."""
    if isinstance(tree, _Bf16Bits):
        return torch.from_numpy(tree.bits).view(torch.bfloat16)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _to_tensors(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v) for v in tree)
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Atomic pickle of ``tree`` with its tensors as numpy arrays."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(tree), f)
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    """The tree :func:`save_pytree` wrote, with numpy leaves."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_train_state(path: str, net: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     generator: Optional[torch.Generator] = None) -> None:
    """Persist the net's parameters and buffers, the optimizer's state and
    the generator's state: a full resume, where the reference saves the
    model alone (``torch.save`` of the best NAS model)."""
    save_pytree(path, {
        "params": net.state_dict(),
        "opt_state": optimizer.state_dict(),
        "rng": None if generator is None else generator.get_state(),
    })


def load_train_state(path: str, net: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                     generator: Optional[torch.Generator] = None) -> None:
    """Restore what :func:`save_train_state` wrote into ``net``, and into
    ``optimizer`` and ``generator`` when given, in place (each tensor goes
    to the device its counterpart lies on)."""
    d = _to_tensors(load_pytree(path))
    net.load_state_dict(d["params"])
    if optimizer is not None:
        optimizer.load_state_dict(d["opt_state"])
    if generator is not None and d["rng"] is not None:
        generator.set_state(d["rng"])


class HopCheckpointer:
    """Restartable pre-propagation: each hop's features are saved as
    ``hop_<k>.npy`` (f32) in ``directory``, so a killed precompute resumes
    at the last completed hop."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _hop_path(self, k: int) -> str:
        return os.path.join(self.directory, f"hop_{k}.npy")

    def last_completed_hop(self) -> int:
        k = -1
        while os.path.exists(self._hop_path(k + 1)):
            k += 1
        return k

    def save_hop(self, k: int, feats) -> None:
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().cpu().numpy()
        tmp = self._hop_path(k) + ".tmp.npy"
        np.save(tmp, np.asarray(feats, np.float32))
        os.replace(tmp, self._hop_path(k))

    def load_hop(self, k: int) -> np.ndarray:
        return np.load(self._hop_path(k))

    def propagate_resumable(self, adj, x, prop_steps: int, spmm_fn=None, device=None) -> torch.Tensor:
        """``[X, AX, …, A^K X]`` as ``(K+1, N, D)`` f32 on ``device``
        (default: the GPU), saving every hop and starting after the last
        one saved.  Each hop is ``spmm_fn(adj, h)``, by default
        ``kernels/sparse.py::spmm`` (the CSR kernel on the card; a
        ``SparseAdj`` on the card gets its CSR layout once)."""
        from sgl_tpu_torch.kernels.sparse import ensure_device_layout, spmm

        device = resolve_device(device)
        if spmm_fn is None:
            spmm_fn, adj = spmm, ensure_device_layout(adj)
        last = self.last_completed_hop()
        if last < 0:
            self.save_hop(0, x)
            last = 0
        h = torch.from_numpy(self.load_hop(last)).to(device)
        with torch.no_grad():
            for k in range(last + 1, prop_steps + 1):
                h = spmm_fn(adj, h)
                self.save_hop(k, h)
        return torch.stack([torch.from_numpy(self.load_hop(k)) for k in range(prop_steps + 1)]).to(device)
