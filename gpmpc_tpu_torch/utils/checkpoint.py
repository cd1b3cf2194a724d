"""Checkpoint and resume for campaigns and learning loops (counterpart of
``gpmpc_tpu/utils/checkpoint.py``).

A tree is any nesting of dicts, lists, tuples, named tuples and dataclasses
(the port's states: ``SafeSet``, ``GPMPCState``, the GP states) over
tensors. Its leaves are its tensors and NumPy arrays, in a fixed order:
dict entries by sorted key, list and tuple items in order, dataclass fields
in declaration order. Everything else (numbers, strings, configs, None) is
static: it comes back from the template, as a JAX pytree's static fields
come back from its treedef. :func:`save_pytree` writes the leaves as one
``.npz`` (``arr_0``, ``arr_1``, … in leaf order), the JAX package's
fallback format, through a temporary file and a rename, so an interrupted
save leaves the previous checkpoint intact. :func:`restore_pytree` rebuilds
the template's structure with each leaf on the template leaf's device and
dtype.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves in the fixed order, rebuild): ``rebuild(new_leaves)`` gives the
    tree with its leaves replaced, in the same order."""
    if _is_leaf(tree):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return _join(parts, lambda vals: {**tree, **dict(zip(keys, vals))})
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        if hasattr(tree, "_fields"):  # a named tuple
            return _join(parts, lambda vals: type(tree)(*vals))
        return _join(parts, lambda vals: type(tree)(vals))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree) if f.init]
        parts = [_flatten(getattr(tree, n)) for n in names]
        return _join(parts, lambda vals: dataclasses.replace(tree, **dict(zip(names, vals))))
    return [], lambda ls: tree


def _join(parts, build):
    leaves = [leaf for ls, _ in parts for leaf in ls]
    sizes = [len(ls) for ls, _ in parts]

    def rebuild(new):
        vals, i = [], 0
        for (_, rb), k in zip(parts, sizes):
            vals.append(rb(new[i:i + k]))
            i += k
        return build(vals)

    return leaves, rebuild


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _like(template, a: np.ndarray):
    """``a`` as the template leaf's kind, device and dtype."""
    if isinstance(template, np.ndarray):
        return a.astype(template.dtype)
    return torch.as_tensor(a).to(device=template.device, dtype=template.dtype)


def save_pytree(path: str, tree: Any) -> None:
    """Write every leaf of ``tree`` to ``path + ".npz"``."""
    path = os.path.abspath(path)
    leaves, _ = _flatten(tree)
    head, tail = os.path.split(path)
    tmp = os.path.join(head, f".tmp-{os.getpid()}-{tail}.npz")
    np.savez(tmp, *[_to_numpy(x) for x in leaves])
    os.replace(tmp, path + ".npz")


def restore_pytree(path: str, template: Any) -> Any:
    """The tree saved at ``path`` in the structure of ``template``: each
    leaf on the template leaf's device and dtype, the static parts the
    template's."""
    leaves, rebuild = _flatten(template)
    with np.load(os.path.abspath(path) + ".npz") as data:
        if len(data.files) != len(leaves):
            raise ValueError(f"{path}.npz holds {len(data.files)} leaves, the template "
                             f"{len(leaves)}")
        arrays = [data[f"arr_{i}"] for i in range(len(leaves))]
    for i, (t, a) in enumerate(zip(leaves, arrays)):
        if tuple(t.shape) != a.shape:
            raise ValueError(f"leaf {i}: saved shape {a.shape}, template {tuple(t.shape)}")
    return rebuild([_like(t, a) for t, a in zip(leaves, arrays)])


class CampaignCheckpointer:
    """Step-indexed checkpoints in ``directory`` (``step_00000001.npz``, …),
    keeping the ``keep`` newest: mid-campaign resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, state: Any) -> None:
        save_pytree(self._path(step), state)
        self._prune()

    def latest_step(self) -> Optional[int]:
        steps = [int(n[5:13]) for n in os.listdir(self.directory) if n.startswith("step_")]
        return max(steps) if steps else None

    def restore_latest(self, template: Any) -> Tuple[Optional[int], Any]:
        """(the newest step, its tree), or (None, ``template``) when there
        is none."""
        step = self.latest_step()
        if step is None:
            return None, template
        return step, restore_pytree(self._path(step), template)

    def _prune(self) -> None:
        entries = sorted(n for n in os.listdir(self.directory) if n.startswith("step_"))
        for name in entries[: -self.keep]:
            p = os.path.join(self.directory, name)
            if os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
            else:
                os.remove(p)
