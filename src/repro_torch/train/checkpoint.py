"""Sharded, manifest-driven checkpointing, in the reference's layout
(``repro.train.checkpoint``), so a checkpoint written by either package
restores in the other:

    <dir>/step_<N>/
        manifest.json   step, config hash, every leaf's shard, key, shape
                        and dtype
        shard_<i>.npz   the leaves, split across files of ``shard_mb``
        _COMMITTED      written last; restore ignores uncommitted dirs

Leaves are named by their tree path as ``jax.tree_util.keystr`` names
them and taken in its order (``tree.leaves``), so the split into shards
and the manifest are the reference's.  A bfloat16 leaf is stored as the
reference's numpy stores it, 2-byte void (``|V2``) with the manifest
dtype "bfloat16", written and read through a 16-bit integer view.  Writes
go to ``step_<N>.tmp`` and are renamed when complete; the newest ``keep``
committed checkpoints are kept.  The config hash is sha256 of the
config's ``repr`` (the two packages' ``ArchConfig`` print alike).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.train.tree import leaves, unflatten

_V2 = np.dtype("V2")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(_V2)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def config_hash(cfg) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def _committed(ckpt_dir: str) -> list[str]:
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp")
                  and os.path.exists(os.path.join(ckpt_dir, d,
                                                  "_COMMITTED")))


def save(ckpt_dir: str, step: int, tree, *, cfg=None, shard_mb: int = 256,
         keep: int = 3) -> str:
    """Atomic sharded save of ``tree`` (nested dicts and tuples of
    tensors); prunes to the newest ``keep`` checkpoints."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    shards: list[dict[str, np.ndarray]] = [{}]
    size = 0
    limit = shard_mb * 1024 * 1024
    index = {}
    for name, leaf in leaves(tree):
        arr = _to_numpy(leaf)
        if size + arr.nbytes > limit and shards[-1]:
            shards.append({})
            size = 0
        key = name.replace("/", "_")
        shards[-1][key] = arr
        index[name] = {"shard": len(shards) - 1, "key": key,
                       "shape": list(arr.shape), "dtype": _dtype_name(leaf)}
        size += arr.nbytes
    for i, shard in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{i}.npz"), **shard)
    manifest = {"step": step, "n_shards": len(shards), "index": index,
                "config_hash": config_hash(cfg) if cfg is not None else None}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    for old in _committed(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, old))
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in _committed(ckpt_dir)]
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like, *, step: int | None = None, cfg=None):
    """Restore into the structure of ``tree_like``, each leaf on its
    ``tree_like`` leaf's device in the stored dtype; verifies the config
    hash and every shape.  Returns (tree, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if cfg is not None and manifest["config_hash"] is not None \
            and manifest["config_hash"] != config_hash(cfg):
        raise ValueError("checkpoint/config mismatch: "
                         f"{manifest['config_hash']} != {config_hash(cfg)}")
    shards = [np.load(os.path.join(d, f"shard_{i}.npz"))
              for i in range(manifest["n_shards"])]
    out = []
    for name, leaf in leaves(tree_like):
        info = manifest["index"][name]
        arr = shards[info["shard"]][info["key"]]
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        out.append(_from_numpy(arr, info["dtype"], leaf.device))
    return unflatten(tree_like, out), step
