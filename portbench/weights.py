"""The weights and inputs of a run, made on the device from ``--seed``.

The tree is the one the port's decoder entry points take (``embed``,
``ln_f``, ``unembed`` when the embedding is not tied, and one stacked
layer group: ``dense0`` with a SwiGLU FFN, or ``moe`` with the router and
the experts).  Every matrix is N(0, 0.02); norm scales are ones.  Each
layer's slice of each leaf is drawn by its own generator, seeded from the
run's seed and the slice's path, so that the plain reference can draw any
one slice again without the rest (``layer_slice``) and the program never
hands the reference a weight.  Matrices are drawn straight into the type
they are used in: the compute dtype for serving, ``param_dtype`` for
training."""
from __future__ import annotations

import hashlib

import torch

# leaves the port holds in the compute dtype when it serves
MATRICES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def derive(seed: int, *path) -> int:
    """A 63-bit generator seed from the run's seed and a path."""
    h = hashlib.sha256(repr((int(seed),) + tuple(path)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *path) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *path))


def layer_shapes(a: dict) -> dict:
    """One layer's leaves: name -> shape (the MoE leaves under ``moe``)."""
    d, hd, f = a["d_model"], a["head_dim"], a["d_ff"]
    out = {"ln1": (d,), "ln2": (d,),
           "wq": (d, a["num_heads"] * hd), "wk": (d, a["num_kv_heads"] * hd),
           "wv": (d, a["num_kv_heads"] * hd), "wo": (a["num_heads"] * hd, d)}
    if a.get("num_experts"):
        e = a["num_experts"]
        out["moe"] = {"router": (d, e), "wg": (e, d, f), "wu": (e, d, f),
                      "wo": (e, f, d)}
    else:
        out |= {"wg": (d, f), "wu": (d, f), "wd": (f, d)}
    return out


def group_name(a: dict) -> str:
    return "moe" if a.get("num_experts") else "dense0"


def top_shapes(a: dict) -> dict:
    out = {"embed": (a["vocab_size"], a["d_model"]), "ln_f": (a["d_model"],)}
    if not a.get("tie_embeddings"):
        out["unembed"] = (a["d_model"], a["vocab_size"])
    return out


def _dtype(name: str, a: dict, serve: bool) -> torch.dtype:
    if serve and name in MATRICES:
        return getattr(torch, a["compute_dtype"])
    return getattr(torch, a["param_dtype"])


def _draw(out: torch.Tensor, g: torch.Generator, one: bool) -> torch.Tensor:
    if one:
        return out.fill_(1.0)
    return out.normal_(0.0, 1.0, generator=g).mul_(0.02)


def layer_slice(a: dict, seed: int, layer: int, path: tuple, device,
                dtype: torch.dtype) -> torch.Tensor:
    """Layer ``layer``'s slice of the leaf at ``path`` (inside the layer
    group), drawn again exactly as ``make_params`` drew it."""
    shape = layer_shapes(a)
    for key in path:
        shape = shape[key]
    out = torch.empty(shape, dtype=dtype, device=device)
    return _draw(out, generator(device, seed, "layer", layer, *path),
                 len(shape) == 1)


def top_leaf(a: dict, seed: int, name: str, device,
             dtype: torch.dtype) -> torch.Tensor:
    shape = top_shapes(a)[name]
    out = torch.empty(shape, dtype=dtype, device=device)
    return _draw(out, generator(device, seed, "top", name), len(shape) == 1)


def layer_paths(a: dict) -> list[tuple]:
    """Every leaf path inside the layer group, in sorted order."""
    out = []
    for key, val in sorted(layer_shapes(a).items()):
        if isinstance(val, dict):
            out += [(key, k) for k in sorted(val)]
        else:
            out.append((key,))
    return out


def make_params(a: dict, seed: int, device, serve: bool) -> dict:
    """The port's parameter tree: top leaves, and each layer-group leaf
    stacked over the layers, every slice drawn by its own generator."""
    L = a["num_layers"]
    params: dict = {name: top_leaf(a, seed, name, device,
                                   _dtype(name, a, serve))
                    for name in top_shapes(a)}
    group: dict = {}
    for path in layer_paths(a):
        shape = layer_shapes(a)
        for key in path:
            shape = shape[key]
        dt = _dtype(path[-1], a, serve)
        leaf = torch.empty((L, *shape), dtype=dt, device=device)
        for i in range(L):
            _draw(leaf[i], generator(device, seed, "layer", i, *path),
                  len(shape) == 1)
        node = group
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    params["layers"] = {group_name(a): group}
    return params


def tree_shapes(tree) -> dict:
    """Nested dict of shapes (tuples) of a tensor tree."""
    return {k: tree_shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def tokens(seed: int, device, vocab: int, shape: tuple, *path
           ) -> torch.Tensor:
    """Token ids uniform over the vocabulary, int64, drawn on ``device``."""
    return torch.randint(0, vocab, shape, device=device,
                         generator=generator(device, seed, "tokens", *path))
