"""The inputs of the knob pins' training cases
(``tests/data/torch_sharded_knobs.json``, with
``torch_sharded_knobs_cases``' serving cases), from numpy seeds: the JAX
package writes the pins from them on 8 forced host devices with its
jitted ``make_train_step`` (``test_torch_pins.py
--write-sharded-knobs``), the port is held to them on 8 gloo ranks
(``test_torch_sharded_knobs.py``).  numpy only: both packages import it.

The cases are ``torch_sharded_train_cases``' (reduced decoders cut to 2
layers, float32 parameters, compute and moments, 2 AdamW steps on one
batch of ``[batch, 16]`` tokens) under the reference's attention and
remat knobs:

* llama with ``attn_shard`` "heads" and "seq" on 2x4, "seq" on 2x2x2;
* llama with 6 q heads under "heads", and with ``pad_heads_to=8``;
* h2o-danube "seq" with its window cut to 8 and llama4 "expert" "seq"
  with its chunk cut to 8 (each crosses a rank's span of 4 query
  positions);
* mixtral "ffn" under ``remat="dots"``, and llama under "dots" with
  "seq";
* llama "seq" on 2x4 over 6 tokens (``SEQS``): the last of 4 model ranks
  holds no query row.

The pins, the bounds and the checks are ``torch_sharded_train_cases``'.
"""
from __future__ import annotations

import sys
import zlib

import numpy as np

import torch_sharded_train_cases as train_cases
from torch_sharded_train_cases import (  # noqa: F401
    ADAM_SIGN_TOL, GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, MESHES, PARAM_ATOL, SEQ,
    STEPS, SUMSQ_RTOL, VIT_STUB_DIM, WORLD, decode, encode, leaf, paths,
    pin_keys, summarise)

PIN_FILE = "torch_sharded_knobs.json"       # under tests/data, "train/..."

REPLACE = {"num_layers": 2, "compute_dtype": "float32",
           "param_dtype": "float32", "opt_dtype": "float32", "remat": "full"}
HEADS = {"attn_shard": "heads"}
SEQ_SHARD = {"attn_shard": "seq"}
MOE = {"num_experts": 8}

# name -> (arch, config replacements beyond REPLACE, mesh, batch,
# microbatch)
CASES = {
    "llama/2x4/heads": ("llama3.2-3b", HEADS, "2x4", 4, 1),
    "llama/2x4/seq": ("llama3.2-3b", SEQ_SHARD, "2x4", 4, 1),
    "llama/2x2x2/seq": ("llama3.2-3b", SEQ_SHARD, "2x2x2", 4, 1),
    "llama-heads6/2x4/heads": ("llama3.2-3b", {"num_heads": 6, **HEADS},
                               "2x4", 4, 1),
    "llama-pad8/2x4": ("llama3.2-3b", {"num_heads": 6, "pad_heads_to": 8},
                       "2x4", 4, 1),
    "h2o/2x4/seq": ("h2o-danube-1.8b", {"window": 8, **SEQ_SHARD}, "2x4",
                    4, 1),
    "llama4-expert/2x4/seq": ("llama4-maverick-400b-a17b",
                              {"chunk_attn": 8, "moe_shard": "expert",
                               **MOE, **SEQ_SHARD}, "2x4", 4, 1),
    "mixtral-ffn/2x4/dots": ("mixtral-8x7b", {"moe_shard": "ffn", **MOE,
                                              "remat": "dots"}, "2x4", 4,
                             1),
    "llama/2x4/seq/dots": ("llama3.2-3b", {**SEQ_SHARD, "remat": "dots"},
                           "2x4", 4, 1),
    "llama/2x4/seq/seq6": ("llama3.2-3b", SEQ_SHARD, "2x4", 4, 1),
}
# name -> sequence length, where it is not SEQ
SEQS = {"llama/2x4/seq/seq6": 6}


def check_case(name: str, records: list, pins: dict,
               leaf_paths: list) -> dict:
    """``torch_sharded_train_cases.check_case`` against the knob pins'
    training arrays (``PIN_FILE``'s keys under ``train/``; a dict of them
    without the prefix works too)."""
    return train_cases.check_case(
        name, records, {k.removeprefix("train/"): v for k, v in pins.items()},
        leaf_paths)


def replace(name: str) -> dict:
    """The config replacements of case ``name`` (its reduced config's)."""
    return {**REPLACE, **CASES[name][1]}


def inputs(name: str, shapes: dict, vocab: int, d_model: int,
           img_tokens: int = 0) -> dict:
    """``{"params", "tokens"}`` of case ``name``: the decoder tree of
    ``shapes`` (leaves drawn in sorted-path order, every matrix N(0, 1 /
    fan_in), the embedding N(0, 1 / d_model), 1-D leaves ones) and tokens
    ``[batch, SEQS.get(name, SEQ)]``, from a seed of the case's name."""
    batch = CASES[name][3]
    rng = np.random.default_rng(zlib.crc32(f"train/{name}".encode()))

    def tree(node, path=()):
        out = {}
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                out[key] = tree(val, path + (key,))
            elif len(val) == 1:
                out[key] = np.ones(val, np.float32)
            elif path == () and key == "embed":
                out[key] = (rng.standard_normal(val)
                            / np.sqrt(d_model)).astype(np.float32)
            else:
                out[key] = (rng.standard_normal(val)
                            / np.sqrt(val[-2])).astype(np.float32)
        return out

    return {"params": tree(shapes),
            "tokens": rng.integers(0, vocab, (batch, SEQS.get(name, SEQ))
                                   ).astype(np.int32)}


def case_inputs(name: str, shapes: dict, cfg) -> dict:
    """``inputs`` of case ``name`` for its config ``cfg`` (either
    package's)."""
    return inputs(name, shapes, cfg.vocab_size, cfg.d_model)


def port_config(name: str):
    from repro_torch.configs import get_config
    return get_config(CASES[name][0]).reduced().replace(**replace(name))


def rank_cases(rank: int, device: str, names=None) -> dict:
    """Every case (or those of ``names``) through the port on this rank of
    an 8-rank process group (``torch_sharded_train_cases.run_case``):
    ``{case: record}``, each with its counting mesh's logs, plus
    ``"_coords"``."""
    return train_cases.rank_cases(rank, device, names,
                                  sys.modules[__name__])
