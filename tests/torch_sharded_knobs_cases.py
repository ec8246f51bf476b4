"""The inputs of the knob pins' serving cases
(``tests/data/torch_sharded_knobs.json``, with
``torch_sharded_knobs_train_cases``' training cases), from numpy seeds:
the JAX package writes the pins from them on 8 forced host devices
(``test_torch_pins.py --write-sharded-knobs``), the port is held to them
on 8 gloo ranks (``test_torch_sharded_knobs.py``).  numpy only: both
packages import it.

The cases are ``torch_sharded_cases``' (reduced decoders, float32, a
prefill over ``[batch, 16]`` tokens, the caches carried as numpy and
grown to ``slots`` slots, 4 decode steps) under the reference's
attention knobs (``benchmarks/perf_hillclimb.py``'s, in small):

* llama with ``attn_shard`` "heads" and "seq" on 2x4 and 2x2x2, "seq"
  also with a batch of 1;
* llama with 6 q heads: "heads" (6 over 4 model ranks, whole heads two a
  rank, the last rank none) and ``pad_heads_to=8`` (4 model ranks divide
  8 but not 6: each rank holds two whole padded heads), the padding also
  under "seq" on 2x2x2;
* h2o-danube "seq" with its window cut to 8, so that it crosses a rank's
  span of 4 query positions;
* llama4 "expert" "seq" with its chunk cut to 8, so that it crosses one;
* llama "seq" on 2x4 with a prompt of 6 (``PROMPTS``): 4 model ranks
  take 2 positions each, so the last holds no query row.
"""
from __future__ import annotations

import sys
import zlib

import numpy as np

from torch_sharded_cases import (PROMPT, REPLACE, STEPS,  # noqa: F401
                                 VIT_STUB_DIM, cache_paths, steps)
from torch_mesh_cases import MESHES, WORLD, decode, encode  # noqa: F401

HEADS = {"attn_shard": "heads"}
SEQ = {"attn_shard": "seq"}
PAD = {"num_heads": 6, "pad_heads_to": 8}
# name -> (arch, config replacements beyond REPLACE, mesh, batch, slots)
CASES = {
    "llama/2x4/heads": ("llama3.2-3b", HEADS, "2x4", 4, 20),
    "llama/2x4/seq": ("llama3.2-3b", SEQ, "2x4", 4, 20),
    "llama/2x2x2/heads": ("llama3.2-3b", HEADS, "2x2x2", 4, 20),
    "llama/2x2x2/seq": ("llama3.2-3b", SEQ, "2x2x2", 4, 20),
    "llama/2x4/seq/batch1": ("llama3.2-3b", SEQ, "2x4", 1, 18),
    "llama-heads6/2x4/heads": ("llama3.2-3b", {"num_heads": 6, **HEADS},
                               "2x4", 4, 20),
    "llama-pad8/2x4": ("llama3.2-3b", PAD, "2x4", 4, 20),
    "llama-pad8/2x2x2/seq": ("llama3.2-3b", {**PAD, **SEQ}, "2x2x2", 4,
                             20),
    "h2o/2x4/seq": ("h2o-danube-1.8b", {"window": 8, **SEQ}, "2x4", 4, 20),
    "llama4-expert/2x4/seq": ("llama4-maverick-400b-a17b",
                              {"chunk_attn": 8, "num_experts": 8,
                               "moe_shard": "expert", **SEQ}, "2x4", 4,
                              20),
    "llama/2x4/seq/prompt6": ("llama3.2-3b", SEQ, "2x4", 4, 12),
}
# name -> prompt length, where it is not PROMPT
PROMPTS = {"llama/2x4/seq/prompt6": 6}


def case_replace(name: str) -> dict:
    """Case ``name``'s config replacements (its reduced config's)."""
    return {**REPLACE, **CASES[name][1]}


def port_config(name: str):
    from repro_torch.configs import get_config
    return get_config(CASES[name][0]).reduced().replace(
        **case_replace(name))


def inputs(name: str, shapes: dict, vocab: int, d_model: int,
           img_tokens: int) -> dict:
    """``{"params", "tokens"}`` of case ``name``: the decoder tree of
    ``shapes`` (leaves drawn in sorted-path order, every matrix N(0, 1 /
    fan_in), the embedding N(0, 1 / d_model), 1-D leaves ones) and tokens
    ``[batch, prompt + STEPS]`` (``PROMPTS``, else ``PROMPT``), from a
    seed of the case's name."""
    batch = CASES[name][3]
    rng = np.random.default_rng(zlib.crc32(name.encode()))

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
            "tokens": rng.integers(
                0, vocab, (batch, PROMPTS.get(name, PROMPT) + STEPS)
            ).astype(np.int32)}


def case_keys() -> list[str]:
    """Every pinned logits array: ``<case>/<step>``."""
    return [f"{c}/{s}" for c in CASES for s in steps()]


def rank_all(rank: int, device: str) -> dict:
    """Every serving case (``torch_sharded_cases.rank_cases`` over this
    module) and every training case (``torch_sharded_knobs_train_cases``)
    through the port on this rank of an 8-rank process group: ``{"serve":
    {case: record}, "train": {case: record}}``."""
    import torch_sharded_cases
    import torch_sharded_knobs_train_cases as train
    return {"serve": torch_sharded_cases.rank_cases(
        rank, device, sys.modules[__name__]),
        "train": train.rank_cases(rank, device)}
