"""The inputs of the other families' sharded-training pins
(``tests/data/torch_sharded_families_train.json``), from numpy seeds: the
JAX package writes the pins from them on 8 forced host devices with its
jitted ``make_train_step`` (``test_torch_pins.py
--write-sharded-families-train``), the port is held to them on 8 gloo
ranks (``test_torch_sharded_families_train.py``, and on the card
``chip_smoke.py``'s phase 17 (a)).  numpy only: both packages import it.

Each case is a reduced config of the enc-dec (whisper: 2 encoder and 2
decoder layers, 16 frames, within one ``attn_kv_chunk``), SSM (mamba2, 2
layers) or hybrid (recurrentgemma, 4 layers: one full ``rec, rec, attn``
group under ``remat`` and one tail ``rec`` layer outside it) family,
float32 parameters, compute and moments, ``remat="full"``, trained by
AdamW (the default ``AdamWConfig``) for ``STEPS`` steps on one batch of
``[batch, SEQ]`` tokens (and whisper's frames), every parameter and
moment placed under ``param_specs`` / ``opt_state_specs`` and the batch
under ``P(dp, ...)`` (replicated where dp does not divide it).  The
cases:

* whisper on 2x4 (2 KV heads on 4 model ranks: every rank computes both
  and keeps one), on 2x2x2 (the pod axis; KV heads split) and with a
  batch of 1 (dp does not divide it);
* mamba2 on 2x4 (2 of 8 heads a rank), with head dim 64 (2 heads over 4
  ranks: ``model`` cuts each head, the ranks' head spans overlap), with
  ``ssm_state`` 14 (``wxbc``'s column blocks cut B and C elsewhere), on
  2x2x2, and with 2 microbatches;
* recurrentgemma on 2x4 (4 q heads on its one KV head), and with 10 q
  heads (10 over 4 ranks: the uneven q-head span).

Every matrix is drawn N(0, 1 / fan_in), the conv filters N(0, 1 /
width), the embedding N(0, 1 / d_model), whisper's frames N(0, 1).  The
pins, the bounds and the checks are ``torch_sharded_train_cases``'.
"""
from __future__ import annotations

import sys
import zlib

import numpy as np

from torch_sharded_train_cases import (  # noqa: F401
    ADAM_SIGN_TOL, GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, MESHES, PARAM_ATOL, SEQ,
    STEPS, SUMSQ_RTOL, VIT_STUB_DIM, WORLD, check_case, decode, encode, leaf,
    paths, pin_keys, summarise)

PIN_FILE = "torch_sharded_families_train.json"     # under tests/data
REPLACE = {"num_layers": 2, "compute_dtype": "float32",
           "param_dtype": "float32", "opt_dtype": "float32", "remat": "full"}

# name -> (arch, config replacements beyond REPLACE, mesh, batch,
# microbatch)
CASES = {
    "whisper/2x4": ("whisper-medium", {}, "2x4", 4, 1),
    "whisper/2x2x2": ("whisper-medium", {}, "2x2x2", 4, 1),
    "whisper/2x4/batch1": ("whisper-medium", {}, "2x4", 1, 1),
    "mamba2/2x4": ("mamba2-130m", {}, "2x4", 4, 1),
    "mamba2/2x4/cut-heads": ("mamba2-130m", {"ssm_headdim": 64}, "2x4", 4,
                             1),
    "mamba2/2x4/state14": ("mamba2-130m", {"ssm_state": 14}, "2x4", 4, 1),
    "mamba2/2x2x2": ("mamba2-130m", {}, "2x2x2", 4, 1),
    "mamba2/2x4/micro2": ("mamba2-130m", {}, "2x4", 4, 2),
    "recurrentgemma/2x4": ("recurrentgemma-2b", {"num_layers": 4}, "2x4",
                           4, 1),
    "recurrentgemma/2x4/heads10": ("recurrentgemma-2b",
                                   {"num_layers": 4, "num_heads": 10},
                                   "2x4", 4, 1),
}


def replace(name: str) -> dict:
    """The config replacements of case ``name`` (its reduced config's)."""
    return {**REPLACE, **CASES[name][1]}


def case_inputs(name: str, shapes: dict, cfg) -> dict:
    """``{"params", "tokens"[, "frames"]}`` of case ``name`` for its config
    ``cfg`` (either package's): the tree of ``shapes`` (nested dicts of
    shape tuples, leaves drawn in sorted-path order), tokens ``[batch,
    SEQ]`` and an enc-dec's frames ``[batch, enc_seq, 1024]``, from a seed
    of the case's name."""
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
            else:
                fan = (cfg.d_model if path == () and key == "embed" else
                       val[-1] if key == "conv_w" else val[-2])
                out[key] = (rng.standard_normal(val)
                            / np.sqrt(fan)).astype(np.float32)
        return out

    out = {"params": tree(shapes),
           "tokens": rng.integers(0, cfg.vocab_size, (batch, SEQ)
                                  ).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, VIT_STUB_DIM)).astype(np.float32)
    return out


def port_config(name: str):
    from repro_torch.configs import get_config
    return get_config(CASES[name][0]).reduced().replace(**replace(name))


def rank_cases(rank: int, device: str, names=None) -> dict:
    """Every case (or those of ``names``) through the port on this rank of
    an 8-rank process group (``torch_sharded_train_cases.run_case``):
    ``{case: record}``, each with its counting mesh's logs, plus
    ``"_coords"``."""
    import torch_sharded_train_cases as train_cases
    return train_cases.rank_cases(rank, device, names,
                                  sys.modules[__name__])
