"""Small sizes at which every cell runs on the CPU in seconds: the
cell's configuration and traffic with their widths and counts cut, and
the limits the comparison holds them to at these sizes.

The cells' own limits are set from readings at their full sizes, where
errors grow with depth and width; at these sizes the program and the
float8 control both read less, so the same rule is applied to readings
taken here (the program's largest over seeds 1001-1008 and ``SEED``,
the control's smallest over 1001-1004 and ``SEED``, and the faults' on
``SEED``):

    cell      number   program   float8    limit   (faults)
    train     grad     1.1e-03   9.0e-03   3e-3    (half batch 0.12)
    train     change   1.7e-03   2.5e-03   5e-3    (half batch 0.013;
                                                    unchanged 1)
    decode    gap_mean 2.1e-05   0         5e-3    (half batch 0.042,
                                                    altered 0.055)
    decode    kv_l01   1.2e-02   6.0e-02   0.03    (unchanged 1)
    prefill   logits   2.8e-03   2.0e-02   8e-3    (half batch 1.11,
                                                    altered 1.85)

At this size the float8 control serves the reference's own tokens, so
the decode cell's gap limit is set below the faults' readings, and its
``row_median`` (0 for the program, 2.55 with one session altered) keeps
the cell's own limit."""
from __future__ import annotations

TINY = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 16, "d_ff": 128, "vocab_size": 256, "window": 32,
        "loss_chunk": 64}

CELLS = {
    "danube-train-4x8k": {"arch": TINY | {"num_layers": 4, "d_model": 128,
                                          "d_ff": 256},
                          "traffic": {"batch": 4, "seq": 128}},
    "mixtral16-decode-b128": {
        "arch": TINY | {"num_experts": 4, "top_k": 2},
        "traffic": {"batch": 8, "prompt_len": 32, "wave_tokens": 8,
                    "prefill_group": 4, "max_waves": 8, "warmup_steps": 2}},
    "danube-prefill-1k-8k": {"arch": TINY,
                             "traffic": {"min_len": 16, "max_len": 64,
                                         "cycle": 4}},
}

LIMITS = {
    "danube-train-4x8k": {"grad": 3e-3, "change": 5e-3},
    "mixtral16-decode-b128": {"gap_mean": 0.005, "kv_l01": 0.03},
    "danube-prefill-1k-8k": {"logits": 8e-3},
}
for _cell, _ov in CELLS.items():
    _ov["limits"] = LIMITS[_cell]

SEED = 2 ** 31 + 12345
