"""The reference's tuning plan as data: every iteration of
``benchmarks/perf_hillclimb.py``'s ``ITERATIONS`` (name, arch, shape and
config overrides; the hypotheses left out), copied, because the port
imports nothing of ``benchmarks/``.  ``same_as_the_plan`` checks the copy
against the plan's source text (parsed, not imported: importing it forces
512 host devices on JAX).  ``test_torch_dryrun.py`` lowers each iteration
in the port's dry-run; ``test_torch_pins.py --write-specs`` pins the
reference's argument and output bytes of the padded and TP-only ones
(``BYTE_PINNED``) under ``"_hillclimb"`` in ``tests/data/torch_specs.json``.
"""
from __future__ import annotations

import ast
import pathlib

ITERATIONS = [
    ("A0-baseline", "llama3.2-3b", "prefill_32k", {}),
    ("A1-attn-heads", "llama3.2-3b", "prefill_32k", {"attn_shard": "heads"}),
    ("A2-attn-seq", "llama3.2-3b", "prefill_32k", {"attn_shard": "seq"}),
    ("A3-seq+bf16p", "llama3.2-3b", "prefill_32k",
     {"attn_shard": "seq", "attn_f32_scores": False}),
    ("A4-tp-only", "llama3.2-3b", "prefill_32k", {"fsdp": False}),
    ("A5-tp+bf16p", "llama3.2-3b", "prefill_32k",
     {"fsdp": False, "attn_f32_scores": False}),
    ("A6-pad-heads", "llama3.2-3b", "prefill_32k", {"pad_heads_to": 32}),
    ("A7-pad+bf16p", "llama3.2-3b", "prefill_32k",
     {"pad_heads_to": 32, "attn_f32_scores": False}),
    ("A8-pad+tp-only", "llama3.2-3b", "prefill_32k",
     {"pad_heads_to": 32, "fsdp": False}),
    ("B0-baseline", "llama4-maverick-400b-a17b", "decode_32k", {}),
    ("B1-moe-2d", "llama4-maverick-400b-a17b", "decode_32k",
     {"moe_shard": "2d"}),
    ("B2-moe-2d+heads", "llama4-maverick-400b-a17b", "decode_32k",
     {"moe_shard": "2d", "attn_shard": "heads"}),
    ("C0-baseline", "llama4-maverick-400b-a17b", "train_4k", {}),
    ("C1-attn-heads", "llama4-maverick-400b-a17b", "train_4k",
     {"attn_shard": "heads"}),
    ("C2-remat-dots", "llama4-maverick-400b-a17b", "train_4k",
     {"attn_shard": "heads", "remat": "dots"}),
    ("C3-bf16p", "llama4-maverick-400b-a17b", "train_4k",
     {"attn_shard": "heads", "remat": "dots", "attn_f32_scores": False}),
    ("C4-pad+dots", "llama4-maverick-400b-a17b", "train_4k",
     {"pad_heads_to": 48, "remat": "dots"}),
]
# the iterations whose argument bytes differ from their arch's base cell
# (the padded wq, the TP-only weights): their bytes are pinned
BYTE_PINNED = [name for name, _, _, ov in ITERATIONS
               if "pad_heads_to" in ov or ov.get("fsdp") is False]


def same_as_the_plan(root: pathlib.Path) -> bool:
    """Whether ``ITERATIONS`` is the plan's, entry for entry (its fifth
    field, the hypothesis, dropped)."""
    tree = ast.parse((root / "benchmarks" / "perf_hillclimb.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "ITERATIONS" for t in node.targets):
            plan = ast.literal_eval(node.value)
            return [tuple(it[:4]) for it in plan] == [tuple(it)
                                                     for it in ITERATIONS]
    raise AssertionError("no ITERATIONS in benchmarks/perf_hillclimb.py")


def spec_args() -> list[str]:
    """The ``BYTE_PINNED`` iterations as the spec script's arguments:
    ``name=arch=shape=<overrides as JSON>``."""
    import json
    return [f"{name}={arch}={shape}={json.dumps(ov)}"
            for name, arch, shape, ov in ITERATIONS if name in BYTE_PINNED]
