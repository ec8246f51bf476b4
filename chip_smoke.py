"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python chip_smoke.py                      # every phase, all 4 episodes
    python chip_smoke.py --profile            # also torch.profiler passes
    python chip_smoke.py --profile train      # only the training step's

Phases, each printing JSON lines:

1. device — the card, and ``nvidia-smi``'s name and power limit;
2. build  — compiles ``src/repro_torch/csrc/*.cu`` with nvcc and prints
   what ``ptxas -v`` reports per kernel (registers, shared memory, spills),
   failing if a kernel of the flash backward spills or ptxas warns;
3. kernels — each hand-written kernel against its plain PyTorch version on
   the card over an edge-case sweep and at the main path's shapes (for
   the store kernels also at the median shapes of their call sites in a
   q8_justin episode: the ``sites`` list of their lines), with
   CUDA-event device times (L2 emptied first) of the kernel, the plain
   version and the one PyTorch library call that computes the same
   function, the kernel's time with its inputs in L2, the wrapper's cost
   per call on the host clock, the bound on this run's data (bytes, or
   tensor-core operations for prefill attention), the share of it the
   kernel reaches and its achieved TB/s or TFLOP/s;
4. episodes — the golden autoscaling episodes (q8/q11 x justin/ds2, seed
   3, max_level 2, the reference's full sizes) through the port on the
   card, compared decision for decision with
   ``tests/data/golden_autoscale.json``; kernel launch counts are reset
   just before each episode and read just after, and an episode that
   launched a kernel of its path no time fails;
5. serve — ``repro_torch.launch.serve.serve("llama3.2-3b", reduced=False)``
   on the card at full width: 8 requests of 2,048 prompt tokens, 128
   greedy decode steps; the attention kernels' launch counts are reset
   just before and must be 28 per prefill and 28 per decode step.  Then
   the decode step at position 2,048 is held against a prefill over the
   prompt plus that token (2 requests, max|diff|/max|ref| < 0.03);
6. scenarios — the reconfiguration-pricing, dynamic-scenario and
   shared-cluster layer on the card at the reference's sizes: (a) q8
   justin vs threshold under a savepoint cost model (3 vs 4 steps,
   threshold pays more downtime), (b) q11 under a load spike with a
   straggler and a killed task, traced, the trace passed through
   ``tools/check_trace.py``, (c) the ds2/justin q11 pair on one shared-TM
   cluster under preemption, (d) sampled fleets of 32 tenants x 6 windows
   and 128 x 20.  Each run is held exactly against
   ``tests/data/torch_scenarios.json`` (the reference's answers), (c) and
   (d) also scalar driver against vectorized; each prints its wall
   seconds, store-kernel launches (reset just before; none fails) and
   peak device memory;
7. serve, window and MoE — (a) ``repro_torch.serve``'s
   JustinServeController under ds2, justin and threshold, held exactly
   against ``tests/data/torch_serve.json``; (b) h2o-danube-1.8b at full
   width and depth through ``serve()``: 8 requests of 6,144 prompt tokens
   (past its 4,096-token window) and 128 decode steps, 24 flash launches
   and 3,072 decode launches; (c) mixtral-8x7b at full width, 16 of its
   32 layers: 8 x 2,048 prompt tokens, 128 decode steps, 16 and 2,048
   launches.  (b) and (c) each then hold the decode step at the prompt's
   end against a prefill over one more token (2 requests, < 0.03), and
   (c) prints the assignments its capacity bound dropped; (c) then holds
   one full-width MoE layer, bf16 on the card at the prefill's and a
   decode step's token counts, against a plain float32 version written
   apart from the port's routing buffer (< 0.03, equal drop counts).
   Every line carries its launch counts or peak device memory;
8. chunk, VLM and encoder-decoder — the reference's remaining attention
   families at full width through the port's serve entry point: (a)
   llama4-maverick-400b-a17b, 2 of its 48 layers (one dense, one MoE),
   2 requests of 10,240 prompt tokens across its 8,192-token chunk edge
   and 64 decode steps reading the span from slot 8,192, 2 flash and 128
   decode launches; (b) internvl2-26b at full depth, 8 requests of 256
   image embeddings and 1,792 text tokens, 64 steps, 48 / 3,072
   launches; (c) whisper-medium at full depth, 8 requests of 1,500
   frames and 384 prompt tokens, 64 steps, 72 flash launches (24
   encoder, 24 self, 24 cross) and 48 decode launches a step.  Each then
   holds the decode step at the prompt's end against a prefill over one
   more token (2 requests, < 0.03); each line carries its launch counts
   and peak device memory, and each model is freed before the next;
9. state-space and hybrid — (a) recurrentgemma-2b at full width and depth
   (18 RG-LRU and 8 local-attention layers, head dim 256, 10 q-heads on
   one KV head), 8 requests of 4,096 prompt tokens, past its 2,048-token
   window, and 128 decode steps: 8 flash and 1,024 decode launches;
   (b) mamba2-130m at full width and depth (24 SSD layers), 8 requests
   of 8,192 prompt tokens (32 SSD chunks) and 128 steps: no attention
   kernel, 0 and 0 launches, checked as such.  Each then holds the
   decode step at the prompt's end against a prefill over one more
   token (2 requests, < 0.03), with its peak device memory;
10. training — (a) the flash backward kernel (csrc/flash_attn_bwd.cu)
   against ``flash_attention_bwd_ref`` over a sweep of every mask, group
   and head dim of the trainable families (and the forward's log-sum-exp
   against the plain version's), each case run twice and equal bit for
   bit, then timed at llama3.2-3b's training shape and recurrentgemma's
   (``hybrid_shape``); (b) ``repro_torch.launch.train.train(
   "llama3.2-3b", reduced=False)``: full width and depth, 4 steps on a
   repeated batch of 2 x 2,048 tokens, 56 forward and 28 backward flash
   launches a step, the first loss near a random initialisation's and
   falling, step seconds, tokens/s, peak memory and the model-FLOP
   share; then one full-width layer's gradients through the kernels
   against the same layer in float32 on the plain attention (< 0.03);
   (c) every reduced family's 3 training steps against the reference's
   losses in ``tests/data/torch_train.json``, and a ``fail_at`` restart
   through a checkpoint at reduced size;
11. dry-run — (a) ``launch.elastic.derive_mesh`` over the card (1x1 over
   cuda:0) and ``elastic_restart_plan(512, 500)``; (b) every arch x
   applicable shape lowered by ``launch.dryrun`` on the 16x16 and 2x16x16
   meshes (the meta-device trace's flops) and on the card's 1x1 mesh, each
   cell's per-device argument and output bytes equal to the reference's
   (``tests/data/torch_specs.json``) and held against the card's memory;
   (c) the decode cells whose arguments fit one card (h2o-danube-1.8b,
   recurrentgemma-2b and mamba2-130m at ``decode_32k``, 128 x 32,768, and
   ``long_500k``, 1 x 524,288) run on the card through
   ``dryrun.execute_cell``: first the decode kernel at the cell's own
   shape against its plain version (and bit-equal run again), then the
   bytes asked of the allocator equal the dry-run's argument bytes, each
   serve step at ``t = seq_len - 1`` launches ``decode_attention`` once
   per attention layer (24 / 8 / 0), finite logits, the peak memory and
   the median wall ms of five warm steps; (b) runs after (c), so that its
   worker processes do not share the host with the timed steps;
12. legacy store — (a) the four golden episodes under
   ``state.lsm.set_store_impl("legacy")`` (the frozen pre-columnar store
   and its lexsort installer), decision-identical, ``sorted_probe``
   launched and ``window_agg`` never; (b) the store A/B: q8_justin under
   the legacy and the columnar store, one round, each episode in a fresh
   interpreter, the minimum per store and their ratio beside
   the card's name and power limit;
13. the MoE block across ranks — 8 ranks spawned on the one card
   (``launch.mesh.run_ranks``: a gloo process group, every rank on
   cuda:0, the collectives through host memory): (a) every case of
   ``tests/torch_mesh_cases.py`` (``moe_ffn`` in the "expert", "ffn" and
   "2d" modes on 2x4 and 2x2x2 meshes, the reduced llama4 and mixtral
   decoders' prefill and decode on 2x4, float32) against the reference's
   8-device answers (``tests/data/torch_mesh.json``) within 2e-5, on
   every rank; (b) mixtral-8x7b at full width with 2 of its 32 layers,
   bf16, on a 2x4 mesh in each mode, each rank holding only its blocks of
   the weights (the decoder's sharded step): 8 prompts of 512 tokens and
   2 decode steps fed the greedy tokens of the same layers served 1x1 in
   this process;
   "2d" held to the 1x1 logits and "expert" to "ffn" (< 0.03), the first
   MoE layer alone on one shared input the same way (< 2e-2) with its
   flipped routes, each rank's attention launches (reset just before,
   one flash launch per layer and one decode launch per layer a step),
   prefill s, decode ms a step, collectives a step and memory per mode;
14. the decoder's sharded steps across ranks — 8 ranks on the one card
   again: (a) every case of ``tests/torch_sharded_cases.py`` (reduced
   dense, windowed, MoE and VLM decoders on 2x4 and 2x2x2, every
   ``kv_spec`` branch, a batch of 1; a prefill and 4 decode steps,
   float32) against the reference's 8-device answers
   (``tests/data/torch_sharded.json``) within 2e-5, logits and caches, on
   every rank, each step's collectives equal to a ``CountingMesh``'s
   count; (b) llama3.2-3b at full width, 14 of its 28 layers, bf16, on
   2x4, each rank drawing only its blocks (FSDP over ``data``, TP over
   ``model``):
   8 prompts of 512 tokens and 4 decode steps fed the greedy tokens of
   the port's 1x1 run on the same weights in this process, the gathered
   logits within 0.03 of it, each rank's parameter bytes equal to the
   dry-run's per-device bytes, prefill s, decode ms a step, collectives
   a prefill and a step, each rank's peak; (c) mixtral-8x7b at full
   width with 2 of 32 layers on 2x4, 8 x 512 and 1 decode step: "2d"
   within 0.03 of 1x1, and in "ffn" the experts gathered from their FSDP
   storage into the block's ``in_specs`` equal to ``convert.moe_blocks``'
   blocks bit for bit, the routes that flip against 1x1 counted;
15. training across ranks — 8 ranks on the one card again
   (``make_train_step(..., mctx=)``: every rank holds its blocks of the
   float32 parameters and AdamW moments and runs its part of the forward
   pass, the backward pass through the collectives' transposes and the
   update): (a) every case of ``tests/torch_sharded_train_cases.py``
   (reduced dense, windowed, MoE in each mode and VLM decoders, float32,
   2 steps, on 2x4 and 2x2x2; q heads and KV heads that ``model`` cuts, a
   batch of 1, microbatches) against the reference's jitted 8-device
   train step (``tests/data/torch_sharded_train.json``) within that
   module's bounds (losses, norms, sampled gradient and parameter
   blocks, each leaf's sum of squares), on every rank, each step's
   collectives equal to a ``CountingMesh``'s count; (b) llama3.2-3b at
   full width, 4 of its 28 layers, bf16 compute, float32 parameters and
   moments, ``remat="full"``, on 2x4, 3 steps of a global batch of 2 x
   2,048, each rank drawing only its blocks, every step from the weights of a
   1x1 run of the same batches in the main process (run first, its
   memory freed before the ranks start; it writes the weights each step
   starts from): every step's loss within 1e-2 of 1x1's, each rank's updated
   blocks within 2 x 1.001 x lr of 1x1's next weights (the elements
   beyond 1e-6 counted), and every step's loss and gradient norm taken
   again in float32 compute on the same weights within 1e-4 of 1x1's
   (the bf16 norms reported beside them), 8 forward and 4 backward
   flash launches a rank a step, step s,
   each rank's peak, the collectives a step by kind (forward and
   recompute gathers, reduce-scatters, psums); (c) mixtral-8x7b in "2d"
   at full width, 1 of 32 layers, 2 steps, against 1x1 the same way
   ((b) cut from 28 layers when phase 16 came; under the reference's
   N(0, 0.02) draw of the norm scales a third step's bf16 loss lay 0.0138
   from 1x1's, past the 1e-2 gate, the shallow random model's logits
   being ~4 times larger while its float32 loss was exact, so (b) trains
   with the scales at ones);
16. serving across ranks for the enc-dec, SSM and hybrid families — 8
   ranks on the one card again, on 2x4: (a) every case of
   ``tests/torch_sharded_families_cases.py`` (reduced whisper, mamba2 and
   recurrentgemma, float32, on 2x4 and 2x2x2, every cache layout branch,
   a batch of 1) against the reference's jitted 8-device steps
   (``tests/data/torch_sharded_families.json``) within 2e-5 on every
   rank, each step's collectives equal to a ``CountingMesh``'s count; (b)
   whisper-medium (6 of its 24 encoder and of its 24 decoder layers, 8 x
   384 tokens over 1,500 frames, 2 decode steps), mamba2-130m (full
   depth, 8 x 2,048, 2 steps) and recurrentgemma-2b (full width, 12 of
   its 26 layers, 8 x 512, 2 steps; depths cut so that the whole run
   stays inside its time limit), each rank drawing only its blocks,
   against a 1x1 run on the same weights: the prefill's and every decode
   step's logits within 0.03 (max|Δ| / max|ref|), each rank's
   collectives equal to the dry-run's count of the cell, one flash launch
   per attention a rank a prefill and one decode launch per attention a
   rank a step; prefill s, decode ms a step,
   collectives by kind, each rank's peak;
17. training across ranks for the enc-dec, SSM and hybrid families — 8
   ranks on the one card again, on 2x4 (``make_train_step(..., mctx=)``
   for whisper, mamba2 and recurrentgemma, through the phase 15 body
   ``train_across_ranks``): (a) every case of
   ``tests/torch_sharded_families_train_cases.py`` (reduced whisper,
   mamba2 and recurrentgemma, float32, 2 steps, on 2x4 and 2x2x2; KV heads
   whole and cut, mamba2's heads cut by ``model``, a full hybrid group and
   a tail layer, 10 q heads over 4 ranks, a batch of 1, microbatches)
   against the reference's jitted 8-device train step
   (``tests/data/torch_sharded_families_train.json``) within phase 15
   (a)'s bounds on every rank, each step's collectives equal to a
   ``CountingMesh``'s count; (b) whisper-medium (4 of its 24 encoder and
   of its 24 decoder layers, a global batch of 2 x 448 tokens over 1,500
   frames), mamba2-130m (6 of its 24 layers, 2 x 2,048) and
   recurrentgemma-2b (4 of 26 layers: a full group and a tail layer, 2 x
   2,048) at full width, float32 parameters and moments, bf16 compute,
   ``remat="full"``, norm scales at ones, 2 steps, each rank drawing only
   its blocks, every step from the weights of a 1x1 run of the same
   batches in the main process (the depths cut for time: a rank's step
   goes at the pace of its collective calls through gloo): the gates of
   phase 15 (b) (the first
   1x1 loss within 0.5 of ln V + 0.02^2 d / 2, bf16 losses within 1e-2,
   updated blocks within 2 x 1.001 x lr, float32 losses and norms within
   1e-4), each rank's collectives a step equal to
   ``dryrun.count_collectives``' count of the cell, 2 forward and 1
   backward flash launches per attention a rank a step (mamba2 none);
   step s, each rank's peak, the collectives by kind;
18. the reference's attention and remat knobs (``ArchConfig``'s
   ``remat="dots"``, ``attn_shard`` "seq" and "heads", ``pad_heads_to``,
   as ``benchmarks/perf_hillclimb.py`` sets them): (a) llama3.2-3b at
   full width and depth, 2 x 2,048 tokens, under "full" and then "dots"
   from the same seed, 3 AdamW steps each: the first step's products
   counted (``aten.mm``: under "dots" the backward runs two a forward
   product and the loss chunks' own, no layer product again), losses,
   gradient norms and the parameters after the last step equal (bit for
   bit expected, else within 1e-6 relative), step s and peak GB of
   both; (b) llama3.2-3b at full width, 4 of 28 layers,
   norm scales at ones, on 2x4 under ``attn_shard="seq"`` (each rank its
   block of query positions with every head, keys and values to the
   block's end) and under "auto": 8 x 512 prompts and 2 decode steps fed
   the greedy tokens of its 1x1 run, each within 0.03 of 1x1 and "seq"
   within 0.03 of "auto", each rank's collectives equal to the dry-run's
   count, one flash launch per layer a prefill and one decode launch per
   layer a step; then one pinned "seq" case of
   ``tests/torch_sharded_knobs_train_cases.py`` on every rank (the
   reference's 8-device train step, ``tests/data/torch_sharded_knobs
   .json``) and 2 training steps of 2 x 2,048 under "seq" from 1x1's
   weights every step under phase 15 (b)'s gates; (c) the same model
   with ``pad_heads_to=32`` and ``attn_shard="heads"`` on 2x4 (8 whole
   padded heads a rank), served as (b) against the unpadded model on 1x1
   carried from the padded tree's real-head columns
   (``convert.unpad_heads``), within 0.03.

Phase 3 also checks the decode kernel's first slot ``lo`` (sliding-window
spans: lo 0, inside the first tile, on a tile edge, valid_len - 1, ragged)
and head dim 80 under a binding window and llama4's chunk mask (an edge
inside a query tile, on a tile edge, a chunk smaller than a tile, rows at
negative positions) in the flash kernel, head dim 256 (and 160) in both
flash routes (causal or not, windows, ragged lengths, a chunk, the
[B, S, H, D] view) and groups of 1, 5, 10 and 16 q-heads per KV head at
head dim 128 and 256 in the decode kernel (a group above 8 heads at D
128, or 4 at D 256, runs in sub-groups), and holds and times each
attention kernel at the shape every served model gives it, launched as
the serve path launches it: llama3.2-3b's (the main row),
h2o-danube-1.8b's (``window_shape`` in its lines), mixtral-8x7b's
(``moe_shape``), llama4-maverick's (``chunk_shape``; the flash row also
times the same launch without the chunk, ``unchunked_ms``),
internvl2-26b's (``vlm_shape``), whisper-medium's (``encoder_shape``,
``cross_shape``, ``encdec_self_shape``), recurrentgemma-2b's
(``hybrid_shape``), mixtral-8x7b's as phase 13 (b) serves it on each
of its ranks (``mesh_shape``: 8 x 512 prompts, 514 decode slots) and
llama3.2-3b's as phase 14 (b) serves it on each of its ranks
(``rank_shape``: 4 rows, 6 q heads on 2 KV heads, 512 prompt positions,
516 decode slots), and the flash forward at llama3.2-3b's training shape
on each rank of phase 15 (b) (``train_rank_shape``: 1 row, 6 q heads on
2 KV heads, 2,048 positions, causal), and whisper-medium's and
recurrentgemma-2b's as phase 16 (b) serves them on each rank
(``rank_encoder_shape``: the encoder on 4 rows, 4 of 16 heads, 1,500 x
1,500 positions, not causal; ``rank_cross_shape``: its cross decode over
1,500 slots on those heads; ``rank_hybrid_shape``: the span of 3 of 10
q heads on the one KV head, 4 x 512 positions under the 2,048 window,
and its decode over 514 slots), and the flash forward at whisper-medium's
and recurrentgemma-2b's training shapes on each rank of phase 17 (b)
(``rank_train_encoder_shape``: 1 row, 4 of 16 heads, 1,500 x 1,500, not
causal; ``rank_train_self_shape``: 448 positions, causal;
``rank_train_cross_shape``: 448 against 1,500, not causal;
``rank_train_hybrid_shape``: the span of 3 of 10 q heads on the one KV
head, 2,048 positions under the 2,048 window, D 256), and llama3.2-3b's
on the last rank of phase 18 (b)'s "seq" layout (``seq_rank_shape``: 4
rows, 24 q heads on 8 KV heads, 128 query positions against 512 keys,
causal at the block's place); its sweeps include phase 14 (a)'s reduced
heads (one q head on a KV head at head dim 16).  Its main flash row
also holds the kernel at llama's shape against the plain version's two
readings of ``attn_f32_scores`` (``bf16_p``: P into the P V product in
float32, and rounded to bf16).  Phase 10 (a) times the backward at
those training shapes too (``train_rank_shape``, the four
``rank_train_*_shape`` rows and ``seq_train_rank_shape``: 1 row, 512
query positions against 2,048 keys).

Any mismatch or exception exits non-zero; only after every phase passed
are the kernel table, the ``nvidia-smi`` line and the final
``{"ok": true, ...}`` line printed.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import itertools
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden_autoscale.json"
OUT = ROOT / "chiprun_out"
sys.path.insert(0, str(ROOT / "src"))
# the H100 SXM's data-sheet rates, one source for the port
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOP_PER_S, RankPool)
F32_TOL = dict(rtol=1e-5, atol=1e-4)   # atomic f32 sums, order varies
# attention, checked per output vector (one (b, head, query) row over D):
# max|got - want| <= rel * max|want| + atol.  f32 sums differ from the
# plain version's only in order.  bf16: both round the output to bf16 and
# the flash kernel rounds the probabilities to bf16 for the tensor-core
# product, so a vector may land up to two bf16 steps of its largest
# element (2^-6 of it) away; a vector that has lost or gained a few keys
# moves further (most vectors of the serve shapes even for one key)
ATTN_TOL = {"float32": dict(rel=0.0, atol=1e-5),
            "bfloat16": dict(rel=2.0 ** -6, atol=1e-6)}
ARCH = "llama3.2-3b"
SERVE = dict(requests=8, prompt_len=2048, decode=128)
# the attention kernels' rows at the other served models' shapes (phase 3)
SHAPE_KEYS = ("window_shape", "moe_shape", "chunk_shape", "vlm_shape",
              "encoder_shape", "cross_shape", "encdec_self_shape",
              "hybrid_shape", "mesh_shape", "rank_shape",
              "train_rank_shape", "rank_encoder_shape", "rank_cross_shape",
              "rank_hybrid_shape", "rank_train_encoder_shape",
              "rank_train_self_shape", "rank_train_cross_shape",
              "rank_train_hybrid_shape", "seq_rank_shape",
              "seq_train_rank_shape")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# sources whose every kernel must build with no spill and no ptxas warning
# (C7513: wgmma serialised): the flash backward's wgmma kernels hold dK
# and dV, or dQ, in registers for a whole walk, the decode kernels their
# accumulators (bf16: 16 x D / 32 floats a thread)
PTXAS_CLEAN = ("flash_attn_bwd.cu", "decode_attn.cu")


def ptxas_clean(report: dict, sources) -> None:
    """Raise if ``_build.build_info["ptxas"]`` shows, for one of
    ``sources``, a kernel that spills or any ptxas warning."""
    for src in sources:
        lines = report[src]
        bad = [ln for ln in lines if "warning" in ln or (
            "spill" in ln and not re.search(
                r"\b0 bytes spill stores, 0 bytes spill loads", ln))]
        if not lines or bad:
            raise AssertionError(f"ptxas on {src}: {bad or 'no report'}")


def smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


SECTOR = 32                        # bytes per L2 sector, the unit HBM serves
SPIN_CYCLES = 4_000_000            # ~2 ms of device spin, see device_ms


def device_ms(fn, cold: bool, reps: int = 30) -> float:
    """Device ms per call of ``fn``, between CUDA events, median of ``reps``.

    Every measurement starts with a spin kernel that keeps the card busy
    while the host queues the events and the calls, so the events bracket
    device work and not the host's launch rate.  ``cold``: one call per
    measurement, after a 256 MiB write that evicts the 50 MB L2, so the
    inputs come from HBM (the regime ``bound_ms`` assumes).  Otherwise 50
    back-to-back calls per measurement with the inputs left in L2.
    A ``fn`` that synchronises with the host is charged its idle gap."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    calls = 1 if cold else 50
    per = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / calls)
    return statistics.median(per)


def call_ms(fn, reps: int = 50, rounds: int = 7) -> float:
    """Host-clock ms per call of ``fn`` over back-to-back calls ending in a
    synchronise: what a caller pays per call, host work included."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(per)


def probe_bytes(table, q, pos) -> int:
    """Bytes the probe must move on this data: each query read, each
    position and flag written, and the table sectors that hold each
    query's neighbours table[pos-1] and table[pos] (a rank is not known
    without them)."""
    import torch
    t, n, w = len(table), len(q), table.element_size()
    p = pos.long()
    near = torch.cat([p[p > 0] - 1, p[p < t]])
    return n * (q.element_size() + 4 + 1) \
        + len(torch.unique(near * w // SECTOR)) * SECTOR


def add_rates(res: dict, amount: float, unit: str) -> dict:
    """Add the share of the bound that ``ms`` reaches and the rate it
    achieves: ``amount`` bytes (unit TB/s) or FLOP (TFLOP/s) per call."""
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["achieved"] = amount / res["ms"] * 1e3 / 1e12
    res["achieved_unit"] = unit
    return res


# ------------------------------------------------------------ sorted_probe
# the parts each step of a route cuts a range into: the cooperative
# route's 33, the indexed route's 513 (splitters + 1)
PROBE_PARTS = (33, 513)


def probe_cases(torch, dev):
    """(label, table, queries) covering the edge cases and the main path,
    and for the routes: tables of P^m +- 1 entries for the parts P a step
    of each route cuts its range into, batches smaller than a warp,
    unsorted queries with repeats against a small and a large table, and
    the dtype's min and max."""
    g = torch.Generator(device="cpu").manual_seed(11)
    cases = []
    for dt in (torch.int32, torch.int64):
        info = torch.iinfo(dt)
        lo, hi = info.min, info.max

        def t(x):
            return torch.as_tensor(x, dtype=dt).to(dev)

        base = torch.unique(torch.randint(0, 1 << 30, (100_003,),
                                          generator=g)).to(dt)
        q = torch.cat([base[torch.randint(0, len(base), (35_001,),
                                          generator=g)],
                       torch.randint(0, 1 << 30, (35_000,),
                                     generator=g).to(dt)])
        cases.append((f"{dt}:random T={len(base)} N={len(q)}",
                      base.to(dev), q.to(dev)))
        cases.append((f"{dt}:off-tile T=2049 N=513",
                      t(list(range(0, 2049 * 3, 3))),
                      t(torch.randint(0, 2049 * 3 + 5, (513,), generator=g))))
        cases.append((f"{dt}:dtype max absent", t([0, 17, 99]),
                      t([hi, 0, hi, 17, 100])))
        cases.append((f"{dt}:dtype max present", t([0, 17, hi]),
                      t([0, 1, hi, hi - 1])))
        cases.append((f"{dt}:dtype min and max present", t([lo, 0, hi]),
                      t([lo, lo + 1, hi, hi - 1, 0, -1])))
        cases.append((f"{dt}:dtype min and max absent", t([lo + 1, hi - 1]),
                      t([hi, lo, lo + 1, hi - 1, lo + 2])))
        cases.append((f"{dt}:empty table", t([]), t([1, 2, hi])))
        cases.append((f"{dt}:one entry", t([42]), t([41, 42, 43, hi])))
        cases.append((f"{dt}:duplicate queries", t(list(range(0, 1000, 7))),
                      t([700] * 2048 + [701] * 3)))
        cases.append((f"{dt}:duplicate table entries", t([5, 5, 5, 9, 9]),
                      t([5, 7, 9, 10])))
        cases.append((f"{dt}:exact tile multiple",
                      t(list(range(0, 2048 * 3, 3))),
                      t(list(range(1, 512 * 3, 3)))))
        # T = P^m +- 1: the steps end exactly on a boundary
        for parts in PROBE_PARTS:
            for m in (1, 2, 3):
                if parts ** m > 300_000:
                    continue
                for dlt in (-1, 0, 1):
                    size = parts ** m + dlt
                    tab = torch.sort(torch.randint(0, 4 * size, (size,),
                                                   generator=g)).values
                    qs = torch.cat([tab[torch.randint(0, size, (300,),
                                                      generator=g)],
                                    torch.randint(-2, 4 * size + 3, (300,),
                                                  generator=g)])
                    cases.append((f"{dt}:T={parts}^{m}{dlt:+d} N=600",
                                  tab.to(dt).to(dev), qs.to(dt).to(dev)))
        # fewer queries than a warp's lanes
        big = torch.unique(torch.randint(0, 1 << 30, (20_001,),
                                         generator=g)).to(dt)
        for nq in (1, 3, 7):
            cases.append((f"{dt}:N={nq} T={len(big)}", big.to(dev),
                          big[torch.randint(0, len(big), (nq,),
                                            generator=g)].to(dev)))
        # unsorted queries with repeats, against the inverse map's table
        # size (T=465) and a large one
        for size in (465, 60_000):
            tab = torch.unique(torch.randint(0, 1 << 29, (size,),
                                             generator=g)).to(dt)
            qs = torch.cat([tab[torch.randint(0, len(tab), (700,),
                                              generator=g)],
                            torch.randint(0, 1 << 29, (200,),
                                          generator=g).to(dt)])
            qs = qs[torch.randperm(len(qs), generator=g)]
            cases.append((f"{dt}:unsorted N={len(qs)} T={len(tab)}",
                          tab.to(dev), qs.to(dev)))
    # int64 only: runs of repeats, as the legacy store's CLOCK rounds
    # probe their sorted set ids against themselves (state/legacy.py
    # ``_cache_apply``'s rank), at >= 4,096 queries so the plan takes the
    # splitter-indexed route: short runs probed by the table itself, and
    # runs longer than a splitter interval probed by present and absent ids
    short = torch.sort(torch.randint(0, 20_000, (120_000,),
                                     generator=g)).values
    cases.append(("int64:runs of repeats T=120000 N=120000 (itself)",
                  short.to(dev), short.to(dev)))
    long_ = torch.sort(torch.randint(0, 50, (100_003,), generator=g) * 3
                       ).values
    lq = torch.randint(-2, 153, (6_000,), generator=g)
    cases.append(("int64:long runs of repeats T=100003 N=6000",
                  long_.to(dev), lq.to(dev)))
    # int64 only: high-bit keys and the packed (i << 45) | key memtable probe
    high = torch.unique(torch.randint(1 << 40, 1 << 62, (50_001,),
                                      generator=g) * 2 + 1)
    high = torch.cat([high, torch.tensor([(1 << 63) - 1])])
    hq = torch.cat([high[::3], high[::5] - 1,
                    torch.tensor([(1 << 63) - 2, (1 << 63) - 1, -(1 << 63)])])
    cases.append(("int64:high-bit keys", high.to(dev), hq.to(dev)))
    runs = [torch.unique(torch.randint(0, 1 << 45, (3_001 + 7 * i,),
                                       generator=g)) for i in range(9)]
    packed = torch.cat([(i << 45) + r for i, r in enumerate(runs)])
    uq = torch.unique(torch.cat([runs[0][:500], runs[8][-400:],
                                 torch.randint(0, 1 << 45, (900,),
                                               generator=g)]))
    qq = ((torch.arange(9)[:, None] << 45) + uq[None, :]).reshape(-1)
    cases.append(("int64:packed (i<<45)|key", packed.to(dev), qq.to(dev)))
    return cases


def probe_routes(table) -> list:
    """The routes (lanes per query) a table can take: the cooperative one,
    and the indexed one for a table of one entry or more."""
    return [32, 1] if len(table) else [32]


def probe_check(torch, table, q, got, label: str) -> None:
    """Raise unless (pos, found) ``got`` equals the plain version's."""
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref
    if len(table):
        rpos, rfound = sorted_probe_ref(table, q)
    else:
        rpos = torch.zeros(len(q), dtype=torch.int32, device=q.device)
        rfound = torch.zeros(len(q), dtype=torch.bool, device=q.device)
    pos, found = got
    if pos.dtype != torch.int32 or not (
            torch.equal(pos, rpos) and torch.equal(found, rfound)):
        raise AssertionError(f"sorted_probe mismatch on {label}")


def probe_sweep(torch, dev) -> int:
    """Every ``probe_cases`` case through the wrapper (the plan's route)
    and through the bare launch of each route that can take it, held
    exactly against the plain version; returns the runs made, raises on a
    mismatch."""
    from repro_torch.kernels.sorted_probe.kernel import sorted_probe
    runs = 0
    for label, table, q in probe_cases(torch, dev):
        probe_check(torch, table, q, sorted_probe(table, q), label)
        runs += 1
        for lanes in probe_routes(table):
            launch, got, _ = probe_launch(torch, table, q, lanes)
            launch()
            probe_check(torch, table, q, got, f"{label}, lanes {lanes}")
            runs += 1
    torch.cuda.synchronize()
    return runs


def probe_main_shape(torch, dev):
    """A level probe at the largest size the store holds: 65,536 sorted
    unique int64 queries (half present) into a 2.4 M-entry run (q8's warmed
    state)."""
    g = torch.Generator(device="cpu").manual_seed(12)
    table = torch.unique(torch.randint(0, 1 << 40, (2_450_000,),
                                       generator=g))[:2_400_000]
    q = torch.unique(torch.cat([
        table[torch.randint(0, len(table), (32_768,), generator=g)],
        torch.randint(0, 1 << 40, (40_000,), generator=g)]))[:65_536]
    return table.to(dev), q.to(dev)


def _sorted_keys(torch, g, size: int, top: int):
    """``size`` sorted unique int64 keys below ``top``."""
    k = torch.unique(torch.randint(0, top, (size + size // 8 + 16,),
                                   generator=g))
    return k[torch.randperm(len(k), generator=g)[:size]].sort().values


def _some_present(torch, g, table, size: int, top: int):
    """``size`` sorted unique int64 queries, about half of them in
    ``table``."""
    both = torch.unique(torch.cat([
        table[torch.randint(0, len(table), (size // 2,), generator=g)],
        _sorted_keys(torch, g, size, top)]))
    return both[torch.randperm(len(both), generator=g)[:size]].sort().values


def probe_sites(torch, dev):
    """The store's five probe call sites at the median N and T a q8_justin
    episode gives them (4,313 probes, counted on the CPU, where the episode
    makes the same calls as on the card): (site, table, queries, sorted)."""
    g = torch.Generator(device="cpu").manual_seed(13)
    top = 1 << 45
    sites = []
    # get_batch's inverse map: the batch's keys (unsorted, repeated)
    # against their own sorted unique keys
    uq = _sorted_keys(torch, g, 465, top)
    keys = torch.cat([uq, uq[torch.randint(0, 465, (1,), generator=g)]])
    keys = keys[torch.randperm(len(keys), generator=g)]
    sites.append(("lsm.get_batch inverse map", uq, keys, False))
    # the packed source-major memtable probe: 3 runs, 943 keys each
    runs = [_sorted_keys(torch, g, n, top) for n in (13_709, 13_709, 13_708)]
    packed = torch.cat([(i << 45) + r for i, r in enumerate(runs)])
    uq = _some_present(torch, g, runs[0], 943, top)
    qq = ((torch.arange(3)[:, None] << 45) + uq[None, :]).reshape(-1)
    sites.append(("lsm.get_batch packed memtable probe", packed, qq,
                  True))
    run = _sorted_keys(torch, g, 266_800, top)
    sites.append(("lsm._probe_run", run,
                  _some_present(torch, g, run, 276, top), True))
    newer = _sorted_keys(torch, g, 8_081, top)
    sites.append(("lsm.merge_delta_runs", newer,
                  _some_present(torch, g, newer, 12_504, top), True))
    # partition bounds: sorted partition ids of 60,000 rows, 4 edges
    part = torch.randint(0, 3, (60_000,), generator=g).sort().values
    sites.append(("engine._partition_bounds", part,
                  torch.arange(4), True))
    return [(s, t.to(dev), q.to(dev), srt) for s, t, q, srt in sites]


def probe_launch(torch, table, q, lanes=None):
    """(the bare launch of the probe kernel into preallocated outputs, its
    outputs, its lanes per query); ``lanes`` None takes the plan's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sorted_probe.kernel import (probe_blocks,
                                                         probe_plan)
    n, t = len(q), len(table)
    if lanes is None:
        lanes = probe_plan(n, t)[0]
    pos = torch.empty(n, dtype=torch.int32, device=q.device)
    found = torch.empty(n, dtype=torch.bool, device=q.device)
    fn = getattr(_build.library(), "sorted_probe_i64"
                 if table.dtype == torch.int64 else "sorted_probe_i32")
    args = (table.data_ptr(), t, q.data_ptr(), n, pos.data_ptr(),
            found.data_ptr(), lanes, probe_blocks(n, lanes),
            torch.cuda.current_stream().cuda_stream)
    return (lambda: fn(*args)), (pos, found), lanes


def check_probe(torch, dev) -> dict:
    """The sweep, then at each census site and the main shape the
    wrapper's result held exactly against the plain version, and the bare
    launch of the plan's route timed."""
    from repro_torch.kernels.sorted_probe.kernel import sorted_probe
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref
    runs = probe_sweep(torch, dev)
    sites = []
    for site, table, q, srt in probe_sites(torch, dev):
        probe_check(torch, table, q, sorted_probe(table, q), site)
        launch, _, lanes = probe_launch(torch, table, q)
        lib_out = torch.empty(len(q), dtype=torch.int64, device=dev)
        sites.append({
            "site": site, "n": len(q), "t": len(table),
            "queries_sorted": srt, "lanes": lanes,
            "ms": device_ms(launch, cold=True),
            "warm_ms": device_ms(launch, cold=False),
            "library_ms": device_ms(
                lambda: torch.searchsorted(table, q, out=lib_out),
                cold=True)})
    table, q = probe_main_shape(torch, dev)
    got = sorted_probe(table, q)
    probe_check(torch, table, q, got, "the main shape")
    launch, _, lanes = probe_launch(torch, table, q)
    n, t = len(q), len(table)
    lib_out = torch.empty(n, dtype=torch.int64, device=dev)
    must = probe_bytes(table, q, got[0])
    res = {
        "name": "sorted_probe", "route": "cuda",
        "source": "src/repro_torch/csrc/sorted_probe.cu",
        "replaces": "src/repro/kernels/sorted_probe/kernel.py:56",
        "max_abs_err": 0, "sweep_runs": runs,
        "shape": f"T={t} int64, N={n} sorted queries, {lanes} lane(s) a "
                 f"query",
        "ms": device_ms(launch, cold=True),
        "warm_ms": device_ms(launch, cold=False),
        "wrapper_ms": call_ms(lambda: sorted_probe(table, q)),
        "plain_ms": device_ms(lambda: sorted_probe_ref(table, q), cold=True),
        "library_ms": device_ms(
            lambda: torch.searchsorted(table, q, out=lib_out), cold=True),
        "bound_bytes": must,
        "bound_ms": must / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "sites": sites,
    }
    add_rates(res, must, "TB/s")
    emit({"phase": "kernel", **res})
    return res


# -------------------------------------------------------------- window_agg
def _runs_to_ids(torch, lengths):
    """Sorted segment ids 0, 1, ... repeated by ``lengths``."""
    return torch.repeat_interleave(torch.arange(len(lengths)), lengths)


def agg_cases(torch, dev):
    """(label, seg_ids, values, S): f32 with V 1 and 4, int64 (the store's
    exact weights), int32 and int64 ids; runs that straddle the edges of a
    lane's 4 rows, a warp's 128 and a block's 1,024; one segment over all
    rows whose int64 sum wraps; unsorted ids in runs; ids of -1 and >= S,
    among them int64 ids past 2^32 that an int32 cast would alias."""
    g = torch.Generator(device="cpu").manual_seed(21)
    cases = []
    for v in (1, 4):
        seg = torch.randint(-1, 513, (1025,), generator=g, dtype=torch.int32)
        vals = torch.randn((1025, v), generator=g)
        cases.append((f"f32 V={v} N=1025 S=513 with -1 ids", seg.to(dev),
                      vals.to(dev), 513))
        seg = torch.sort(torch.randint(0, 40_000, (100_003,), generator=g,
                                       dtype=torch.int32)).values
        vals = torch.randn((100_003, v), generator=g)
        cases.append((f"f32 V={v} N=100003 sorted ids", seg.to(dev),
                      vals.to(dev), 40_000))
    seg = torch.randint(-1, 2000, (50_001,), generator=g, dtype=torch.int32)
    vals = torch.randint(-(1 << 40), 1 << 40, (50_001, 1), generator=g)
    cases.append(("int64 N=50001 S=2000 with -1 ids", seg.to(dev),
                  vals.to(dev), 2000))
    # run lengths around the lane (4 rows), warp (128) and block (1,024)
    edges = torch.tensor([1, 2, 3, 4, 5, 7, 8, 9, 127, 128, 129, 255, 256,
                          1023, 1024, 1025, 2047, 2049])
    lengths = edges[torch.randint(0, len(edges), (400,), generator=g)]
    for idt in (torch.int32, torch.int64):
        seg = _runs_to_ids(torch, lengths).to(idt)
        vals = torch.randint(-(1 << 50), 1 << 50, (len(seg), 1), generator=g)
        cases.append((f"int64 {idt} ids, runs across lane/warp/block edges "
                      f"N={len(seg)}", seg.to(dev), vals.to(dev),
                      len(lengths)))
        # whole numbers: f32 sums exact in any order, however long the run
        vals = torch.randint(-8, 9, (len(seg), 4), generator=g).float()
        cases.append((f"f32 V=4 {idt} ids, runs across edges", seg.to(dev),
                      vals.to(dev), len(lengths)))
    for n in (1, 3, 4, 5, 129, 1025, 100_003):
        vals = torch.full((n, 1), (1 << 62) + 12345, dtype=torch.int64)
        vals[::3] = -(1 << 61) - 7
        cases.append((f"int64 one segment over N={n}, sum wraps",
                      torch.zeros(n, dtype=torch.int64).to(dev),
                      vals.to(dev), 1))
    ids = torch.randint(0, 3000, (20_000,), generator=g)
    seg = torch.repeat_interleave(ids, torch.randint(1, 7, (20_000,),
                                                     generator=g))
    vals = torch.randint(-(1 << 40), 1 << 40, (len(seg), 1), generator=g)
    cases.append((f"int64 unsorted ids in runs N={len(seg)}", seg.to(dev),
                  vals.to(dev), 3000))
    seg = torch.randint(-3, 3003, (30_000,), generator=g)
    seg[::7] = (1 << 32) + torch.randint(0, 3000, (len(seg[::7]),),
                                         generator=g)
    seg[::11] = -(1 << 33)
    vals = torch.randint(-(1 << 40), 1 << 40, (30_000, 1), generator=g)
    cases.append(("int64 ids: -1, >= S and past 2^32 skipped", seg.to(dev),
                  vals.to(dev), 3000))
    cases.append(("int64 S=0, every id skipped",
                  torch.randint(-1, 5, (300,), generator=g).to(dev),
                  torch.randint(-9, 9, (300, 1), generator=g).to(dev), 0))
    cases.append(("int64 N=0", torch.zeros(0, dtype=torch.int32).to(dev),
                  torch.zeros((0, 1), dtype=torch.int64).to(dev), 16))
    cases.append(("f32 N=0", torch.zeros(0, dtype=torch.int32).to(dev),
                  torch.zeros((0, 2)).to(dev), 8))
    return cases


def agg_sweep(torch, dev) -> tuple[float, int]:
    """Every ``agg_cases`` case through the kernel and its plain version:
    int64 exact, f32 within ``F32_TOL`` (sums in another order), counts
    exact; (worst f32 max|diff|, cases run); raises on a mismatch."""
    from repro_torch.kernels.window_agg.kernel import window_agg
    from repro_torch.kernels.window_agg.ref import window_agg_ref
    worst = 0.0
    cases = agg_cases(torch, dev)
    for label, seg, vals, s in cases:
        sums, counts = window_agg(seg, vals, s)
        rsums, rcounts = window_agg_ref(seg, vals, s)
        if sums.shape != rsums.shape or counts.dtype != rcounts.dtype \
                or not torch.equal(counts, rcounts):
            raise AssertionError(f"window_agg counts mismatch on {label}")
        if vals.dtype == torch.int64:
            if not torch.equal(sums, rsums):
                raise AssertionError(f"window_agg int64 mismatch on {label}")
        else:
            torch.testing.assert_close(sums, rsums, **F32_TOL)
            if len(sums):
                worst = max(worst, float((sums - rsums).abs().max()))
    torch.cuda.synchronize()
    return worst, len(cases)


def _gids(torch, first):
    """The store's group ids: int64, ``cumsum`` of the first-of-key mask."""
    return torch.cumsum(first, 0) - 1


def agg_main_shape(torch, dev):
    """The consolidation/compaction segment sum at the size of q8's largest
    compaction: 1 M int64 weights over key-sorted int64 group ids (mostly
    1-2 per key)."""
    g = torch.Generator(device="cpu").manual_seed(22)
    keys = torch.sort(torch.randint(0, 700_000, (1_000_000,),
                                    generator=g)).values
    first = torch.ones(len(keys), dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    w = torch.randint(1, 1 << 20, (len(keys), 1), generator=g)
    return _gids(torch, first).to(dev), w.to(dev), int(first.sum())


def agg_site(torch, dev):
    """The segment sum a q8_justin episode makes at its median (174 calls,
    counted on the CPU): 6,667 int64 weights, 1.03 rows per segment."""
    g = torch.Generator(device="cpu").manual_seed(23)
    first = torch.rand(6_667, generator=g) >= 0.03
    first[0] = True
    w = torch.randint(1, 1 << 20, (6_667, 1), generator=g)
    return _gids(torch, first).to(dev), w.to(dev), int(first.sum())


def agg_launch(torch, gids, w, s):
    """The bare launch into preallocated sums and counts, which it
    zeroes, as the wrapper's."""
    from repro_torch.kernels import _build
    n, v = w.shape
    sums = torch.empty((s, v), dtype=w.dtype, device=w.device)
    counts = torch.empty(s, dtype=w.dtype, device=w.device)
    fn = _build.library().window_agg_i64
    args = (gids.data_ptr(), gids.element_size(), w.data_ptr(), n, v, s,
            sums.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return lambda: fn(*args)


def agg_bound_bytes(gids, w, s) -> int:
    """Ids and values read once, sums and counts written once."""
    n, v = w.shape
    return n * (gids.element_size() + w.element_size() * v) \
        + s * w.element_size() * (v + 1)


def check_agg(torch, dev) -> dict:
    from repro_torch.kernels.window_agg.kernel import window_agg
    from repro_torch.kernels.window_agg.ref import window_agg_ref
    worst, n_cases = agg_sweep(torch, dev)
    sites = []
    main_shape = agg_main_shape(torch, dev)
    for name, (gids, w, s) in (("lsm._collapse (median)",
                                agg_site(torch, dev)),
                               ("main shape", main_shape)):
        sums, counts = window_agg(gids, w, s)
        rsums, rcounts = window_agg_ref(gids, w, s)
        if not (torch.equal(sums, rsums) and torch.equal(counts, rcounts)):
            raise AssertionError(f"window_agg mismatch at the {name}")
        launch = agg_launch(torch, gids, w, s)
        acc = torch.zeros_like(rsums)
        must = agg_bound_bytes(gids, w, s)
        sites.append({
            "site": name, "n": len(gids), "segments": s,
            "ms": device_ms(launch, cold=True),
            "warm_ms": device_ms(launch, cold=False),
            "library_ms": device_ms(lambda: acc.index_add_(0, gids, w),
                                    cold=True),
            "bound_bytes": must, "bound_ms": must / HBM_BYTES_PER_S * 1e3})
    main = sites.pop()
    gids, w, s = main_shape
    n, v = w.shape
    res = {
        "name": "window_agg", "route": "cuda",
        "source": "src/repro_torch/csrc/window_agg.cu",
        "replaces": "src/repro/kernels/window_agg/kernel.py:55",
        "max_abs_err": worst, "sweep_cases": n_cases,
        "shape": f"N={n} int64 weights, int64 ids, S={s} sorted segments, "
                 f"V={v}",
        "ms": main["ms"], "warm_ms": main["warm_ms"],
        "wrapper_ms": call_ms(lambda: window_agg(gids, w, s)),
        "plain_ms": device_ms(lambda: window_agg_ref(gids, w, s), cold=True),
        "library_ms": main["library_ms"],
        "bound_bytes": main["bound_bytes"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "sites": sites,
    }
    add_rates(res, main["bound_bytes"], "TB/s")
    emit({"phase": "kernel", **res})
    return res


# --------------------------------------------------------- flash_attention
def _randn(torch, g, shape, dev, dtype):
    return torch.randn(shape, generator=g).to(dev, dtype)


def attn_err(torch, got, want, dtype: str, label: str) -> tuple[float, float]:
    """(max|got - want|, the largest share of its vector's max|want| that
    a vector's max|got - want| takes); raises unless every output vector
    is within ATTN_TOL[dtype] (NaN is not)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    tol = ATTN_TOL[dtype]
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    bad = ~(diff <= tol["rel"] * scale + tol["atol"])
    if bool(bad.any()):
        raise AssertionError(
            f"{label}: {int(bad.sum())} of {bad.numel()} output vectors "
            f"off, worst max|diff| {float(diff.max())}")
    return vector_err(got, want)


def vector_err(got, want) -> tuple[float, float]:
    """(max|got - want|, the largest share of its vector's max|want| that
    a vector's max|got - want| takes), checking nothing."""
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    return float(diff.max()), float((diff / scale.clamp_min(1e-30)).max())


def flash_cases(torch, dev):
    """(label, dtype name, q, k, v, causal, window) over Sq/Skv 1, 7, 300,
    513, 2048 (and Sq < Skv, and Sq > Skv, where causal leaves the first
    rows no key), D 64/80/128, GQA 1/3/4, causal on and off, window None
    and 64, bf16 and f32."""
    g = torch.Generator(device="cpu").manual_seed(31)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for sq, skv in ((1, 1), (7, 7), (300, 300), (513, 513),
                        (2048, 2048), (7, 300), (1, 513), (513, 300)):
            for d in (64, 80, 128):
                for hq, hk in ((4, 4), (3, 1), (8, 2)):
                    b = 1 if sq == 2048 else 2
                    q = _randn(torch, g, (b, hq, sq, d), dev, dt)
                    k = _randn(torch, g, (b, hk, skv, d), dev, dt)
                    v = _randn(torch, g, (b, hk, skv, d), dev, dt)
                    for causal in (True, False):
                        for window in (None, 64):
                            yield (f"{name} Sq={sq} Skv={skv} D={d} "
                                   f"{hq}:{hk} causal={causal} "
                                   f"window={window}",
                                   name, q, k, v, causal, window)


def flash_layout_cases(torch, dev):
    """bf16 operands in the layouts the tensor maps must take: q as a
    [B, S, H, D] buffer seen as [B, H, S, D] (the serve path's view, read
    in place) at Sq 300 and 2048, D 80 and 128; and q, k, v whose seq
    stride is 68 elements (136 bytes, not a multiple of 16), which the
    wrapper copies first."""
    g = torch.Generator(device="cpu").manual_seed(33)
    dt = torch.bfloat16
    for s in (300, 2048):
        for d in (80, 128):
            b, hq, hk = 2, 6, 2
            q = _randn(torch, g, (b, s, hq, d), dev, dt).transpose(1, 2)
            k = _randn(torch, g, (b, hk, s, d), dev, dt)
            v = _randn(torch, g, (b, hk, s, d), dev, dt)
            for causal in (True, False):
                yield (f"bfloat16 [B,S,H,D] view Sq=Skv={s} D={d} 6:2 "
                       f"causal={causal}", "bfloat16", q, k, v, causal, None)
    q, k, v = (_randn(torch, g, (2, h, 300, 68), dev, dt)[..., :64]
               for h in (4, 2, 2))
    yield ("bfloat16 seq stride 136 B (copied) Sq=Skv=300 D=64 4:2 causal",
           "bfloat16", q, k, v, True, None)


def flash_window_cases(torch, dev):
    """Head dim 80 (a full 64-column TMA panel plus a 16-column one read
    out of bounds) under a window that binds: Sq = Skv 2,048 and 4,200
    (window 512 and 4,096), Sq 1,000 against Skv 3,000 (suffix aligned,
    window 700), window 1 (the diagonal alone), a window without the
    causal mask, and q as the serve path's [B, S, H, D] view; bf16 and
    f32, GQA 4:1 and 8:2."""
    g = torch.Generator(device="cpu").manual_seed(34)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for b, sq, skv, hq, hk, causal, window in (
                (2, 2048, 2048, 4, 1, True, 512),
                (1, 4200, 4200, 4, 1, True, 4096),
                (2, 1000, 3000, 8, 2, True, 700),
                (2, 300, 300, 8, 2, True, 1),
                (2, 513, 513, 4, 1, False, 128)):
            q = _randn(torch, g, (b, hq, sq, 80), dev, dt)
            k = _randn(torch, g, (b, hk, skv, 80), dev, dt)
            v = _randn(torch, g, (b, hk, skv, 80), dev, dt)
            yield (f"{name} Sq={sq} Skv={skv} D=80 {hq}:{hk} causal={causal} "
                   f"window={window}", name, q, k, v, causal, window)
    dt = torch.bfloat16
    q = _randn(torch, g, (2, 2048, 8, 80), dev, dt).transpose(1, 2)
    k = _randn(torch, g, (2, 2, 2048, 80), dev, dt)
    v = _randn(torch, g, (2, 2, 2048, 80), dev, dt)
    yield ("bfloat16 [B,S,H,D] view Sq=Skv=2048 D=80 8:2 causal window=1000",
           "bfloat16", q, k, v, True, 1000)


def flash_chunk_cases(torch, dev):
    """(label, dtype name, q, k, v, causal, window, chunk): llama4's local
    chunk in both routes (bf16 128-row tiles, f32 64-row tiles): a chunk
    edge inside a query tile (300), on tile edges (256), a chunk smaller
    than a tile (48), rows at negative positions (causal with Sq > Skv:
    the first rows see no key), suffix-aligned queries (Sq < Skv), a
    window with a chunk, no causal mask (keys past the row's chunk cut
    too), D 64 / 80 / 128, GQA 5:1 and 6:1 (llama4's and internvl2's
    groups), and q as the serve path's [B, S, H, D] view."""
    g = torch.Generator(device="cpu").manual_seed(36)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for b, sq, skv, hq, hk, d, causal, window, chunk in (
                (1, 1000, 1000, 5, 1, 128, True, None, 300),
                (1, 1024, 1024, 6, 1, 128, True, None, 256),
                (2, 300, 300, 5, 1, 64, True, None, 48),
                (1, 700, 300, 6, 1, 128, True, None, 64),
                (1, 200, 1000, 5, 1, 80, True, None, 384),
                (1, 1000, 1000, 6, 2, 128, True, 200, 300),
                (1, 513, 513, 5, 1, 64, False, None, 100)):
            q = _randn(torch, g, (b, hq, sq, d), dev, dt)
            k = _randn(torch, g, (b, hk, skv, d), dev, dt)
            v = _randn(torch, g, (b, hk, skv, d), dev, dt)
            yield (f"{name} Sq={sq} Skv={skv} D={d} {hq}:{hk} "
                   f"causal={causal} window={window} chunk={chunk}", name,
                   q, k, v, causal, window, chunk)
    dt = torch.bfloat16
    q = _randn(torch, g, (2, 1500, 10, 128), dev, dt).transpose(1, 2)
    k = _randn(torch, g, (2, 2, 1500, 128), dev, dt)
    v = _randn(torch, g, (2, 2, 1500, 128), dev, dt)
    yield ("bfloat16 [B,S,H,D] view Sq=Skv=1500 D=128 10:2 causal "
           "chunk=1000", "bfloat16", q, k, v, True, None, 1000)


def flash_d256_cases(torch, dev):
    """(label, dtype name, q, k, v, causal, window, chunk) above head dim
    128, the instantiations that take 64-key tiles in a two-stage ring
    (bf16) and 32-row tiles (f32): D 256 (four full panels) and D 160
    (two and a half), causal or not, a window that binds (1, 256 and
    recurrentgemma's 2,048 over 4,096 positions), ragged Sq and Skv
    (Sq < Skv, and Sq > Skv where the first rows see no key), a chunk, GQA
    10:1 (recurrentgemma's MQA group), 4:2 and 1:1, and q as the serve
    path's [B, S, H, D] view; bf16 and f32."""
    g = torch.Generator(device="cpu").manual_seed(50)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for b, sq, skv, hq, hk, d, causal, window, chunk in (
                (2, 300, 300, 10, 1, 256, True, None, None),
                (1, 1000, 1000, 10, 1, 256, True, 256, None),
                (2, 7, 300, 4, 2, 256, True, None, None),
                (2, 513, 300, 3, 1, 256, True, None, None),
                (1, 513, 513, 10, 1, 256, False, 128, None),
                (2, 300, 300, 2, 2, 256, True, 1, None),
                (1, 700, 700, 10, 1, 256, True, None, 200),
                (2, 513, 513, 4, 2, 160, True, None, None),
                (1, 300, 1000, 10, 1, 160, True, 300, None)):
            q = _randn(torch, g, (b, hq, sq, d), dev, dt)
            k = _randn(torch, g, (b, hk, skv, d), dev, dt)
            v = _randn(torch, g, (b, hk, skv, d), dev, dt)
            yield (f"{name} Sq={sq} Skv={skv} D={d} {hq}:{hk} "
                   f"causal={causal} window={window} chunk={chunk}", name,
                   q, k, v, causal, window, chunk)
    dt = torch.bfloat16
    for s, window in ((300, None), (4096, 2048)):
        q = _randn(torch, g, (1, s, 10, 256), dev, dt).transpose(1, 2)
        k = _randn(torch, g, (1, 1, s, 256), dev, dt)
        v = _randn(torch, g, (1, 1, s, 256), dev, dt)
        yield (f"bfloat16 [B,S,H,D] view Sq=Skv={s} D=256 10:1 causal "
               f"window={window}", "bfloat16", q, k, v, True, window, None)


def shape_cfg(arch: str, sv: dict):
    """``arch``'s configuration with the heads one rank runs where ``sv``
    names them (``SHARD_RANK``: a rank's share of a sharded step)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if "heads" in sv:
        cfg = cfg.replace(num_heads=sv["heads"], num_kv_heads=sv["kv_heads"])
    return cfg


def flash_shape(torch, dev, cfg, sv: dict, seed: int):
    """Prefill attention as phase 5 or 7 serves ``cfg`` at ``sv``: q a
    [B, S, Hq, D] projection seen as [B, Hq, S, D], k/v the [B, Hk, S, D]
    cache, causal under the model's window."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b, s = sv["requests"], sv["prompt_len"]
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _randn(torch, g, (b, s, hq, d), dev, torch.bfloat16).transpose(1, 2)
    k = _randn(torch, g, (b, hk, s, d), dev, torch.bfloat16)
    v = _randn(torch, g, (b, hk, s, d), dev, torch.bfloat16)
    return q, k, v, cfg.window


def flash_rank_cases(torch, dev):
    """(label, dtype name, q, k, v, causal, window, chunk) as a rank of
    phase 14 (a)'s reduced cases runs the kernel: one q head (or two) on
    one KV head at head dim 16, 16 and 24 positions (the VLM's image
    tokens first), causal, under the reduced window and chunk of 32 or
    none, q the [B, S, H, D] projection seen as [B, H, S, D]."""
    g = torch.Generator(device="cpu").manual_seed(33)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for b, hq, s in ((2, 1, 16), (1, 1, 16), (1, 2, 16), (2, 1, 24)):
            q = _randn(torch, g, (b, s, hq, 16), dev, dt).transpose(1, 2)
            k = _randn(torch, g, (b, 1, s, 16), dev, dt)
            v = _randn(torch, g, (b, 1, s, 16), dev, dt)
            for window, chunk in ((None, None), (32, None), (None, 32)):
                yield (f"{name} rank B={b} {hq}:1 S={s} D=16 "
                       f"window={window} chunk={chunk}", name, q, k, v,
                       True, window, chunk)


def flash_sweep(torch, dev) -> tuple[dict, int]:
    """Every ``flash_cases``, layout, D 80 window, chunk and D 256 case
    through the kernel and its plain version: (worst max|diff| per dtype,
    cases run); raises on a mismatch."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    cases = itertools.chain(
        (c + (None,) for c in itertools.chain(
            flash_cases(torch, dev), flash_layout_cases(torch, dev),
            flash_window_cases(torch, dev))),
        flash_chunk_cases(torch, dev), flash_d256_cases(torch, dev),
        flash_rank_cases(torch, dev))
    for label, name, q, k, v, causal, window, chunk in cases:
        kw = dict(causal=causal, window=window, chunk_attn=chunk)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        worst[name] = max(worst[name],
                          attn_err(torch, got, want, name, label)[0])
        n_cases += 1
    torch.cuda.synchronize()
    return worst, n_cases


def attended_keys(sq: int, skv: int, window: int | None, causal: bool = True,
                  chunk: int | None = None) -> int:
    """Keys the mask leaves summed over query rows, row i at position
    i + skv - sq: causal, the window and llama4's chunk (floor division),
    each where set.  What the operations bound counts."""
    total = 0
    for i in range(sq):
        pos = i + skv - sq
        lo, hi = 0, skv
        if causal:
            hi = min(hi, pos + 1)
        if window is not None:
            lo = max(lo, pos - window + 1)
        if chunk is not None:
            lo = max(lo, pos // chunk * chunk)
            hi = min(hi, pos // chunk * chunk + chunk)
        total += max(0, hi - lo)
    return total


def _parts(q, k, v, per: str) -> list:
    """The plain version's calls for one shape: the whole batch, one per
    request, or one per (request, KV head) with its group of q-heads,
    whose float32 scores take a few GB at llama4's 10,240 keys."""
    b, hq = q.shape[:2]
    hk = k.shape[1]
    if per == "whole":
        return [(q, k, v)]
    if per == "request":
        return [(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(b)]
    g = hq // hk
    return [(q[i:i + 1, j * g:(j + 1) * g], k[i:i + 1, j:j + 1],
             v[i:i + 1, j:j + 1]) for i in range(b) for j in range(hk)]


def flash_row(torch, q, k, v, label: str, *, causal: bool = True,
              window: int | None = None, chunk: int | None = None,
              per: str = "whole") -> dict:
    """One prefill shape (bf16): the kernel held against the plain version
    (in ``per`` parts: whole, per request or per (request, KV head),
    whose scores would not fit the card at once at the larger shapes),
    then the bare launch, the wrapper, the plain version and the library
    call timed, and the operations bound of the attended pairs.  With a
    chunk, the same bare launch without it (``unchunked_ms``: the causal
    mask alone, every tile below the diagonal run)."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import (attention_mask,
                                                    flash_attention_ref)
    mask_kw = dict(causal=causal, window=window, chunk_attn=chunk)
    out = flash_attention(q, k, v, **mask_kw)
    parts = _parts(q, k, v, per)
    outs = _parts(out, k, v, per)
    err = rel = 0.0
    typical = []
    for (qp, kp, vp), (op, _, _) in zip(parts, outs):
        want = flash_attention_ref(qp, kp, vp, **mask_kw)
        e, r = attn_err(torch, op, want, "bfloat16", label)
        err, rel = max(err, e), max(rel, r)
        typical.append(float(want.float().abs().median()))
        del want
    b, hq, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    # the bare launch into a preallocated output, as the library call
    fn = _build.library().flash_attn_bf16
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream().cuda_stream

    def launch(c):
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None, b, hq, hk, sq, skv, d, strides, int(causal),
                window or 0, c, stream)
        return lambda: fn(*args)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if chunk is None and (window is None or window >= skv) and (
            not causal or sq == skv):     # causal alone, or no mask
        lib = (lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True))
    else:                    # a mask: KV heads repeated first (not timed)
        mask = attention_mask(sq, skv, q.device, **mask_kw)
        kr, vr = (t.repeat_interleave(hq // hk, dim=1) for t in (k, v))
        lib = (lambda: sdpa(q, kr, vr, attn_mask=mask))
    plain = (lambda: [flash_attention_ref(qp, kp, vp, **mask_kw)
                      for qp, kp, vp in parts])
    flops = 4 * b * hq * d * attended_keys(sq, skv, window, causal, chunk)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    flop_ms = flops / BF16_FLOP_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    res = {
        "max_abs_err": err, "max_rel_err": rel,
        "median_abs_ref": statistics.median(typical),
        "ms": device_ms(launch(chunk or 0), cold=True),
        "warm_ms": device_ms(launch(chunk or 0), cold=False, reps=10),
        "wrapper_ms": call_ms(lambda: flash_attention(q, k, v, **mask_kw),
                              reps=10),
        "plain_ms": device_ms(plain, cold=True, reps=5),
        "plain_calls": len(parts),
        "library_ms": device_ms(lib, cold=True),
        "bound_flop": flops, "bound_bytes": nbytes,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
    }
    if chunk is not None:
        res["unchunked_ms"] = device_ms(launch(0), cold=True)
        res["unchunked_flop"] = 4 * b * hq * d * attended_keys(
            sq, skv, window, causal)
    return add_rates(res, flops, "TFLOP/s")


def seq_rank_attn(torch, dev, seed: int, train: bool):
    """q, k, v as the last rank of phase 18 (b)'s "seq" layout launches
    the flash kernel for llama3.2-3b (``KNOB_RANK``): its block of query
    positions with all 24 q heads, the keys and values of every position
    up to the block's end on all 8 KV heads; the serve prefill's 4 rows,
    128 of 512 positions, or the training pass's one row, 512 of 2,048;
    q, k and v views of [B, S, H, D] projections."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    sh = KNOB_RANK
    b = 1 if train else sh["requests"]
    sq, skv = ((sh["train_rows"], sh["train_keys"]) if train
               else (sh["rows"], sh["keys"]))
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = _randn(torch, g, (b, sq, cfg.num_heads, cfg.head_dim), dev,
               torch.bfloat16).transpose(1, 2)
    k, v = (_randn(torch, g, (b, skv, cfg.num_kv_heads, cfg.head_dim), dev,
                   torch.bfloat16).transpose(1, 2) for _ in range(2))
    return q, k, v


def bf16_p_errors(torch, q, k, v, window) -> dict:
    """The flash kernel's output at a prefill shape against the plain
    version's two readings of ``attn_f32_scores``: P in float32 into the
    P V product (``f32_stats`` True, the reference's default) and P
    rounded to bf16 (False, the tuning plan's A3/A5/A7); the kernel packs
    P to bf16 for the tensor cores under both.  Per request: max|diff|,
    and max|diff| / max|ref|."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    out = flash_attention(q, k, v, causal=True, window=window)
    res = {}
    for f32 in (True, False):
        err = rel = 0.0
        for (qp, kp, vp), (op, _, _) in zip(_parts(q, k, v, "request"),
                                            _parts(out, k, v, "request")):
            want = flash_attention_ref(qp, kp, vp, causal=True,
                                       window=window, f32_stats=f32)
            d = float((op.float() - want.float()).abs().max())
            err = max(err, d)
            rel = max(rel, d / float(want.float().abs().max()))
            del want
        res["f32_stats" if f32 else "bf16_stats"] = {
            "max_abs_err": err, "max_rel_err": rel}
    res["served_gate"] = ATTN_TOL["bfloat16"]
    return res


def family_rank_flash(torch, dev):
    """(key, arch, q, k, v, mask) as each rank of phase 16 (b) launches
    the flash kernel: whisper-medium's encoder on the rank's 4 rows and 4
    of 16 heads (1,500 frames, D 64, not causal) and recurrentgemma-2b's
    prefill on its span of 3 of 10 q heads over the one KV head (4 x 512,
    D 256, causal under the 2,048 window); q, k and v views of the
    [B, S, H, D] projections."""
    g = torch.Generator(device="cpu").manual_seed(62)
    bf = torch.bfloat16
    for key, arch in (("rank_encoder_shape", WHISPER),
                      ("rank_hybrid_shape", HYBRID)):
        sv = FAMILY_RANK[arch]
        cfg = shape_cfg(arch, sv)
        b, d = sv["requests"], cfg.head_dim
        s = cfg.enc_seq if cfg.family == "encdec" else sv["prompt_len"]
        q, k, v = (_randn(torch, g, (b, s, h, d), dev, bf).transpose(1, 2)
                   for h in (cfg.num_heads, cfg.num_kv_heads,
                             cfg.num_kv_heads))
        mask = (dict(causal=False) if cfg.family == "encdec"
                else dict(causal=True, window=cfg.window))
        yield key, arch, q, k, v, mask
        del q, k, v


def flash_slice7_shapes(torch, dev):
    """(key, arch, q, k, v, mask, per) at the prefill shapes phase 8
    launches: llama4-maverick's chunked prefill (2 x 10,240, chunk 8,192,
    GQA 5), internvl2-26b's (8 x (256 + 1,792), GQA 6), whisper-medium's
    encoder (8 x 1,500 frames, D 64, not causal; q, k and v views of the
    [B, S, H, D] projections), its decoder's causal self-attention over
    the 384-token prompt and its cross-attention prefill (384 tokens
    against the 1,500-slot cross cache, not causal)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prefix_len
    bf = torch.bfloat16
    for key, arch, seed in (("chunk_shape", LLAMA4, 37),
                            ("vlm_shape", "internvl2-26b", 38)):
        cfg, sv = get_config(arch), SERVE_8[arch]
        sv = dict(sv, prompt_len=prefix_len(cfg) + sv["prompt_len"])
        q, k, v, window = flash_shape(torch, dev, cfg, sv, seed)
        yield (key, arch, q, k, v,
               dict(causal=True, window=window, chunk=cfg.chunk_attn),
               "kv_head" if cfg.chunk_attn else "request")
        del q, k, v
    cfg, sv = get_config(WHISPER), SERVE_8[WHISPER]
    g = torch.Generator(device="cpu").manual_seed(39)
    b, h, d, f = sv["requests"], cfg.num_heads, cfg.head_dim, cfg.enc_seq
    qkv = _randn(torch, g, (b, f, 3, h, d), dev, bf)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    yield ("encoder_shape", WHISPER, q, k, v, dict(causal=False), "whole")
    del q, k, v, qkv
    q, k, v, _ = flash_shape(torch, dev, cfg, sv, 40)
    yield ("encdec_self_shape", WHISPER, q, k, v, dict(causal=True),
           "whole")
    del q, k, v
    q = _randn(torch, g, (b, sv["prompt_len"], h, d), dev, bf).transpose(1, 2)
    k = _randn(torch, g, (b, cfg.num_kv_heads, f, d), dev, bf)
    v = _randn(torch, g, (b, cfg.num_kv_heads, f, d), dev, bf)
    yield ("cross_shape", WHISPER, q, k, v, dict(causal=False), "whole")


def check_flash(torch, dev) -> dict:
    """The sweep, then one row per served model at its prefill shape:
    llama3.2-3b (phase 5), h2o-danube-1.8b with its window binding and
    mixtral-8x7b, whose window is longer than its prompts (phase 7),
    recurrentgemma-2b's local attention (phase 9: head dim 256, 10 q-heads
    on one KV head, its 2,048 window binding over 4,096 positions),
    mixtral-8x7b as each rank of phase 13 (b) prefills it (8 x 512),
    llama3.2-3b as each rank of phase 14 (b) does (``rank_shape``), its
    training shape on each rank of phase 15 (b), whisper-medium's
    encoder and recurrentgemma-2b's prefill on each rank of phase 16 (b)
    (``family_rank_flash``), whisper-medium's and recurrentgemma-2b's
    training shapes on each rank of phase 17 (b) (``family_train_attn``),
    and the shapes of phase 8 (``flash_slice7_shapes``)."""
    from repro_torch.configs import get_config
    worst, n_cases = flash_sweep(torch, dev)
    res = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/kernel.py:102",
        "sweep_cases": n_cases, "sweep_max_abs_err": worst,
    }
    for key, arch, sv, seed in (
            (None, ARCH, SERVE, 32),
            ("window_shape", "h2o-danube-1.8b", SERVE_7["h2o-danube-1.8b"],
             35),
            ("moe_shape", "mixtral-8x7b", SERVE_7["mixtral-8x7b"], 36),
            ("hybrid_shape", HYBRID, SERVE_9[HYBRID], 52),
            ("mesh_shape", "mixtral-8x7b", MESH_SERVE, 54),
            ("rank_shape", ARCH, SHARD_RANK, 56)):
        q, k, v, window = flash_shape(torch, dev, shape_cfg(arch, sv), sv,
                                      seed)
        b, hq, s, d = q.shape
        hk = k.shape[1]
        row = {"shape": f"{arch} prefill: q [{b}, {hq}, {s}, {d}] bf16 (a "
                        f"[B, S, H, D] buffer), k/v [{b}, {hk}, {s}, {d}], "
                        f"causal, window {window}",
               **flash_row(torch, q, k, v, f"flash {arch} shape",
                           window=window,
                           per="whole" if key is None else "request")}
        if key is None:
            res.update(row)
            res["bf16_p"] = bf16_p_errors(torch, q, k, v, window)
        else:
            res[key] = row
        del q, k, v
        torch.cuda.empty_cache()
    q, k, v = seq_rank_attn(torch, dev, 58, train=False)
    res["seq_rank_shape"] = {
        "shape": f"{ARCH} prefill on each rank of phase 18 (b) under "
                 f"attn_shard=\"seq\" (the last block of query positions): "
                 f"q {list(q.shape)}, k/v {list(k.shape)} bf16 ([B, S, H, "
                 f"D] views), causal, query row i at i + Skv - Sq",
        **flash_row(torch, q, k, v, f"flash {ARCH} seq_rank_shape")}
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = train_rank_attn(torch, dev, 57)
    res["train_rank_shape"] = {
        "shape": f"{ARCH} training on each rank of phase 15 (b): q "
                 f"{list(q.shape)}, k/v {list(k.shape)} bf16 ([B, S, H, D] "
                 f"views), causal",
        **flash_row(torch, q, k, v, f"flash {ARCH} train_rank_shape")}
    del q, k, v
    torch.cuda.empty_cache()
    for key, arch, q, k, v, mask in family_rank_flash(torch, dev):
        res[key] = {"shape": f"{arch} on each rank of phase 16 (b): q "
                             f"{list(q.shape)}, k/v {list(k.shape)} bf16 "
                             f"([B, S, H, D] views), {mask}",
                    **flash_row(torch, q, k, v, f"flash {arch} {key}",
                                **mask)}
        del q, k, v
        torch.cuda.empty_cache()
    for key, arch, q, k, v, mask in family_train_attn(torch, dev):
        res[key] = {"shape": f"{arch} training on each rank of phase 17 "
                             f"(b): q {list(q.shape)}, k/v {list(k.shape)} "
                             f"bf16 ([B, S, H, D] views), {mask}",
                    **flash_row(torch, q, k, v, f"flash {arch} {key}",
                                **mask)}
        del q, k, v
        torch.cuda.empty_cache()
    for key, arch, q, k, v, mask, per in flash_slice7_shapes(torch, dev):
        b, hq, sq, d = q.shape
        hk, skv = k.shape[1], k.shape[2]
        res[key] = {"shape": f"{arch} {key[:-6]}: q [{b}, {hq}, {sq}, {d}] "
                             f"bf16 (strides {list(q.stride())}), k/v [{b}, "
                             f"{hk}, {skv}, {d}], {mask}",
                    **flash_row(torch, q, k, v, f"flash {arch} {key}",
                                per=per, **mask)}
        del q, k, v
        torch.cuda.empty_cache()
    emit({"phase": "kernel", **res})
    return res


# -------------------------------------------------------- decode_attention
def decode_cases(torch, dev):
    """(label, dtype name, q, k, v, valid_len, lo) over S 1, 7, 300, 513,
    2048, D 64/80/128, GQA 1/3/4, valid_len 0, 1, S and ragged, bf16 and
    f32, no first slot (lo None); then sliding-window spans at S 300, 513
    and 2048, D 80 and 128: lo 0, inside the first tile, on a tile edge,
    equal to valid_len - 1, and ragged per row."""
    g = torch.Generator(device="cpu").manual_seed(41)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for s in (1, 7, 300, 513, 2048):
            for d in (64, 80, 128):
                for hq, hk in ((4, 4), (3, 1), (8, 2)):
                    q = _randn(torch, g, (4, hq, d), dev, dt)
                    k = _randn(torch, g, (4, hk, s, d), dev, dt)
                    v = _randn(torch, g, (4, hk, s, d), dev, dt)
                    for lens in ([0, 1, s, s],
                                 [s, max(1, s // 3), 0, min(s, 5)]):
                        vl = torch.tensor(lens, dtype=torch.int32,
                                          device=dev)
                        yield (f"{name} S={s} D={d} {hq}:{hk} "
                               f"valid_len={lens}", name, q, k, v, vl, None)
        tile = 64 if dt == torch.bfloat16 else 32      # the kernel's rows
        for s in (300, 513, 2048):
            for d in (80, 128):
                for hq, hk in ((4, 4), (8, 2)):
                    q = _randn(torch, g, (4, hq, d), dev, dt)
                    k = _randn(torch, g, (4, hk, s, d), dev, dt)
                    v = _randn(torch, g, (4, hk, s, d), dev, dt)
                    lens = [s, s - 37, 250, s // 2 + 1]
                    for what, los in (
                            ("0", [0, 0, 0, 0]),
                            ("inside the first tile", [5, 1, 17, tile - 1]),
                            ("on a tile edge", [tile, 2 * tile, 0, tile]),
                            ("valid_len - 1", [n - 1 for n in lens]),
                            ("ragged", [s - 40, 3, 250, s // 4])):
                        vl = torch.tensor(lens, dtype=torch.int32,
                                          device=dev)
                        lo = torch.tensor(los, dtype=torch.int32, device=dev)
                        yield (f"{name} S={s} D={d} {hq}:{hk} "
                               f"valid_len={lens} lo={los} ({what})", name,
                               q, k, v, vl, lo)


def decode_layout_cases(torch, dev):
    """Caches in the layouts the kernel's copies must take: slots that are
    not contiguous (a [B, S, Hk, D] buffer seen as [B, Hk, S, D]: one
    16-byte copy per row chunk), and a slot stride of 68 elements (in bf16
    136 bytes, not a multiple of 16, which the wrapper copies first; in
    f32 272 bytes, read row by row)."""
    g = torch.Generator(device="cpu").manual_seed(43)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        s, d = 513, 128
        q = _randn(torch, g, (4, 6, d), dev, dt)
        k = _randn(torch, g, (4, s, 2, d), dev, dt).transpose(1, 2)
        v = _randn(torch, g, (4, s, 2, d), dev, dt).transpose(1, 2)
        vl = torch.tensor([s, 300, 0, 65], dtype=torch.int32, device=dev)
        yield (f"{name} [B,S,Hk,D] view S={s} D={d} 6:2", name, q, k, v, vl,
               None)
        q = _randn(torch, g, (4, 4, 64), dev, dt)
        k, v = (_randn(torch, g, (4, 2, 300, 68), dev, dt)[..., :64]
                for _ in range(2))
        vl = torch.tensor([300, 1, 129, 0], dtype=torch.int32, device=dev)
        copied = " (copied)" if dt == torch.bfloat16 else ""
        yield (f"{name} slot stride 68{copied} S=300 D=64 4:2", name, q, k,
               v, vl, torch.tensor([7, 0, 64, 0], dtype=torch.int32,
                                   device=dev))


def decode_group_cases(torch, dev):
    """Groups and head dims: G 1, 5, 6, 10, 16 and 17 q-heads per KV head
    at D 128 and 256 (the float32 route's sub-groups of at most 8 and 4
    heads; bf16's whole group of up to 16 a block, 17 in two), S 300 and
    2,048, valid_len ragged with and without a first slot lo
    (recurrentgemma's window: lo = valid_len - 2,048), a valid_len of 0;
    bf16 and f32.  Then bf16 alone: G 5 to 17 at D 64 and 80; a batch of
    one at D 80, 128 and 256 over a 4,096-slot span, a span that is no
    multiple of the 64-slot tile from a lo inside one, an empty span at
    slot 1,000, and valid_len 0; caches as a [B, S, Hk, D] buffer's view
    and with a slot stride of D + 4 (not a multiple of 16 bytes: copied)."""
    g = torch.Generator(device="cpu").manual_seed(51)

    def ranged(b, hq, hk, s, d, dt):
        return (_randn(torch, g, (b, hq, d), dev, dt),
                _randn(torch, g, (b, hk, s, d), dev, dt),
                _randn(torch, g, (b, hk, s, d), dev, dt))

    def spans(name, what, q, k, v, lens, los):
        s = k.shape[2]
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        lo = None if los is None else torch.tensor(los, dtype=torch.int32,
                                                    device=dev)
        return (f"{name} {what} S={s} D={q.shape[2]} {q.shape[1]}:"
                f"{k.shape[1]} valid_len={lens} lo={los}", name, q, k, v,
                vl, lo)

    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for d in (128, 256):
            for hq, hk in ((2, 2), (5, 1), (6, 1), (20, 2), (16, 1),
                           (34, 2)):
                for s in (300, 2048):
                    q, k, v = ranged(3, hq, hk, s, d, dt)
                    for los in (None, [max(0, s - 2048 + 1), 33, 0]):
                        yield spans(name, "group", q, k, v,
                                    [s, s // 2 + 7, 0], los)
    name, dt = "bfloat16", torch.bfloat16
    for d in (64, 80):
        for hq, hk in ((5, 1), (6, 1), (10, 1), (16, 1), (34, 2)):
            q, k, v = ranged(3, hq, hk, 300, d, dt)
            for los in (None, [1, 33, 0]):
                yield spans(name, "group", q, k, v, [300, 157, 0], los)
    for d, hq, hk in ((80, 32, 8), (128, 6, 1), (256, 10, 1)):
        q, k, v = ranged(1, hq, hk, 4200, d, dt)
        for what, end, first in (("4,096-slot span", 4096, 0),
                                 ("span off the tile", 4150, 37),
                                 ("empty span", 1000, 1000),
                                 ("valid_len 0", 0, 0)):
            yield spans(name, what, q, k, v, [end], [first])
    for d, hq, hk in ((128, 12, 2), (256, 20, 2)):
        q = _randn(torch, g, (3, hq, d), dev, dt)
        k, v = (_randn(torch, g, (3, 513, hk, d), dev, dt).transpose(1, 2)
                for _ in range(2))
        yield spans(name, "[B,S,Hk,D] view", q, k, v, [513, 300, 65],
                    [0, 7, 64])
        k, v = (_randn(torch, g, (3, hk, 513, d + 4), dev, dt)[..., :d]
                for _ in range(2))
        yield spans(name, "slot stride D + 4 (copied)", q, k, v,
                    [513, 300, 65], [0, 7, 64])


def decode_shape(torch, dev, cfg, sv: dict, seed: int, cross: bool = False):
    """Decode attention as phase 5, 7 or 8 serves ``cfg`` at ``sv``, at the
    64th decode step (the last of 64): q [B, Hq, D] bf16 (a slice of the
    [B, 1, Hq, D] projection) against one layer's [B, Hk, S, D] cache of
    S = prefix + prompt + decode slots (a VLM's prefix: its image tokens),
    and the slot range [lo, hi) the decoder's position mask leaves at that
    step (``layers.decode_slot_range``, the model's window or chunk
    applied).  ``cross``: an enc-dec's cross-attention instead, every one
    of the ``enc_seq`` slots at ``t = enc_seq - 1``."""
    from repro_torch.launch.serve import prefix_len
    from repro_torch.models.layers import decode_slot_range
    g = torch.Generator(device="cpu").manual_seed(seed)
    b, hq, hk, d = sv["requests"], cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    if cross:
        s = t = cfg.enc_seq
        t -= 1
        window = chunk = None
    else:
        s = prefix_len(cfg) + sv["prompt_len"] + sv["decode"]
        t = prefix_len(cfg) + sv["prompt_len"] + min(64, sv["decode"] - 1)
        window, chunk = cfg.window, cfg.chunk_attn
    q = _randn(torch, g, (b, 1, hq, d), dev, torch.bfloat16)[:, 0]
    k = _randn(torch, g, (b, hk, s, d), dev, torch.bfloat16)
    v = _randn(torch, g, (b, hk, s, d), dev, torch.bfloat16)
    lo, hi = decode_slot_range(t, s, window, chunk)
    return q, k, v, lo, hi


def decode_rank_cases(torch, dev):
    """(label, dtype name, q, k, v, valid_len, lo) as a rank of phase 14
    (a)'s reduced cases runs the kernel: one q head (or two) on one KV
    head at head dim 16 over 18, 20 and 28 slots, every slot up to ``t``
    (and a wrapped ring: all of them)."""
    g = torch.Generator(device="cpu").manual_seed(43)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for b, hq, s in ((2, 1, 20), (1, 1, 18), (1, 2, 20), (2, 1, 28)):
            q = _randn(torch, g, (b, hq, 16), dev, dt)
            k = _randn(torch, g, (b, 1, s, 16), dev, dt)
            v = _randn(torch, g, (b, 1, s, 16), dev, dt)
            for t in (s - 4, s - 1):
                vl = torch.full((b,), t + 1, dtype=torch.int32, device=dev)
                yield (f"{name} rank B={b} {hq}:1 S={s} D=16 t={t}", name,
                       q, k, v, vl, None)


def decode_sweep(torch, dev) -> tuple[dict, int]:
    """Every ``decode_cases``, layout and group case through the kernel and
    its plain version, again on the same inputs (bit-identical: the
    splits' ticket counters were left zeroed), again with garbage outside
    [lo, valid_len) and, where lo is 0, without lo (bit-identical):
    (worst max|diff| per dtype, cases run); raises on a mismatch, or if a
    case's plan takes another route than its dtype's (bf16: the tensor
    cores, "mma"; float32: "cuda_core")."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    decode_attention = dk.decode_attention
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for label, name, q, k, v, vl, lo in itertools.chain(
            decode_cases(torch, dev), decode_layout_cases(torch, dev),
            decode_group_cases(torch, dev), decode_rank_cases(torch, dev)):
        route = "mma" if name == "bfloat16" else "cuda_core"
        if decode_case_plan(dk, q, k).route != route:
            raise AssertionError(f"decode_attention plans another route "
                                 f"than {route}: {label}")
        got = decode_attention(q, k, v, vl, lo)
        want = decode_attention_ref(q, k, v, vl, 0 if lo is None else lo)
        worst[name] = max(worst[name],
                          attn_err(torch, got, want, name, label)[0])
        if not torch.equal(decode_attention(q, k, v, vl, lo), got):
            raise AssertionError(f"decode_attention not repeatable: {label}")
        if lo is not None and not bool(lo.any()) and not torch.equal(
                decode_attention(q, k, v, vl), got):
            raise AssertionError(f"decode_attention lo=0 differs from no "
                                 f"lo: {label}")
        # garbage outside the span (NaN values included) changes nothing
        slot = torch.arange(k.shape[2], device=dev)[None, :]
        out = slot >= vl[:, None].long()
        if lo is not None:
            out |= slot < lo[:, None].long()
        out = out[:, None, :, None]
        again = decode_attention(q, k.masked_fill(out, 999.0),
                                 v.masked_fill(out, float("nan")), vl, lo)
        if not torch.equal(again, got):
            raise AssertionError(f"decode_attention read outside "
                                 f"[lo, valid_len): {label}")
        n_cases += 1
    torch.cuda.synchronize()
    return worst, n_cases


def decode_case_plan(dk, q, k):
    """The plan ``decode_attention`` launches q against cache k with when
    it is given no span: cut over the cache's S."""
    b, hq, d = q.shape
    return dk.decode_plan(q.dtype, b, hq, k.shape[1], d, k.shape[2],
                          dk._sm_count(q.device.index))


def decode_launch(torch, q, k, v, bounds, span: int, out,
                  n_splits: int | None = None):
    """The bare launch of the bf16 decode kernel through its C entry point
    into ``out`` at the wrapper's plan for ``span`` (or with the span cut
    into ``n_splits`` chunks of whole tiles): ``bounds`` int32 [2, B],
    each row's first slot and end.  Returns (launch, plan)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn.kernel import (TILE, _sm_count,
                                                        decode_plan,
                                                        launch_args)
    b, hq, d = q.shape
    plan = decode_plan(q.dtype, b, hq, k.shape[1], d, span,
                       _sm_count(q.device.index))
    if n_splits is not None:
        per = -(-span // n_splits)
        chunk = -(-per // TILE) * TILE
        plan = plan._replace(chunk=chunk, n_splits=-(-span // chunk))
    args, scratch = launch_args(q, k, v, bounds[1], bounds[0], out, plan)
    fn = _build.library().decode_attn_bf16

    def launch():
        _build.check(fn(*args), "decode_attn_bf16")
        return scratch
    return launch, plan


def decode_row(torch, q, k, v, lo: int, hi: int, label: str) -> dict:
    """One decode shape, launched as the serve path launches it: every row
    attends to the slots [lo, hi), bounds from ``layers.slot_bounds`` and
    the plan cut over hi - lo.  The wrapper held against the plain
    version, then the bare launch, the wrapper, the plain version and the
    library call (``scaled_dot_product_attention`` over the sliced slots)
    timed, and the byte bound of the slots the span holds; the plan's
    route, heads a block, blocks an SM and splits."""
    from repro_torch.kernels.decode_attn.kernel import decode_attention
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    from repro_torch.models.layers import slot_bounds
    b, hq, d = q.shape
    _, hk, s, _ = k.shape
    bounds = slot_bounds(q.device, b, lo, hi)
    span = hi - lo

    def wrapper():
        return decode_attention(q, k, v, bounds[1], bounds[0], span)
    out = wrapper()
    want = decode_attention_ref(q, k, v, hi, lo)
    err, rel = attn_err(torch, out, want, "bfloat16", label)
    typical = float(want.float().abs().median())
    launch, plan = decode_launch(torch, q, k, v, bounds, span, out)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = q[:, :, None]
    total = b * span
    nbytes = 2 * total * hk * d * 2 + 2 * 2 * q.numel() + bounds.numel() * 4
    flops = 4 * hq * d * total
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / BF16_FLOP_PER_S * 1e3
    res = {
        "max_abs_err": err, "max_rel_err": rel, "median_abs_ref": typical,
        "decode_route": plan.route, "heads_a_block": plan.heads,
        "blocks_per_sm": plan.blocks_per_sm, "splits": plan.n_splits,
        "chunk": plan.chunk,
        "ms": device_ms(launch, cold=True),
        "warm_ms": device_ms(launch, cold=False),
        "wrapper_ms": call_ms(wrapper),
        "plain_ms": device_ms(lambda: decode_attention_ref(q, k, v, hi, lo),
                              cold=True),
        "library_ms": device_ms(lambda: sdpa(q4, k[:, :, lo:hi],
                                             v[:, :, lo:hi],
                                             enable_gqa=True), cold=True),
        "bound_bytes": nbytes, "bound_flop": flops,
        "bound_ms": max(byte_ms, flop_ms),
        "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
    }
    return add_rates(res, nbytes, "TB/s")


def decode_shapes() -> tuple:
    """(row key, arch, serve sizes, seed) of phase 3's decode rows at the
    served models' shapes (key None: the main row, llama3.2-3b as phase 5
    serves it)."""
    return ((None, ARCH, SERVE, 42),
            ("window_shape", "h2o-danube-1.8b", SERVE_7["h2o-danube-1.8b"],
             44),
            ("moe_shape", "mixtral-8x7b", SERVE_7["mixtral-8x7b"], 45),
            ("chunk_shape", LLAMA4, SERVE_8[LLAMA4], 46),
            ("vlm_shape", "internvl2-26b", SERVE_8["internvl2-26b"], 47),
            ("encdec_self_shape", WHISPER, SERVE_8[WHISPER], 48),
            ("cross_shape", WHISPER, SERVE_8[WHISPER], 49),
            ("hybrid_shape", HYBRID, SERVE_9[HYBRID], 53),
            ("mesh_shape", "mixtral-8x7b", MESH_SERVE, 55),
            ("rank_shape", ARCH, SHARD_RANK, 57),
            ("rank_cross_shape", WHISPER, FAMILY_RANK[WHISPER], 60),
            ("rank_hybrid_shape", HYBRID, FAMILY_RANK[HYBRID], 61))


def check_decode(torch, dev) -> dict:
    """The sweep, then one row per served model at its decode shape:
    llama3.2-3b (phase 5), h2o-danube-1.8b with its window binding and
    mixtral-8x7b (phase 7), llama4-maverick's chunk span [8,192, t + 1),
    internvl2-26b's group of 6 after its image tokens, and whisper-
    medium's self-attention and its cross-attention over 1,500 frames
    (phase 8), and recurrentgemma-2b's windowed span of 2,048 slots at
    head dim 256 with 10 q-heads on one KV head (phase 9: three
    sub-groups), mixtral-8x7b at each rank's last decode step of phase 13
    (b) (514 slots), llama3.2-3b at each rank's of phase 14 (b)
    (``rank_shape``: group 3 over 516 slots), and whisper-medium's cross
    decode and recurrentgemma-2b's decode on each rank of phase 16 (b)
    (``rank_cross_shape``, ``rank_hybrid_shape``)."""
    from repro_torch.kernels.decode_attn.kernel import (MMA_BLOCKS_PER_SM,
                                                        blocks_per_sm)
    # the plan's blocks an SM are what the card gives each instantiation
    held = {md: blocks_per_sm(md) for md in MMA_BLOCKS_PER_SM}
    if held != MMA_BLOCKS_PER_SM:
        raise AssertionError(f"decode kernel blocks an SM {held}, planned "
                             f"{MMA_BLOCKS_PER_SM}")
    worst, n_cases = decode_sweep(torch, dev)
    res = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/kernel.py:81",
        "sweep_cases": n_cases, "sweep_max_abs_err": worst,
        "mma_blocks_per_sm": held,
    }
    for key, arch, sv, seed in decode_shapes():
        cfg = shape_cfg(arch, sv)
        cross = key in ("cross_shape", "rank_cross_shape")
        q, k, v, lo, hi = decode_shape(torch, dev, cfg, sv, seed,
                                       cross=cross)
        b, hq, d = q.shape
        _, hk, s, _ = k.shape
        what = ("cross-attention decode" if cross
                else f"decode, window {cfg.window}, chunk {cfg.chunk_attn},")
        row = {"shape": f"{arch} {what} at t={hi - 1}: q [{b}, {hq}, {d}] "
                        f"bf16, caches [{b}, {hk}, {s}, {d}], slots [{lo}, "
                        f"{hi}) on every row",
               **decode_row(torch, q, k, v, lo, hi, f"decode {arch} shape")}
        if key is None:
            res.update(row)
        else:
            res[key] = row
        del q, k, v
    emit({"phase": "kernel", **res})
    return res


# ---------------------------------------------------------------- episodes
def run_episode(key: str, golden: dict, dev: str) -> dict:
    """One golden episode through the port, compared as the reference's
    ``tests/test_golden_trace.py:assert_matches_golden`` compares."""
    from repro_torch.core.controller import AutoScaler, ControllerConfig
    from repro_torch.core.justin import JustinParams
    from repro_torch.core.policy import make_policy
    from repro_torch.data.nexmark import QUERIES, TARGET_RATES
    from repro_torch.streaming.engine import StreamEngine
    qname, policy = key.split("_")
    meta = golden["_meta"]
    eng = StreamEngine(QUERIES[qname](), seed=meta["seed"], device=dev)
    cfg = ControllerConfig(policy=policy,
                           justin=JustinParams(max_level=meta["max_level"]))
    ctl = AutoScaler(eng, TARGET_RATES[qname], cfg,
                     policy=make_policy(policy, cfg))
    hist = ctl.run()
    got = {
        "steps": ctl.steps,
        "configs": [[(op, list(pc)) for op, pc in
                     sorted((op, list(pc)) for op, pc in h.config.items())]
                    for h in hist],
        "triggered": [h.triggered for h in hist],
        "cpu_cores": hist[-1].cpu_cores,
        "memory_mb": hist[-1].memory_mb,
        "final_rate_ok": hist[-1].achieved_rate
        >= 0.97 * TARGET_RATES[qname],
    }
    want = golden[key]
    want_cfg = [[(op, list(pc)) for op, pc in w] for w in want["configs"]]
    checks = {
        "steps": got["steps"] == want["steps"],
        "triggered": got["triggered"] == want["triggered"],
        "configs": got["configs"] == want_cfg,
        "cpu_cores": got["cpu_cores"] == want["cpu_cores"],
        "memory_mb": got["memory_mb"] == want["memory_mb"],
        "final_rate_ok": bool(got["final_rate_ok"] and want["final_rate_ok"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"{key} differs from the golden trace: "
                             f"{checks} got={got}")
    return {"steps": got["steps"], "windows": len(hist),
            "cpu_cores": got["cpu_cores"], "memory_mb": got["memory_mb"],
            "achieved_rate": hist[-1].achieved_rate}


# profiler names of the store kernels' device work, by kernel
STORE_KERNELS = {"sorted_probe": ("::probe_warps<", "::probe_indexed<"),
                 "window_agg": ("::window_agg_kernel<",
                                "::window_agg_zero<")}


def profile_run(label: str, fn, wall_unprofiled: float | None,
                **extra) -> None:
    """``fn`` under torch.profiler: device time by kernel, written to
    chiprun_out/, and the device's busy share of the run's unprofiled
    wall time (the profiler slows the host, not the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    OUT.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    (OUT / f"profile_{label}.txt").write_text(
        avgs.table(sort_by="self_device_time_total", row_limit=60))
    # device-side entries only (kernels, copies): op rows repeat the time
    # of the kernels they launch
    on_dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    dev_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    # the store kernels' device time, every instantiation summed
    store = {}
    for name, marks in STORE_KERNELS.items():
        rows = [e for e in on_dev if any(m in e.key for m in marks)]
        store[name] = {"calls": sum(e.count for e in rows),
                       "device_ms": sum(e.self_device_time_total
                                        for e in rows) / 1e3}
    emit({"phase": "profile", **extra, "wall_s_profiled": wall,
          "store_kernels": store,
          "wall_s_unprofiled": wall_unprofiled, "device_s": dev_s,
          "device_events": sum(e.count for e in on_dev),
          "device_busy_share": dev_s / wall_unprofiled
          if wall_unprofiled else None,
          "top": [{"name": e.key[:70], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in on_dev[:15]]})


# ------------------------------------------------------------------- serve
def run_serve(torch, dev: str) -> dict:
    """The serving path at full width through the user's entry point; the
    attention kernels' launch counts are reset just before and read just
    after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch.serve import serve
    cfg = get_config(ARCH)
    flash_ops.launches = 0
    decode_ops.launches = 0
    res = serve(ARCH, reduced=False, verbose=False, device=dev, **SERVE)
    launches = {"flash_attention": flash_ops.launches,
                "decode_attention": decode_ops.launches}
    check_served(cfg, SERVE, res, launches)
    emit({"phase": "serve", "reduced": False, **SERVE, **res})
    return launches


def attn_launches(cfg) -> tuple[int, int]:
    """(flash launches a prefill, decode launches a step): one per
    attention of a layer; an enc-dec's prefill runs its encoder layers'
    self-attention and its decoder layers' self- and cross-attention, its
    decode step the decoder's two; a hybrid's attention layers only
    (recurrentgemma: 8 of 26); an SSM none."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        groups, tail = divmod(cfg.num_layers, len(cfg.block_pattern))
        n = (groups * cfg.block_pattern.count("attn")
             + cfg.block_pattern[:tail].count("attn"))
        return n, n
    return cfg.num_layers, cfg.num_layers


def check_served(cfg, sv: dict, res: dict, launches: dict) -> None:
    """Raise unless a serve run of ``cfg`` at ``sv`` launched each
    attention kernel once per attention a prefill and a decode step
    (``attn_launches``; counted by the ops counters and reported by
    ``serve``) and generated ``decode + 1`` in-vocabulary tokens."""
    per_prefill, per_step = attn_launches(cfg)
    want = {"flash_attention": per_prefill,
            "decode_attention": per_step * sv["decode"]}
    if launches != want or res["launches"] != want:
        raise AssertionError(f"{cfg.name} launched {launches} (reported "
                             f"{res['launches']}), want {want}")
    if res["generated"] != sv["decode"] + 1 or not all(
            0 <= t < cfg.vocab_size for t in res["sample"]):
        raise AssertionError(f"{cfg.name} output malformed: {res}")


def check_decode_matches_prefill(torch, dev: str, cfg, s: int,
                                 **extra) -> dict:
    """Full width: the decode step after ``s`` prompt tokens == the last
    logits of a prefill over ``s`` + 1 tokens (the reference's
    tests/test_models.py::test_decode_matches_prefill, 2 requests), on the
    serving path's weights (seed 1); a VLM's images or an enc-dec's frames
    are the same in both (``make_batch``, seed 1), and the step is at the
    position after the prefix and the prompt.  For an MoE config the
    routing's own drop counts of the prefill and of the decode step are
    reported."""
    import numpy as np
    from repro_torch.launch.serve import (init_params, make_batch, pad_kv,
                                          prefix_len)
    from repro_torch.models import get_model, moe
    model = get_model(cfg)
    params = init_params(cfg, torch.device(dev), 1)
    b = 2
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s + 1)), device=dev)
    drops = {}
    moe.dropped = torch.zeros((), dtype=torch.int64, device=dev)
    try:
        _, caches = model.prefill(params, make_batch(cfg, toks[:, :s], 1),
                                  cfg)
        drops["prefill"] = int(moe.dropped)
        caches = pad_kv(caches, 1)
        moe.dropped.zero_()
        got, _ = model.decode(params, caches, toks[:, s:],
                              prefix_len(cfg) + s, cfg)
        drops["decode_step"] = int(moe.dropped)
    finally:
        moe.dropped = None
    del caches
    ref, _ = model.prefill(params, make_batch(cfg, toks, 1), cfg)
    if got.shape != (b, cfg.padded_vocab) or not bool(
            torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError("decode/prefill logits malformed")
    rel = float((got - ref).abs().max() / ref.abs().max())
    res = {"phase": "decode_vs_prefill", "arch": cfg.name, "requests": b,
           "position": prefix_len(cfg) + s, "max_abs_ref": float(ref.abs().max()),
           "rel_err": rel, "limit": 0.03,
           "argmax_equal": bool(torch.equal(got.argmax(-1),
                                            ref.argmax(-1))), **extra}
    if dev != "cpu":
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if cfg.num_experts:
        per_token = cfg.num_layers // cfg.moe_period * cfg.top_k
        res["moe_dropped"] = {
            "prefill": drops["prefill"],
            "prefill_assignments": b * s * per_token,
            "decode_step": drops["decode_step"],
            "decode_step_assignments": b * per_token}
    emit(res)
    if not rel < 0.03:
        raise AssertionError(f"{cfg.name}: decode differs from prefill: "
                             f"{rel}")
    return res


def profile_serve(torch) -> None:
    """Prefill and 8 decode steps at full width under torch.profiler:
    device time by kernel and CUDA kernels launched per decode step,
    written to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve
    OUT.mkdir(exist_ok=True)
    steps = 8
    kw = dict(SERVE, decode=steps)
    serve(ARCH, reduced=False, verbose=False, **kw)       # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = serve(ARCH, reduced=False, verbose=False, **kw)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    (OUT / "profile_serve.txt").write_text(
        avgs.table(sort_by="self_device_time_total", row_limit=60))
    on_dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    emit({"phase": "profile_serve", "decode_steps": steps,
          "wall_s_profiled": res["wall_s"],
          "device_ms": sum(e.self_device_time_total for e in on_dev) / 1e3,
          "device_events": sum(e.count for e in on_dev),
          "top": [{"name": e.key[:70], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in on_dev[:20]]})


def profile_decode(torch, cfg, sv: dict, steps: int = 8,
                   dev: str = "cuda") -> None:
    """``steps`` decode steps of ``cfg`` after a prefill of ``sv``'s batch,
    first on the host clock, then again under torch.profiler: per step the
    wall ms, the device ms, the device events, and the device's busy share
    of the unprofiled wall (what says whether a step is host-bound)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import init_params, pad_kv
    from repro_torch.models import get_model
    dev = torch.device(dev)
    model = get_model(cfg)
    params = init_params(cfg, dev, 0)
    b, s = sv["requests"], sv["prompt_len"]
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), device=dev)
    logits, caches = model.prefill(params, {"tokens": toks}, cfg)
    caches = pad_kv(caches, 2 * steps + 2)
    tok = logits.argmax(-1)[:, None]

    def run(t0: int, n: int) -> None:
        nonlocal tok
        for i in range(n):
            out, _ = model.decode(params, caches, tok, t0 + i, cfg)
            tok = out.argmax(-1)[:, None]
        torch.cuda.synchronize()

    run(s, 2)                                   # warm
    t0 = time.perf_counter()
    run(s + 2, steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(s + 2 + steps, steps)
    avgs = prof.key_averages()
    (OUT / f"profile_decode_{cfg.name}.txt").write_text(
        avgs.table(sort_by="self_device_time_total", row_limit=40))
    on_dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in on_dev) / 1e3 / steps
    emit({"phase": "profile_decode", "arch": cfg.name,
          "layers": cfg.num_layers, "requests": b, "position": s + 2 + steps,
          "wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms,
          "device_events_per_step": sum(e.count for e in on_dev) / steps,
          "device_busy_share": dev_ms / wall_ms,
          "top": [{"name": e.key[:70], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in on_dev[:12]]})


# --------------------------------------------------------------- scenarios
# Phase 6 drives the reconfiguration-pricing, dynamic-scenario and
# shared-cluster layer and holds each run exactly against the reference's
# answers, pinned in tests/data/torch_scenarios.json (written from the
# reference package by ``tests/test_torch_pins.py --write``, which runs
# these same functions over the reference's modules).  Every run function
# takes ``api``, a namespace of one package's entry points
# (:func:`port_api` here), and ``dev``, the keyword arguments that place
# its engines (``{"device": "cuda"}`` for the port, ``{}`` for the
# reference).
PINS = ROOT / "tests" / "data" / "torch_scenarios.json"
ROW_FIELDS = ("t", "step", "achieved_rate", "cpu_cores", "memory_mb",
              "config", "triggered", "target", "backlog", "denied",
              "preempted", "amortized_mb", "reconfig_downtime", "moved_mb",
              "reason")
SAVEPOINT_MB_PER_S = 6.0
FLEETS = {"d_fleet_32": dict(tenants=32, windows=6, admission="fair_share",
                             drivers=("vectorized", "scalar")),
          "d_fleet_128": dict(tenants=128, windows=20,
                              admission="preemption",
                              drivers=("vectorized",))}
# the reference's own fleet bench runs 1,000 tenants x 100 windows
FLEET_FULL = dict(tenants=1000, windows=100)


def port_api():
    """The port's entry points that phase 6 drives."""
    from types import SimpleNamespace

    from repro_torch.core.controller import AutoScaler, ControllerConfig
    from repro_torch.core.justin import JustinParams
    from repro_torch.core.policy import make_policy
    from repro_torch.data.nexmark import QUERIES, TARGET_RATES
    from repro_torch.migration import CostModel, MigrationRuntime
    from repro_torch.obs import Tracer, write_jsonl
    from repro_torch.scenarios import (KillTask, SetStraggler, fleet_stats,
                                       run_colocation, run_fleet,
                                       run_scenario)
    from repro_torch.scenarios import cluster
    from repro_torch.scenarios.runner import scenario_horizon_s
    from repro_torch.streaming.engine import StreamEngine
    return SimpleNamespace(**locals())


def _jsonable(obj):
    """The record as it reads back from JSON (tuples become lists, numpy
    scalars Python ones), so a fresh record compares with ``==`` against
    the pinned one."""
    return json.loads(json.dumps(obj, default=lambda x: x.item()))


def history_rows(history) -> list:
    """Every field of every ``HistoryRow``, in ``ROW_FIELDS`` order."""
    return [[sorted([op, list(pc)] for op, pc in h.config.items())
             if f == "config" else getattr(h, f) for f in ROW_FIELDS]
            for h in history]


def _fault(f) -> list:
    import dataclasses
    return [type(f).__name__, *dataclasses.astuple(f)]


def colocated_record(res) -> dict:
    """A co-located run's decisions: the usage series and, per tenant, its
    admission outcomes and full history."""
    return _jsonable({
        "usage": res.usage,
        "migration": [res.cluster.migration_total().tasks_moved,
                      res.cluster.migration_total().state_mb],
        "tenants": {t.name: {
            "policy": t.spec.policy, "query": t.spec.query,
            "steps": t.scaler.steps, "denials": t.denials,
            "deferrals": t.deferrals, "preemptions": t.preemptions,
            "shrinks": t.scaler.preemptions,
            "first_pending": t.first_pending,
            "faults_fired": [_fault(f) for f in t.faults_fired],
            "history": history_rows(t.history)} for t in res.tenants}})


def run_savepoint(api, dev: dict) -> dict:
    """(a) q8 under a savepoint cost model, justin and threshold, 6 windows
    (the reference's tests/test_migration.py::
    test_q8_savepoint_threshold_pays_more_downtime_than_justin)."""
    cm = api.CostModel(mechanism="savepoint",
                       savepoint_mb_per_s=SAVEPOINT_MB_PER_S)
    out = {}
    for pol in ("justin", "threshold"):
        cfg = api.ControllerConfig(policy=pol,
                                   justin=api.JustinParams(max_level=2))
        ctl = api.AutoScaler(
            api.StreamEngine(api.QUERIES["q8"](), seed=3, **dev),
            api.TARGET_RATES["q8"], cfg, policy=api.make_policy(pol, cfg),
            migration=api.MigrationRuntime(cm))
        hist = ctl.run(max_windows=6)
        out[pol] = {"steps": ctl.steps, "history": history_rows(hist),
                    "totals": ctl.migration.totals()}
    return _jsonable(out)


def check_savepoint(rec: dict) -> dict:
    """The acceptance pin's own claims: justin converges in 3 steps,
    threshold in 4, both recover, threshold pays more downtime windows
    and more downtime seconds."""
    i_rate, i_target = ROW_FIELDS.index("achieved_rate"), \
        ROW_FIELDS.index("target")
    i_down = ROW_FIELDS.index("reconfig_downtime")
    got = {}
    for pol, r in rec.items():
        down = [row[i_down] for row in r["history"]]
        last = r["history"][-1]
        got[pol] = {"steps": r["steps"],
                    "downtime_windows": sum(1 for d in down if d > 0),
                    "downtime_s": sum(down),
                    "recovered": last[i_rate] >= 0.97 * last[i_target]}
    j, t = got["justin"], got["threshold"]
    if not (j["recovered"] and t["recovered"] and j["steps"] == 3
            and t["steps"] == 4
            and t["downtime_windows"] > j["downtime_windows"]
            and t["downtime_s"] > j["downtime_s"]):
        raise AssertionError(f"savepoint headline does not hold: {got}")
    return got


def run_faults(api, dev: dict, trace_path=None) -> dict:
    """(b) q11 under a load spike with a straggler (and its recovery) and a
    killed task, reconfigurations priced as handoffs, a tracer attached;
    the fault times lie inside the scenario's horizon."""
    cfg = api.ControllerConfig(policy="justin",
                               justin=api.JustinParams(max_level=2))
    horizon = api.scenario_horizon_s(cfg, 8)
    faults = [api.SetStraggler(0.2 * horizon, "user_sessions", 0, 8.0,
                               duration_s=0.2 * horizon),
              api.KillTask(0.6 * horizon, "user_sessions", 1)]
    tracer = api.Tracer(enabled=True)
    res = api.run_scenario("justin", "q11", "spike", windows=8, cfg=cfg,
                           reconfig_cost="handoff", faults=faults,
                           tracer=tracer, **dev)
    if trace_path is not None:
        api.write_jsonl(tracer.spans, str(trace_path),
                        meta={"run": "b_faults"})
    return _jsonable({"steps": res.steps,
                      "history": history_rows(res.history),
                      "faults_fired": [_fault(f) for f in res.faults_fired],
                      "slo": res.slo().to_dict(),
                      "spans": len(tracer.spans),
                      "trace_summary": tracer.summary()})


def run_colocation_pair(api, dev: dict, driver: str) -> dict:
    """(c) the ds2/justin pair on one shared-TM cluster under preemption
    (``run_colocation(["q11"], "preemption", windows=5)``).  The cell
    reports counts; the decisions behind them are read from the
    ``run_colocated`` result it makes, caught on its way out."""
    caught = []
    inner = api.cluster.run_colocated

    def catching(*a, **kw):
        caught.append(inner(*a, **kw))
        return caught[-1]

    api.cluster.run_colocated = catching
    try:
        cells = api.run_colocation(["q11"], "preemption", windows=5,
                                   verbose=False, driver=driver, **dev)
    finally:
        api.cluster.run_colocated = inner
    return _jsonable({"cells": cells, **colocated_record(caught[0])})


def run_fleet_case(api, dev: dict, key: str, driver: str) -> tuple:
    """(d) a sampled fleet on its auto-sized private cluster: (record,
    ``fleet_stats``)."""
    f = FLEETS[key]
    res = api.run_fleet(f["tenants"], f["windows"],
                        admission=f["admission"], seed=0, driver=driver,
                        **dev)
    return colocated_record(res), api.fleet_stats(res)


def first_diff(got, want, path: str = "") -> str | None:
    """Where two JSON values first differ (None when equal)."""
    if isinstance(got, dict) and isinstance(want, dict):
        for k in sorted(set(got) | set(want), key=str):
            if k not in got or k not in want:
                return f"{path}/{k}: only in {'got' if k in got else 'pin'}"
            d = first_diff(got[k], want[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(got, list) and isinstance(want, list):
        if len(got) != len(want):
            return f"{path}: length {len(got)} != {len(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            d = first_diff(a, b, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if got == want else f"{path}: {got!r} != {want!r}"


def hold(label: str, got, want) -> None:
    d = first_diff(got, want)
    if d:
        raise AssertionError(f"{label} differs: {d}")


def scenario_phase(torch, dev: str) -> dict:
    """Phase 6: every scenario run on the card at the reference's sizes,
    each held exactly against the pin (and (c), (d) against their other
    driver); per run one line with its wall seconds, store-kernel
    launches and peak device memory.  Returns the launch totals and the
    walls by run."""
    from repro_torch.kernels.sorted_probe import ops as probe_ops
    from repro_torch.kernels.window_agg import ops as agg_ops
    api = port_api()
    pins = json.loads(PINS.read_text())
    d = {"device": dev}
    OUT.mkdir(exist_ok=True)
    trace = OUT / "scenario_b_trace.jsonl"
    totals = {"sorted_probe": 0, "window_agg": 0}
    walls = {}
    t_phase = time.perf_counter()

    def timed(label: str, fn, **extra):
        gc.collect()         # the last run's engines, before the reset
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        probe_ops.launches = 0
        agg_ops.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"sorted_probe": probe_ops.launches,
                    "window_agg": agg_ops.launches}
        for k, n in launches.items():
            if n == 0:
                raise AssertionError(f"scenario run {label} never "
                                     f"launched {k}")
            totals[k] += n
        walls[label] = wall
        line = {"phase": "scenario", "run": label, "wall_s": wall,
                "launches": launches,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                **extra}
        return out, line

    # (a) priced reconfiguration
    rec, line = timed("a_savepoint", lambda: run_savepoint(api, d))
    hold("a_savepoint", rec, pins["a_savepoint"])
    emit({**line, "pin_equal": True, "headline": check_savepoint(rec)})

    # (b) dynamic load with faults, traced
    rec, line = timed("b_faults", lambda: run_faults(api, d, trace))
    hold("b_faults", rec, pins["b_faults"])
    chk = subprocess.run([sys.executable,
                          str(ROOT / "tools" / "check_trace.py"),
                          str(trace)], capture_output=True, text=True,
                         timeout=120)
    if chk.returncode != 0:
        raise AssertionError(f"check_trace refused the trace: "
                             f"{chk.stdout}{chk.stderr}")
    emit({**line, "pin_equal": True, "spans": rec["spans"],
          "check_trace": chk.stdout.strip()})

    # (c) shared-cluster co-location, both drivers
    recs = {}
    for driver in ("vectorized", "scalar"):
        recs[driver], line = timed(
            f"c_colocation_{driver}",
            lambda: run_colocation_pair(api, d, driver))
        hold(f"c_colocation ({driver})", recs[driver], pins["c_colocation"])
        emit({**line, "pin_equal": True, "driver": driver})
    hold("c_colocation scalar vs vectorized", recs["scalar"],
         recs["vectorized"])

    # (d) fleets; depth cut from the reference's 1,000 x 100 bench
    for key, f in FLEETS.items():
        recs = {}
        for driver in f["drivers"]:
            (recs[driver], stats), line = timed(
                f"{key}_{driver}",
                lambda: run_fleet_case(api, d, key, driver))
            hold(f"{key} ({driver})", recs[driver], pins[key])
            stats.update(seconds=line["wall_s"],
                         tenant_windows_per_s=stats["tenant_windows"]
                         / line["wall_s"])
            emit({**line, "pin_equal": True, "driver": driver,
                  "fleet_stats": stats,
                  "reduced": {"tenants": [f["tenants"],
                                          FLEET_FULL["tenants"]],
                              "windows": [f["windows"],
                                          FLEET_FULL["windows"]]}})
        if len(recs) == 2:
            hold(f"{key} scalar vs vectorized", recs["scalar"],
                 recs["vectorized"])
    emit({"phase": "scenarios_done",
          "seconds": time.perf_counter() - t_phase, "launches": totals})
    return totals, walls


# ------------------------------------------------- serve, window and MoE
# Phase 7 drives the port's serve controller and serves the two sliding-
# window models.  (a) holds JustinServeController's decisions exactly
# against the reference's answers, pinned in tests/data/torch_serve.json
# (written by ``tests/test_torch_pins.py --write-serve`` through
# ``run_serve_controller`` over the reference's modules): a smaller
# workload than the default (160 prefixes of 256 tokens at 120 requests/s),
# at which the first window is above 0.8 busy and each policy steps.
SERVE_PINS = ROOT / "tests" / "data" / "torch_serve.json"
SERVE_CTL = dict(target_rps=120.0, n_prefixes=160, prefix_tokens=256)
SERVE_POLICIES = ("ds2", "justin", "threshold")
# (b) h2o-danube-1.8b at full width and depth: prompts longer than its
# 4,096-token window, so the window binds in prefill and in every decode
# step.  (c) mixtral-8x7b at full width, 16 of its 32 layers: 23.2 B
# parameters, 46.4 GB of bf16 layers and 1.05 GB of float32 embed and
# unembed, to fit one 80 GB card.
SERVE_7 = {"h2o-danube-1.8b": dict(requests=8, prompt_len=6144, decode=128),
           "mixtral-8x7b": dict(requests=8, prompt_len=2048, decode=128)}
MIXTRAL_LAYERS = 16


def serve_api(package: str = "repro_torch"):
    """The serve controller's entry points of one package."""
    import importlib
    from types import SimpleNamespace
    eng = importlib.import_module(f"{package}.serve.engine")
    return SimpleNamespace(JustinServeController=eng.JustinServeController,
                           WorkloadSpec=eng.WorkloadSpec)


def run_serve_controller(api, policy: str) -> dict:
    """(a) ``JustinServeController.autoscale()`` under ``policy`` at
    ``SERVE_CTL``: the result, steps, replicas, level and every history
    row."""
    ctl = api.JustinServeController(
        SERVE_CTL["target_rps"], policy=policy,
        workload=api.WorkloadSpec(n_prefixes=SERVE_CTL["n_prefixes"],
                                  prefix_tokens=SERVE_CTL["prefix_tokens"]))
    res = ctl.autoscale()
    return _jsonable({"result": res, "steps": ctl.steps,
                      "replicas": len(ctl.replicas), "level": ctl.level,
                      "history": ctl.history})


def moe_ffn_plain(torch, p: dict, x, cfg):
    """A plain float32 version of ``models.moe.moe_ffn``, written apart
    from the port's buffer scatter: per expert, the (token, choice)
    assignments routed to it in token order, the first ``cap`` kept, their
    SwiGLU outputs in float32 scaled by the renormalised gates and added
    into their tokens' rows.  x [N, D].  Returns (y [N, D] float32, the
    assignments dropped)."""
    import torch.nn.functional as F
    n, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    gates, sel = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = max(1, -(-int(n * k * cfg.capacity_factor) // e))
    flat_sel, flat_gate = sel.reshape(-1), gates.reshape(-1)
    y = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    kept = 0
    for j in range(e):
        idx = torch.nonzero(flat_sel == j).squeeze(1)[:cap]
        tok = idx // k
        xe = x[tok].float()
        h = F.silu(xe @ p["wg"][j].float()) * (xe @ p["wu"][j].float())
        y.index_add_(0, tok, (h @ p["wo"][j].float()) * flat_gate[idx, None])
        kept += idx.numel()
    if cfg.shared_expert:
        xf = x.float()
        y += (F.silu(xf @ p["sh_wg"].float()) * (xf @ p["sh_wu"].float())
              ) @ p["sh_wo"].float()
    return y, n * k - kept


def check_moe_layer(torch, dev: str, cfg, sv: dict) -> dict:
    """One MoE layer of ``cfg`` at full width, bf16 on the card, at the
    shapes (c) serves it: the prefill's B x prompt tokens and a decode
    step's B.  ``moe_ffn`` on the block's normed input (``rms_norm`` of a
    N(0, 1) hidden state; in the skewed prefill plus 3 x one direction
    that every token shares, so tokens route alike and the capacity bound
    drops, as on the served path's random weights) held against
    ``moe_ffn_plain`` in float32 on the same bf16 weights and input
    (N(0, 0.02), seed 7), max|diff| / max|ref| < 0.03 (the models' bf16
    limit); the routing's own drop count must equal the plain version's."""
    from repro_torch.models import moe
    from repro_torch.models.layers import rms_norm
    g = torch.Generator(device=dev).manual_seed(7)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def draw(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
    p = {"router": draw(d, e), "wg": draw(e, d, f), "wu": draw(e, d, f),
         "wo": draw(e, f, d)}
    if cfg.shared_expert:
        p |= {"sh_wg": draw(d, f), "sh_wu": draw(d, f), "sh_wo": draw(f, d)}
    ln2 = torch.ones(d, device=dev)
    res = {}
    for what, s, skew in (("prefill", sv["prompt_len"], 0.0),
                          ("prefill_skewed", sv["prompt_len"], 3.0),
                          ("decode_step", 1, 0.0)):
        x = (torch.randn((sv["requests"], s, d), generator=g, device=dev)
             + skew * torch.randn(d, generator=g, device=dev)
             ).to(torch.bfloat16)
        h = rms_norm(x, ln2)
        moe.dropped = torch.zeros((), dtype=torch.int64, device=dev)
        try:
            t0 = time.perf_counter()
            got = moe.moe_ffn(p, h, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            dropped = int(moe.dropped)
        finally:
            moe.dropped = None
        want, want_dropped = moe_ffn_plain(torch, p, h.reshape(-1, d), cfg)
        got = got.reshape(-1, d)
        if got.dtype != torch.bfloat16 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"moe layer {what}: malformed output")
        rel = float((got.float() - want).abs().max() / want.abs().max())
        res[what] = {"tokens": got.shape[0], "rel_err": rel, "limit": 0.03,
                     "dropped": dropped, "dropped_plain": want_dropped,
                     "assignments": got.shape[0] * cfg.top_k,
                     "wall_s": wall}
        del x, h, got, want
        if not rel < 0.03 or dropped != want_dropped:
            emit({"phase": "moe_layer", "arch": cfg.name, **res})
            raise AssertionError(f"moe layer {what}: {res[what]}")
    res = {"phase": "moe_layer", "arch": cfg.name,
           "weights": "one layer, bf16, N(0, 0.02) seed 7", **res,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(res)
    return res


def reset_counts(torch) -> None:
    """Free what the last run left, reset the peak memory and the
    attention kernels' launch counts, and wait for the card."""
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.launches = 0
    flash_ops.bwd_launches = 0
    decode_ops.launches = 0
    torch.cuda.synchronize()


def attn_counts() -> dict:
    """The attention kernels' launch counts since ``reset_counts``."""
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    return {"flash_attention": flash_ops.launches,
            "decode_attention": decode_ops.launches}


def serve_phase(torch, dev: str) -> dict:
    """Phase 7: (a) the serve controller against its pins, (b) h2o-danube
    and (c) mixtral served at full width through the port's serve entry
    point, each with its launch counts (reset just before, read just
    after) and peak memory, then its decode-vs-prefill check.  Returns the
    attention kernels' launch totals."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _serve, serve
    from repro_torch.models import moe
    t_phase = time.perf_counter()
    totals = {"flash_attention": 0, "decode_attention": 0}

    # (a) the serve controller, held against the reference's answers
    pins = json.loads(SERVE_PINS.read_text())
    api = serve_api()
    for policy in SERVE_POLICIES:
        reset_counts(torch)
        t0 = time.perf_counter()
        rec = run_serve_controller(api, policy)
        wall = time.perf_counter() - t0
        hold(f"serve controller {policy}", rec, pins[policy])
        emit({"phase": "serve_controller", "policy": policy, "wall_s": wall,
              "pin_equal": True, "steps": rec["steps"],
              "replicas": rec["replicas"], "level": rec["level"],
              "theta": rec["result"]["theta"],
              "busyness": rec["result"]["busyness"],
              "windows": len(rec["history"]),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": attn_counts()})

    # (b) h2o-danube-1.8b, full width and depth, window binding
    arch = "h2o-danube-1.8b"
    cfg, sv = get_config(arch), SERVE_7[arch]
    reset_counts(torch)
    res = serve(arch, reduced=False, verbose=False, device=dev, **sv)
    got = attn_counts()
    check_served(cfg, sv, res, got)
    emit({"phase": "serve_window", "reduced": False, "window": cfg.window,
          **sv, **res})
    for k, n in got.items():
        totals[k] += n
    reset_counts(torch)
    check_decode_matches_prefill(torch, dev, cfg, sv["prompt_len"])

    # (c) mixtral-8x7b, full width, depth cut to fit the card
    arch = "mixtral-8x7b"
    full, sv = get_config(arch), SERVE_7[arch]
    cfg = full.replace(num_layers=MIXTRAL_LAYERS)
    cut = {"num_layers": [MIXTRAL_LAYERS, full.num_layers]}
    reset_counts(torch)
    moe.dropped = torch.zeros((), dtype=torch.int64, device=dev)
    try:
        res = _serve(cfg, dev=torch.device(dev), seed=0, **sv)
        dropped = int(moe.dropped)
    finally:
        moe.dropped = None
    got = attn_counts()
    check_served(cfg, sv, res, got)
    emit({"phase": "serve_moe", "reduced": cut, "window": cfg.window,
          "experts": cfg.num_experts, "top_k": cfg.top_k,
          "moe_dropped_run": dropped,
          "moe_assignments_run": cfg.num_layers // cfg.moe_period
          * cfg.top_k * sv["requests"] * (sv["prompt_len"] + sv["decode"]),
          **sv, **res})
    for k, n in got.items():
        totals[k] += n
    reset_counts(torch)
    check_decode_matches_prefill(torch, dev, cfg, sv["prompt_len"],
                                 reduced=cut)
    reset_counts(torch)
    check_moe_layer(torch, dev, cfg, sv)
    emit({"phase": "serve_done", "seconds": time.perf_counter() - t_phase,
          "launches": totals})
    return totals


# ------------------------------------------- chunk, VLM and encoder-decoder
# Phase 8 serves the reference's remaining attention families at full
# width: (a) llama4-maverick-400b-a17b, 2 of its 48 layers (one dense and
# one MoE layer: ~16.5 B parameters in bf16 plus embed and unembed, ~37
# GB), 2 x 10,240 prompt tokens across its 8,192-token chunk edge, so the
# chunk mask binds in prefill and every decode step reads the span from
# slot 8,192; (b) internvl2-26b at full depth (48 layers, ~42 GB), 256
# image embeddings and 1,792 text tokens a request; (c) whisper-medium at
# full depth (24 + 24 layers) over 1,500 frames a request.
LLAMA4 = "llama4-maverick-400b-a17b"
WHISPER = "whisper-medium"
LLAMA4_LAYERS = 2
SERVE_8 = {LLAMA4: dict(requests=2, prompt_len=10240, decode=64),
           "internvl2-26b": dict(requests=8, prompt_len=1792, decode=64),
           WHISPER: dict(requests=8, prompt_len=384, decode=64)}


def families_phase(torch, dev: str) -> dict:
    """Phase 8: llama4-maverick (depth cut), internvl2-26b and
    whisper-medium served at full width through the port's serve entry
    point, each with its launch counts (reset just before, read just
    after) and peak memory, then its decode-vs-prefill check; every model
    is freed before the next one.  Returns the attention kernels' launch
    totals."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _serve, prefix_len, serve
    from repro_torch.models import moe
    from repro_torch.models.layers import decode_slot_range
    t_phase = time.perf_counter()
    totals = {"flash_attention": 0, "decode_attention": 0}
    for arch, sv in SERVE_8.items():
        cfg = get_config(arch)
        line = {"phase": "serve_family", "arch": arch, "family": cfg.family,
                "reduced": False, **sv}
        reset_counts(torch)
        if arch == LLAMA4:
            line["reduced"] = {"num_layers": [LLAMA4_LAYERS, cfg.num_layers]}
            cfg = cfg.replace(num_layers=LLAMA4_LAYERS)
            t = sv["prompt_len"]
            line["chunk_attn"] = cfg.chunk_attn
            line["decode_spans"] = [
                list(decode_slot_range(t + i, t + sv["decode"], cfg.window,
                                       cfg.chunk_attn))
                for i in (0, sv["decode"] - 1)]
            moe.dropped = torch.zeros((), dtype=torch.int64, device=dev)
            try:
                res = _serve(cfg, dev=torch.device(dev), seed=0, **sv)
                line["moe_dropped_run"] = int(moe.dropped)
            finally:
                moe.dropped = None
            line["moe_assignments_run"] = (
                cfg.num_layers // cfg.moe_period * cfg.top_k
                * sv["requests"] * (sv["prompt_len"] + sv["decode"]))
        else:
            res = serve(arch, reduced=False, verbose=False, device=dev, **sv)
        got = attn_counts()
        check_served(cfg, sv, res, got)
        line["first_decode_position"] = prefix_len(cfg) + sv["prompt_len"]
        emit({**line, **res})
        for k, n in got.items():
            totals[k] += n
        reset_counts(torch)
        check_decode_matches_prefill(torch, dev, cfg, sv["prompt_len"],
                                     reduced=line["reduced"])
    reset_counts(torch)
    emit({"phase": "families_done",
          "seconds": time.perf_counter() - t_phase, "launches": totals})
    return totals


# ------------------------------------------------ state-space and hybrid
# Phase 9 serves the two families whose decode state is constant in the
# context, at full width and depth: (a) recurrentgemma-2b (18 RG-LRU and
# 8 local-attention layers, head dim 256, 10 q-heads on one KV head; ~2.9
# B parameters: the layer matrices in bf16, ~4.5 GB, and the 256,000 x
# 2,560 embedding in float32, 2.6 GB), 8 x 4,096 prompt tokens, so its
# 2,048-token window binds on every row past position 2,047, then 128
# decode steps; (b) mamba2-130m (24 SSD layers), 8 x 8,192 prompt tokens
# (32 chunks of 256), then 128 decode steps.  recurrentgemma launches 8
# flash and 8 decode kernels a step; mamba2 launches none, checked as
# such.
HYBRID = "recurrentgemma-2b"
SSM = "mamba2-130m"
SERVE_9 = {HYBRID: dict(requests=8, prompt_len=4096, decode=128),
           SSM: dict(requests=8, prompt_len=8192, decode=128)}


def state_space_phase(torch, dev: str) -> dict:
    """Phase 9: recurrentgemma-2b and mamba2-130m served at full width and
    depth through the port's serve entry point, each with its launch
    counts (reset just before, read just after) and peak memory, then its
    decode-vs-prefill check; each model is freed before the next.
    Returns the attention kernels' launch totals."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.layers import decode_slot_range
    t_phase = time.perf_counter()
    totals = {"flash_attention": 0, "decode_attention": 0}
    for arch, sv in SERVE_9.items():
        cfg = get_config(arch)
        line = {"phase": "serve_state_space", "arch": arch,
                "family": cfg.family, "reduced": False, "layers":
                cfg.num_layers, "attention_layers": attn_launches(cfg)[0],
                **sv}
        t = sv["prompt_len"]
        if cfg.family == "hybrid":
            line["window"] = cfg.window
            line["decode_spans"] = [
                list(decode_slot_range(t + i, t + sv["decode"], cfg.window,
                                       None))
                for i in (0, sv["decode"] - 1)]
        else:
            line["ssd_chunks"] = -(-t // cfg.ssd_chunk)
        reset_counts(torch)
        res = serve(arch, reduced=False, verbose=False, device=dev, **sv)
        got = attn_counts()
        check_served(cfg, sv, res, got)
        emit({**line, **res})
        for k, n in got.items():
            totals[k] += n
        reset_counts(torch)
        check_decode_matches_prefill(torch, dev, cfg, t)
    reset_counts(torch)
    emit({"phase": "state_space_done",
          "seconds": time.perf_counter() - t_phase, "launches": totals})
    return totals


# ---------------------------------------------------------------- training
# Phase 10 trains on the card.  (a) The flash backward kernel
# (csrc/flash_attn_bwd.cu) against its plain version,
# ``flash_attention_bwd_ref``, over a sweep of every mask, group and head
# dim of the trainable families, and timed at llama3.2-3b's training shape
# (2 x 2,048 tokens, Hq 24 on Hk 8, D 128, causal): bf16 within 3e-2 of
# max|ref| per gradient (the kernel rounds P and dS to bf16 for its
# products, the plain version stays in float32), f32 within 1e-4; every
# case run twice, equal bit for bit (no atomics).  (b)
# ``repro_torch.launch.train.train("llama3.2-3b", reduced=False)`` at full
# width and depth, 4 steps on one repeated batch of 2 x 2,048 tokens: the
# first loss near a random initialisation's (ln V plus half the logits'
# variance, 0.02^2 d), falling over the steps, 56 forward (28 and their
# recomputation under remat) and 28 backward flash launches a step; then
# one full-width layer's gradients through the kernels in bf16 against the
# same layer in float32 on the plain attention.  (c) Every reduced
# family's 3 training steps against the reference's losses pinned in
# tests/data/torch_train.json, and a ``fail_at`` restart through a
# checkpoint at reduced size (a full-width checkpoint is 38.5 GB: left
# out).
TRAIN = dict(steps=4, batch=2, seq=2048)
TRAIN_PINS = ROOT / "tests" / "data" / "torch_train.json"
TRAIN_PIN = dict(steps=3, batch=2, seq=64, seed=0, lr=1e-3)
# a pinned loss is a mean over 126 tokens' NLLs: the port on the CPU lands
# within 2.3e-5 of the reference's; the card's bf16 kernels also round the
# probabilities and dS to bf16, which moves a mean far less than 1e-3
TRAIN_PIN_TOL = 1e-3
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# max|got - want| / max|want| of whole losses or gradients, by compute dtype
REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def flash_bwd_cases(torch, dev):
    """(label, dtype name, q, k, v, causal, window, chunk): the reduced
    configs' shapes (D 16: causal, window 32, chunk 32, the encoder and the
    cross-attention), ragged lengths, Sq > Skv (rows with no key) and
    Sq < Skv, no causal mask, h2o-danube's D 80 under a window, llama4's
    chunk with and without the causal mask and with a window, whisper's
    cross shape (D 64), recurrentgemma's D 256 with 10 q-heads on one KV
    head, D 160 and 48, a window of 1, groups 1 to 10, and the training
    path's [B, S, H, D] views; bf16 and f32.  For the wgmma route (bf16)
    also lengths ragged against its 64- and 128-row tiles (129, 191,
    1,000), Sq above and below Skv, a chunk with a window and without the
    causal mask, D 16, an MQA whose group ``bwd_plan`` cuts into shares of
    one head, groups of 3 that it cuts into shares of 1 and 2 heads, run
    again walked whole by the ``shares`` argument (the last item of a
    case: None for the plan's cut), groups of 2 that it walks whole, and
    operands whose strides TMA cannot read (copied first); and the same
    at D 256 against the wide kernels' 64- and 32-key tiles (recurrent-
    gemma's group of 10 cut by the plan and walked whole), with D 192."""
    g = torch.Generator(device="cpu").manual_seed(60)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for b, sq, skv, hq, hk, d, causal, window, chunk in (
                (2, 64, 64, 4, 2, 16, True, None, None),
                (2, 64, 64, 4, 2, 16, True, 32, None),
                (2, 64, 64, 4, 2, 16, True, None, 32),
                (2, 16, 16, 4, 2, 16, False, None, None),
                (2, 64, 16, 4, 2, 16, False, None, None),
                (1, 300, 300, 8, 2, 128, True, None, None),
                (1, 513, 513, 3, 1, 64, False, None, None),
                (1, 513, 300, 4, 4, 128, True, None, None),
                (1, 200, 700, 6, 1, 128, True, None, None),
                (1, 700, 700, 4, 1, 80, True, 256, None),
                (1, 1000, 1000, 5, 1, 128, True, None, 300),
                (1, 513, 513, 5, 1, 64, False, None, 100),
                (1, 600, 600, 6, 2, 128, True, 200, 256),
                (1, 300, 1500, 4, 4, 64, False, None, None),
                (1, 500, 500, 10, 1, 256, True, 128, None),
                (1, 300, 300, 2, 2, 160, True, None, None),
                (1, 300, 300, 2, 1, 48, True, 1, None),
                (1, 129, 129, 3, 1, 128, True, None, None),
                (1, 191, 1000, 5, 5, 64, True, None, None),
                (1, 1000, 191, 6, 1, 80, True, None, None),
                (1, 191, 191, 6, 2, 48, True, 1, None),
                (1, 1000, 1000, 3, 1, 16, True, 64, 128),
                (1, 129, 191, 5, 1, 64, False, None, 64),
                (1, 1024, 1024, 10, 1, 128, True, None, None),
                (2, 1024, 1024, 24, 8, 128, True, None, None),
                (4, 1100, 1100, 8, 4, 64, True, 300, None)):
            q = _randn(torch, g, (b, hq, sq, d), dev, dt)
            k = _randn(torch, g, (b, hk, skv, d), dev, dt)
            v = _randn(torch, g, (b, hk, skv, d), dev, dt)
            label = (f"{name} Sq={sq} Skv={skv} D={d} {hq}:{hk} "
                     f"causal={causal} window={window} chunk={chunk}")
            yield label, name, q, k, v, causal, window, chunk, None
            if dt == torch.bfloat16 and (b, hq, hk, sq) == (2, 24, 8, 1024):
                yield (f"{label} shares=1", name, q, k, v, causal, window,
                       chunk, 1)
    dt = torch.bfloat16
    # D 256 on the wide wgmma kernels (64-key dK/dV blocks, 32-key dQ
    # ring tiles): lengths ragged against them, Sq below and above Skv,
    # recurrentgemma's group of 10 on one KV head as the plan cuts it and
    # walked whole again, a window of 1, a chunk with and without the
    # causal mask, and D 192
    for b, sq, skv, hq, hk, d, causal, window, chunk in (
            (1, 129, 129, 3, 1, 256, True, None, None),
            (1, 191, 191, 2, 1, 256, True, 100, None),
            (1, 191, 1000, 2, 1, 256, True, None, None),
            (1, 1000, 191, 3, 1, 256, True, None, None),
            (1, 1024, 1024, 10, 1, 256, True, 512, None),
            (1, 300, 300, 2, 1, 256, True, 1, None),
            (1, 1000, 1000, 3, 1, 256, True, None, 300),
            (1, 513, 513, 2, 1, 256, False, None, 100),
            (1, 300, 300, 2, 1, 192, True, None, None)):
        q = _randn(torch, g, (b, hq, sq, d), dev, dt)
        k = _randn(torch, g, (b, hk, skv, d), dev, dt)
        v = _randn(torch, g, (b, hk, skv, d), dev, dt)
        label = (f"bfloat16 Sq={sq} Skv={skv} D={d} {hq}:{hk} "
                 f"causal={causal} window={window} chunk={chunk}")
        yield label, "bfloat16", q, k, v, causal, window, chunk, None
        if hq == 10:
            yield (f"{label} shares=1", "bfloat16", q, k, v, causal, window,
                   chunk, 1)
    for s, d, hq, hk in ((700, 128, 6, 2), (300, 256, 10, 1)):
        q = _randn(torch, g, (2, s, hq, d), dev, dt).transpose(1, 2)
        k = _randn(torch, g, (2, s, hk, d), dev, dt).transpose(1, 2)
        v = _randn(torch, g, (2, s, hk, d), dev, dt).transpose(1, 2)
        yield (f"bfloat16 [B,S,H,D] views Sq=Skv={s} D={d} {hq}:{hk} causal",
               "bfloat16", q, k, v, True, None, None, None)
    # rows 136 (520) bytes apart: no TMA map can read them (the wrapper
    # copies)
    for d, hq, hk in ((64, 4, 2), (256, 3, 1)):
        q, k, v = (_randn(torch, g, (1, h, 300, d + 4), dev, dt)[..., :d]
                   for h in (hq, hk, hk))
        yield (f"bfloat16 strided (not TMA-ready) Sq=Skv=300 D={d} "
               f"{hq}:{hk} causal", "bfloat16", q, k, v, True, None, None,
               None)


def bwd_err(torch, got, want, dtype: str, label: str) -> float:
    """The worst of max|got - want| / max(max|want|, 2^-4) over (dq, dk,
    dv); raises past ``BWD_TOL[dtype]`` (NaN does not pass).  The inputs
    are N(0, 1), so the gradients are of order 1 but for a window of 1:
    each row then keeps one key, whose softmax has no gradient, so dq and
    dk are 0 but for rounding (dP - Delta, two sums of the same products
    in different orders), and the floor keeps that rounding from reading
    as a relative error of order 1."""
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label} {name}: got {g.dtype} "
                                 f"{tuple(g.shape)}, want {w.dtype} "
                                 f"{tuple(w.shape)}")
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max().clamp_min(2.0 ** -4))
        if not err <= BWD_TOL[dtype]:
            raise AssertionError(f"{label} {name}: max|diff| / max|ref| "
                                 f"{err} > {BWD_TOL[dtype]}")
        worst = max(worst, err)
    return worst


def lse_check(torch, got, want, label: str) -> None:
    """The forward's log-sum-exp against the plain version's: +inf on the
    same rows (no key), within 1e-3 elsewhere."""
    inf = torch.isinf(want)
    if not torch.equal(torch.isinf(got), inf) or not bool(
            ((got - want).abs()[~inf] <= 1e-3).all()):
        raise AssertionError(f"{label}: lse off the plain version's")


def flash_bwd_sweep(torch, dev) -> tuple[dict, int]:
    """Every ``flash_bwd_cases`` case: the forward with its log-sum-exp
    against the plain version's, the backward kernel against
    ``flash_attention_bwd_ref`` on the same inputs (the kernel's output
    and log-sum-exp, a random dO), and a second backward launch equal bit
    for bit.  Returns (worst error per dtype, cases run)."""
    from repro_torch.kernels.flash_attn.kernel import (flash_attention,
                                                       flash_attention_bwd,
                                                       tma_ready)
    from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                    flash_attention_ref)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    g = torch.Generator(device="cpu").manual_seed(61)
    for label, name, q, k, v, causal, window, chunk, shares in \
            flash_bwd_cases(torch, dev):
        kw = dict(causal=causal, window=window, chunk_attn=chunk)
        out, lse = flash_attention(q, k, v, lse=True, **kw)
        want_o, want_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
        attn_err(torch, out, want_o, name, label)
        lse_check(torch, lse, want_lse, label)
        b, hq, sq, d = out.shape
        # dO as strided as q where q is (the padded columns are not read)
        do = _randn(torch, g, (b, hq, sq, d + (0 if tma_ready(q) else 4)),
                    dev, out.dtype)[..., :d]
        got = flash_attention_bwd(q, k, v, out, do, lse, shares=shares,
                                  **kw)
        want = flash_attention_bwd_ref(q, k, v, out, do, lse, **kw)
        worst[name] = max(worst[name], bwd_err(torch, got, want, name, label))
        again = flash_attention_bwd(q, k, v, out, do, lse, shares=shares,
                                    **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: backward not repeatable")
        n_cases += 1
    torch.cuda.synchronize()
    return worst, n_cases


def train_rank_attn(torch, dev, seed: int):
    """q, k, v as each rank of phase 15 (b) trains llama3.2-3b
    (``TRAIN_RANK_SHAPE``)."""
    from repro_torch.configs import get_config
    sh = TRAIN_RANK_SHAPE
    cfg = get_config(ARCH).replace(num_heads=sh["heads"],
                                   num_kv_heads=sh["kv_heads"])
    return train_attn_shape(torch, dev, cfg, sh["batch"], sh["seq"], seed)


def train_attn_shape(torch, dev, cfg, b: int, s: int, seed: int):
    """Attention as the training pass launches it for ``cfg``: q, k and v
    [B, S, H, D] projections seen as [B, H, S, D]."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return tuple(_randn(torch, g, (b, s, h, d), dev,
                        torch.bfloat16).transpose(1, 2)
                 for h in (hq, hk, hk))


def flash_bwd_row(torch, q, k, v, label: str, *, causal: bool = True,
                  window: int | None = None) -> dict:
    """The backward at one training shape (bf16): the kernel held against
    the plain version, then the bare launch (cold and warm), the wrapper,
    the plain version and the library call (the backward of
    ``scaled_dot_product_attention`` over KV heads repeated first) timed,
    and the operations bound of the five products over the attended
    pairs (bytes: q, k, v, o, dO and the log-sum-exp read, dq, dk and dv
    written; the kernel's own scratch, Delta and the shares' float32 dk/dv
    partials, is not counted).  The row names ``bwd_plan``'s route, shares,
    scratch and launches a call.  The operands are TMA-ready: the bare
    launch is all the wrapper launches."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn.kernel import (ROUTE_ID, bwd_plan,
                                                       flash_attention,
                                                       flash_attention_bwd)
    from repro_torch.kernels.flash_attn.ref import (attention_mask,
                                                    flash_attention_bwd_ref)
    kw = dict(causal=causal, window=window, chunk_attn=None)
    out, lse = flash_attention(q, k, v, lse=True, **kw)
    g = torch.Generator(device="cpu").manual_seed(62)
    do = _randn(torch, g, tuple(out.shape), q.device, out.dtype)
    got = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, do, lse, **kw)
    err = bwd_err(torch, got, want, "bfloat16", label)
    abs_err = float(max((a.float() - w.float()).abs().max()
                        for a, w in zip(got, want)))
    del want
    b, hq, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    fn = _build.library().flash_attn_bwd_bf16
    plan = bwd_plan(b, hq, hk, sq, skv, d, q.dtype, torch.cuda
                    .get_device_properties(q.device).multi_processor_count,
                    causal=causal, window=window)
    dq, dk, dv = got
    delta = torch.empty(plan.delta_elems, dtype=torch.float32,
                        device=q.device)
    part = (torch.empty(plan.part_elems, dtype=torch.float32,
                        device=q.device) if plan.part_elems else None)
    strides = (ctypes.c_int64 * 24)(*(st for t in (q, k, v, out, do, dq, dk,
                                                   dv)
                                      for st in t.stride()[:3]))
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), b, hq, hk, sq, skv, d,
            strides, int(causal), window or 0, 0, ROUTE_ID[plan.route],
            plan.shares, plan.delta_elems, plan.part_elems, stream)

    def launch():
        return fn(*args)
    _build.check(launch(), "flash_attn_bwd_bf16")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql = q.detach().requires_grad_(True)
    kl, vl = (t.repeat_interleave(hq // hk, dim=1).detach()
              .requires_grad_(True) for t in (k, v))
    if (window is None or window >= skv) and (not causal or sq == skv):
        ol = sdpa(ql, kl, vl, is_causal=causal)
    else:            # the window, or suffix-aligned causal, as a mask
        ol = sdpa(ql, kl, vl, attn_mask=attention_mask(
            sq, skv, q.device, causal=causal, window=window))
    pairs = attended_keys(sq, skv, window, causal)
    flops = 10 * b * hq * d * pairs
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + out.numel() + do.numel()) + 4 * lse.numel()
    flop_ms = flops / BF16_FLOP_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    res = {
        "max_abs_err": abs_err, "max_rel_err": err,
        "ms": device_ms(launch, cold=True),
        "warm_ms": device_ms(launch, cold=False, reps=10),
        "wrapper_ms": call_ms(lambda: flash_attention_bwd(
            q, k, v, out, do, lse, **kw), reps=10),
        "plain_ms": device_ms(lambda: flash_attention_bwd_ref(
            q, k, v, out, do, lse, **kw), cold=True, reps=5),
        "library_ms": device_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), cold=True),
        "bound_flop": flops, "bound_bytes": nbytes,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "bwd_route": plan.route, "shares": plan.shares,
        "scratch_bytes": plan.scratch_bytes,
        "launches_per_call": plan.launches,
        "split_warm_ms": bwd_split(torch, launch),
    }
    return add_rates(res, flops, "TFLOP/s")


def bwd_split(torch, launch, reps: int = 10) -> dict:
    """Device ms a call of each of the backward's kernels (prep or delta,
    dK/dV, the group sum, dQ), from torch.profiler over ``reps`` bare
    launches back to back (warm L2)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        found = re.search(r"flash_bwd_\w+", e.key)
        if e.device_type == DeviceType.CUDA and found:
            name = found.group(0)
            split[name] = split.get(name, 0.0) + (
                e.self_device_time_total / 1e3 / reps)
    return split


def check_flash_bwd(torch, dev) -> dict:
    """Phase 10 (a): the sweep, then the row at llama3.2-3b's training
    shape (the kernel line's main row), at h2o-danube-1.8b's (D 80, 32
    q-heads on 8, window 4,096 binding over 6,144 tokens, its serving
    prompt: ``window_shape``),
    at recurrentgemma-2b's (D 256, 10 q-heads on one KV head, window
    2,048 binding over 4,096 tokens: ``hybrid_shape``), at llama's on each
    rank of phase 15 (b) (``train_rank_shape``) and at whisper-medium's
    and recurrentgemma-2b's on each rank of phase 17 (b)
    (``family_train_attn``)."""
    from repro_torch.configs import get_config
    worst, n_cases = flash_bwd_sweep(torch, dev)
    res = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
        "replaces": "src/repro/kernels/flash_attn/kernel.py:102 (its "
                    "backward: no TPU counterpart; the reference "
                    "differentiates chunked_attention, "
                    "src/repro/models/layers.py:98, by autodiff)",
        "sweep_cases": n_cases, "sweep_max_rel_err": worst,
    }
    for key, arch, b, s, seed in ((None, ARCH, TRAIN["batch"], TRAIN["seq"],
                                   63),
                                  ("window_shape", "h2o-danube-1.8b", 1, 6144,
                                   65),
                                  ("hybrid_shape", HYBRID, 1, 4096, 64),
                                  ("train_rank_shape", ARCH,
                                   TRAIN_RANK_SHAPE["batch"],
                                   TRAIN_RANK_SHAPE["seq"], 66)):
        cfg = get_config(arch)
        if key == "train_rank_shape":        # one rank's heads, phase 15 (b)
            cfg = cfg.replace(num_heads=TRAIN_RANK_SHAPE["heads"],
                              num_kv_heads=TRAIN_RANK_SHAPE["kv_heads"])
        q, k, v = train_attn_shape(torch, dev, cfg, b, s, seed)
        row = {"shape": f"{arch} training: q [{b}, {cfg.num_heads}, {s}, "
                        f"{cfg.head_dim}], k/v [{b}, {cfg.num_kv_heads}, "
                        f"{s}, {cfg.head_dim}] bf16 ([B, S, H, D] views), "
                        f"causal, window {cfg.window}",
               **flash_bwd_row(torch, q, k, v, f"flash bwd {arch}",
                               window=cfg.window)}
        if key is None:
            res.update(row)
        else:
            res[key] = row
        del q, k, v
        torch.cuda.empty_cache()
    for key, arch, q, k, v, mask in family_train_attn(torch, dev):
        res[key] = {"shape": f"{arch} training on each rank of phase 17 "
                             f"(b): q {list(q.shape)}, k/v {list(k.shape)} "
                             f"bf16 ([B, S, H, D] views), {mask}",
                    **flash_bwd_row(torch, q, k, v, f"flash bwd {arch} {key}",
                                    **mask)}
        del q, k, v
        torch.cuda.empty_cache()
    q, k, v = seq_rank_attn(torch, dev, 67, train=True)
    res["seq_train_rank_shape"] = {
        "shape": f"{ARCH} training on each rank of phase 18 (b) under "
                 f"attn_shard=\"seq\" (the last block of query positions): "
                 f"q {list(q.shape)}, k/v {list(k.shape)} bf16 ([B, S, H, "
                 f"D] views), causal, query row i at i + Skv - Sq",
        **flash_bwd_row(torch, q, k, v, f"flash bwd {ARCH} seq rank")}
    del q, k, v
    torch.cuda.empty_cache()
    emit({"phase": "kernel", **res})
    return res


def init_loss(cfg) -> float:
    """The expected first loss of the reference's initialisation: the
    logits h . E_j of a unit-RMS final state against N(0, 0.02^2)
    embedding rows are N(0, 0.02^2 d), so E[logsumexp] = ln V plus half
    that variance, and the gold logit averages 0."""
    return math.log(cfg.vocab_size) + 0.02 ** 2 * cfg.d_model / 2


def n_params(cfg) -> int:
    """The parameters of ``cfg``'s tree."""
    from repro_torch.models import get_model

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return math.prod(t)
    return count(get_model(cfg).param_shapes(cfg))


def train_full(torch, dev: str) -> dict:
    """Phase 10 (b), first part: llama3.2-3b trained at full width and
    depth through the user's entry point.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch.train import train
    cfg = get_config(ARCH)
    reset_counts(torch)
    flash_ops.bwd_launches = 0
    res = train(ARCH, reduced=False, device=dev, verbose=False,
                repeat_batch=True, **TRAIN)
    got = {"flash_attention": flash_ops.launches,
           "flash_attention_bwd": flash_ops.bwd_launches}
    want = {"flash_attention": 2 * cfg.num_layers * TRAIN["steps"],
            "flash_attention_bwd": cfg.num_layers * TRAIN["steps"]}
    losses = res["losses"]
    expect = init_loss(cfg)
    tokens = TRAIN["batch"] * TRAIN["seq"]
    n = n_params(cfg)
    line = {"phase": "train", "arch": ARCH, "reduced": False, **TRAIN,
            "repeat_batch": True, "remat": cfg.remat, "params": n,
            "expected_first_loss": expect, **res,
            "launches": got, "launches_want": want,
            "model_flop_share": 6 * n * tokens / res["step_s"]
            / BF16_FLOP_PER_S}
    emit(line)
    if got != want:
        raise AssertionError(f"training launched {got}, want {want}")
    if not all(math.isfinite(x) for x in losses) or not (
            abs(losses[0] - expect) < 0.5 and losses[-1] < losses[0]):
        raise AssertionError(f"training losses {losses}: want the first "
                             f"within 0.5 of {expect} and a fall")
    return got


def layer_grads(torch, dev: str, cfg, x, r, plain: bool) -> dict:
    """The gradients of sum(layer(x) * r) for one full-width llama layer
    (attention block, then SwiGLU FFN, "train" mode), every leaf float32
    N(0, 0.02) from seed 71 (norm scales ones), in ``cfg``'s compute
    dtype; ``plain`` routes the attention through the plain version."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.models import transformer as tfm
    shapes = tfm._attn_shapes(cfg, 1) | tfm._dense_ffn_shapes(cfg, 1)
    g = torch.Generator(device=dev).manual_seed(71)
    p = {}
    for name in sorted(shapes):
        shape = shapes[name][1:]
        p[name] = (torch.ones(shape, device=dev) if len(shape) == 1 else
                   torch.randn(shape, generator=g, device=dev) * 0.02)
        p[name].requires_grad_(True)
    dt = getattr(torch, cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=dev)
    kernel = flash_ops.attention
    if plain:
        flash_ops.attention = flash_attention_ref
    try:
        y, _ = tfm.attn_block(p, x.to(dt), cfg, mode="train",
                              positions=positions)
        y = tfm.dense_ffn_block(p, y)
    finally:
        flash_ops.attention = kernel
    loss = torch.sum(y.float() * r)
    grads = torch.autograd.grad(loss, [p[n] for n in sorted(p)])
    return dict(zip(sorted(p), grads))


def check_layer_grads(torch, dev: str) -> dict:
    """Phase 10 (b), second part: one full-width llama3.2-3b layer on 2 x
    2,048 tokens, its gradients through the flash kernels in bf16 against
    the same layer in float32 on the plain attention, every leaf within
    3e-2 of max|ref| (wq, wk and wv get theirs through the backward
    kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as flash_ops
    cfg = get_config(ARCH)
    g = torch.Generator(device="cpu").manual_seed(72)
    shape = (TRAIN["batch"], TRAIN["seq"], cfg.d_model)
    x = torch.randn(shape, generator=g).to(dev)
    r = torch.randn(shape, generator=g).to(dev)
    reset_counts(torch)
    flash_ops.bwd_launches = 0
    got = layer_grads(torch, dev, cfg, x, r, plain=False)
    launches = {"flash_attention": flash_ops.launches,
                "flash_attention_bwd": flash_ops.bwd_launches}
    want = layer_grads(torch, dev, cfg.replace(compute_dtype="float32"), x,
                       r, plain=True)
    errs = {n: float((got[n].float() - want[n]).abs().max()
                     / want[n].abs().max().clamp_min(1e-30)) for n in want}
    res = {"phase": "train_layer", "arch": ARCH, "tokens": list(shape[:2]),
           "rel_err": errs, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(res)
    if launches != {"flash_attention": 1, "flash_attention_bwd": 1}:
        raise AssertionError(f"layer launched {launches}")
    bad = {n: e for n, e in errs.items() if not e <= REL_TOL["bfloat16"]}
    if bad:
        raise AssertionError(f"layer gradients off the plain f32 layer: {bad}")
    return res


def train_pin_inputs(cfg, seed: int = TRAIN_PIN["seed"]):
    """The pinned runs' inputs, from ``numpy.random.default_rng(seed)``:
    the parameters (``cfg``'s tree: N(0, 0.02) float32 for every leaf of
    two or more dimensions, ones for the rest, drawn in sorted path order)
    and one batch a step (tokens, a VLM's ``img_emb``, an enc-dec's
    ``frames``).  Numpy's draws are the same on every machine, which
    torch's and jax's are not between each other."""
    import numpy as np
    from repro_torch.models import get_model
    r = np.random.default_rng(seed)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(t[k]) for k in sorted(t)}
        return (np.ones(t, np.float32) if len(t) == 1 else
                (r.standard_normal(t, dtype=np.float32) * 0.02))
    params = draw(get_model(cfg).param_shapes(cfg))
    b, s = TRAIN_PIN["batch"], TRAIN_PIN["seq"]
    batches = []
    for _ in range(TRAIN_PIN["steps"]):
        bt = {"tokens": r.integers(0, cfg.vocab_size, (b, s))
              .astype(np.int32)}
        if cfg.family == "vlm":
            bt["tokens"] = bt["tokens"][:, :s - cfg.img_tokens]
            bt["img_emb"] = r.standard_normal((b, cfg.img_tokens, 1024),
                                              dtype=np.float32)
        if cfg.family == "encdec":
            bt["frames"] = r.standard_normal((b, cfg.enc_seq, 1024),
                                             dtype=np.float32)
        batches.append(bt)
    return params, batches


def run_train_pin(torch, arch: str, dev: str) -> dict:
    """The port's ``make_train_step`` on ``arch``'s reduced config for the
    pinned steps from ``train_pin_inputs`` (parameters cast to the
    config's param dtype): {"losses": [...]}."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(arch).reduced()
    np_params, batches = train_pin_inputs(cfg)
    params = params_from_numpy(np_params, dev,
                               getattr(torch, cfg.param_dtype))
    ocfg = AdamWConfig(lr=TRAIN_PIN["lr"], opt_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    losses = []
    for bt in batches:
        data = {k: torch.from_numpy(v).to(dev).long() if k == "tokens"
                else torch.from_numpy(v).to(dev) for k, v in bt.items()}
        params, opt, m = step(params, opt, data)
        losses.append(float(m["loss"]))
    return {"losses": losses}


def hold_losses(label: str, got: list, want: list) -> float:
    """The worst |got - want| / |want| over the steps; raises past
    ``TRAIN_PIN_TOL``."""
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if len(got) != len(want) or not all(e <= TRAIN_PIN_TOL for e in errs):
        raise AssertionError(f"{label}: losses {got}, pinned {want}")
    return max(errs)


def train_reduced(torch, dev: str) -> dict:
    """Phase 10 (c): every reduced family's pinned steps on the card, and a
    ``fail_at`` restart through a checkpoint (llama3.2-3b reduced: 4 steps,
    a checkpoint every 2, the failure at step 3) whose losses equal the
    unfailed run's.  Returns the flash launch counts."""
    import shutil
    from repro_torch.configs import list_archs
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch.train import train
    pins = json.loads(TRAIN_PINS.read_text())
    reset_counts(torch)
    flash_ops.bwd_launches = 0
    for arch in list_archs():
        t0 = time.perf_counter()
        got = run_train_pin(torch, arch, dev)
        err = hold_losses(arch, got["losses"], pins[arch]["losses"])
        emit({"phase": "train_pin", "arch": arch, "reduced": True,
              **TRAIN_PIN, "losses": got["losses"],
              "pinned": pins[arch]["losses"], "max_rel_err": err,
              "wall_s": time.perf_counter() - t0})
    ckpt = OUT / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(reduced=True, steps=4, batch=2, seq=64, device=dev,
              verbose=False)
    plain = train(ARCH, **kw)
    failed = train(ARCH, ckpt_dir=str(ckpt), ckpt_every=2, fail_at=3, **kw)
    shutil.rmtree(ckpt, ignore_errors=True)
    line = {"phase": "train_restart", "arch": ARCH, "reduced": True,
            "restarts": failed["restarts"], "losses": failed["losses"],
            "unfailed_losses": plain["losses"]}
    emit(line)
    if failed["restarts"] != 1 or failed["losses"][-1] != \
            plain["losses"][-1] or failed["losses"][3] != plain["losses"][2]:
        raise AssertionError(f"restart through a checkpoint: {line}")
    return {"flash_attention": flash_ops.launches,
            "flash_attention_bwd": flash_ops.bwd_launches}


# device kernels of a training step by group (name substrings), for
# ``profile_train``; the rest is elementwise, reduction, copy and the like
TRAIN_GROUPS = {"flash_fwd": ("flash_fwd",), "flash_bwd": ("flash_bwd",),
                "matmul": ("gemm", "nvjet", "xmma", "cutlass", "Kernel2")}


def profile_train(torch, dev: str = "cuda", steps: int = 2) -> None:
    """llama3.2-3b at full width and depth, ``TRAIN``'s batch repeated:
    one warm step, ``steps`` steps on the host clock, then ``steps``
    under torch.profiler: per step the wall s, the device s, the device
    time by kernel group (``TRAIN_GROUPS``) and the device's busy share
    of the unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import _init, synth_batch
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(ARCH)
    device = torch.device(dev)
    params = _init(get_model(cfg), cfg, device, 0)
    ocfg = AdamWConfig(lr=1e-3, opt_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    data = synth_batch(cfg, TRAIN["batch"], TRAIN["seq"],
                       torch.Generator().manual_seed(1000), device)

    def run(n: int) -> None:
        nonlocal params, opt
        for _ in range(n):
            params, opt, _ = step(params, opt, data)
        torch.cuda.synchronize()

    OUT.mkdir(exist_ok=True)
    run(1)                                      # warm
    t0 = time.perf_counter()
    run(steps)
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    avgs = prof.key_averages()
    (OUT / "profile_train.txt").write_text(
        avgs.table(sort_by="self_device_time_total", row_limit=50))
    on_dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    dev_s = sum(e.self_device_time_total for e in on_dev) / 1e6 / steps
    groups = {}
    for name, marks in TRAIN_GROUPS.items():
        rows = [e for e in on_dev if any(m in e.key for m in marks)]
        groups[name] = {"calls": sum(e.count for e in rows) / steps,
                        "device_s": sum(e.self_device_time_total
                                        for e in rows) / 1e6 / steps}
    groups["other_device_s"] = dev_s - sum(g["device_s"]
                                           for g in groups.values())
    emit({"phase": "profile_train", "arch": ARCH, **TRAIN,
          "wall_s_per_step": wall, "device_s_per_step": dev_s,
          "device_busy_share": dev_s / wall, "groups": groups,
          "device_events_per_step": sum(e.count for e in on_dev) / steps,
          "top": [{"name": e.key[:70], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in on_dev[:15]]})
    del params, opt


def train_phase(torch, dev: str) -> dict:
    """Phase 10 (b) and (c).  Returns the flash kernels' launch totals
    (the backward's for the kernel line)."""
    t_phase = time.perf_counter()
    totals = train_full(torch, dev)
    reset_counts(torch)
    check_layer_grads(torch, dev)
    reset_counts(torch)
    for k, n in train_reduced(torch, dev).items():
        totals[k] += n
    reset_counts(torch)
    emit({"phase": "train_done", "seconds": time.perf_counter() - t_phase,
          "launches": totals})
    return totals


# ----------------------------------------------------------------- dry-run
# Phase 11 holds the dry-run (``repro_torch.launch.dryrun``) against the
# card.  (a) The card's own mesh, ``derive_mesh`` over its devices (1x1
# over cuda:0), and the restart plan for 500 of 512 devices.  (c) The
# cells whose arguments fit one card and whose step fits beside them
# (``dryrun.execute_cell``): the decode kernel first at the cell's own
# shape against its plain version, then the bytes asked of the allocator
# equal the dry-run's argument bytes, each attention kernel launches once
# per attention layer, the logits are finite; the steps' peak memory (what
# the reference's ``peak_memory_in_bytes`` would state) and median wall
# ms.  (b) Then the whole sweep: every arch x applicable shape lowered on
# the 16x16 and 2x16x16 meshes (traced on the meta device in worker
# processes, its flops counted) and on the card's 1x1 mesh, each cell's
# per-device argument and output bytes held against the reference's
# (``tests/data/torch_specs.json``) and against the card's memory.
SPEC_PINS = ROOT / "tests" / "data" / "torch_specs.json"
EXECUTED = (("h2o-danube-1.8b", "decode_32k"),
            ("h2o-danube-1.8b", "long_500k"),
            ("recurrentgemma-2b", "decode_32k"),
            ("recurrentgemma-2b", "long_500k"),
            ("mamba2-130m", "decode_32k"), ("mamba2-130m", "long_500k"))


def cell_decode_shape(torch, cfg, shape, seed: int):
    """A decode cell's attention on the card: one layer's q [B, Hq, D]
    bf16 against a [B, Hk, S, D] bf16 cache of the cell's ring slots (the
    shape of its abstract cache), and the slot range [lo, hi) the position
    mask leaves at ``t = seq_len - 1`` (``layers.decode_slot_range``): (q,
    k, v, lo, hi), or None for a cell with no attention cache."""
    from repro_torch.models.layers import decode_slot_range
    from repro_torch.models.model import abstract_cache
    from repro_torch.models.sharding import cpu_mesh_ctx
    from repro_torch.train.tree import leaves
    kv = [s.shape[-4:] for p, s in leaves(abstract_cache(
        cfg, shape, cpu_mesh_ctx())) if p.endswith("['k']")]
    if not kv:
        return None
    b, hk, s, d = kv[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(sh, generator=g, device="cuda",
                           dtype=torch.bfloat16)
               for sh in ((b, cfg.num_heads, d), (b, hk, s, d),
                          (b, hk, s, d)))
    lo, hi = decode_slot_range(shape.seq_len - 1, s, cfg.window,
                               cfg.chunk_attn)
    return q, k, v, lo, hi


def cell_decode_row(torch, cfg, shape, seed: int) -> dict | None:
    """The decode kernel at a decode cell's own shape: one layer's q
    [B, Hq, D] bf16 against a [B, Hk, S, D] bf16 cache of the cell's ring
    slots (the shape of its abstract cache), every row over the slot range
    the position mask leaves at ``t = seq_len - 1``
    (``layers.decode_slot_range``), held against its plain version at the
    bf16 tolerance and timed (``decode_row``), then run again and held
    bit-equal.  None for a cell with no attention cache."""
    from repro_torch.kernels.decode_attn.kernel import decode_attention
    from repro_torch.models.layers import slot_bounds
    found = cell_decode_shape(torch, cfg, shape, seed)
    if found is None:
        return None
    q, k, v, lo, hi = found
    b, hk, s, d = k.shape
    t = shape.seq_len - 1
    label = f"decode {cfg.name} {shape.name} shape"
    row = {"shape": f"{cfg.name} {shape.name} decode, window {cfg.window}, "
                    f"at t={t}: q [{b}, {cfg.num_heads}, {d}] bf16, caches "
                    f"[{b}, {hk}, {s}, {d}], slots [{lo}, {hi}) on every row",
           **decode_row(torch, q, k, v, lo, hi, label)}
    bounds = slot_bounds(q.device, b, lo, hi)
    first = decode_attention(q, k, v, bounds[1], bounds[0], hi - lo)
    if not torch.equal(decode_attention(q, k, v, bounds[1], bounds[0],
                                        hi - lo), first):
        raise AssertionError(f"decode_attention not repeatable: {label}")
    del q, k, v, first
    torch.cuda.empty_cache()
    return row


def executed_cells(torch, dryrun, pins: dict, card: int,
                   name_power: str) -> dict:
    """Phase 11 (c): each cell of ``EXECUTED``, its decode kernel checked
    at its shape, then run on the card (a warm-up step and
    ``dryrun.EXECUTE_STEPS`` timed ones), its launches counted from 0
    over all of them."""
    from repro_torch.configs import get_config, get_shape
    totals = {"flash_attention": 0, "decode_attention": 0}
    for i, (arch, sh) in enumerate(EXECUTED):
        cfg, shape = get_config(arch), get_shape(sh)
        per_prefill, per_step = attn_launches(cfg)
        want = {"flash_attention": per_prefill, "decode_attention": 0} \
            if shape.kind == "prefill" else \
            {"flash_attention": 0, "decode_attention": per_step}
        kernel = None if shape.kind == "prefill" else \
            cell_decode_row(torch, cfg, shape, seed=61 + i)
        if (kernel is None) != (per_step == 0):
            raise AssertionError(f"{arch} x {sh}: an attention cache "
                                 f"{kernel is not None}, attention layers "
                                 f"{per_step}")
        reset_counts(torch)
        rec = dryrun.execute_cell(cfg, shape)
        n_steps = 1 + dryrun.EXECUTE_STEPS
        launches = attn_counts()
        if rec["launches"] != want or launches != {
                k: n_steps * n for k, n in want.items()}:
            raise AssertionError(f"{arch} x {sh} launched {launches} in "
                                 f"{n_steps} steps (reported "
                                 f"{rec['launches']} a step), want {want} "
                                 f"a step")
        if rec["peak_bytes"] > card:
            raise AssertionError(f"{arch} x {sh} peaked past the card")
        emit({"phase": "dryrun_executed", **rec, "decode_kernel": kernel,
              "reference_argument_bytes": pins[arch]["bytes"]["1x1"][sh][0],
              "card_bytes": card, "nvidia_smi": name_power})
        for k, n in launches.items():
            totals[k] += n
    reset_counts(torch)
    return totals


def dryrun_phase(torch, name_power: str) -> dict:
    """Phase 11.  Returns the attention kernels' launch totals of (c)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.elastic import derive_mesh, elastic_restart_plan
    t_phase = time.perf_counter()
    mctx = derive_mesh(torch.cuda.device_count())
    devices = [str(d) for d in mctx.mesh.devices.flat]
    if mctx.mesh.shape != {"data": 1, "model": 1} or devices != ["cuda:0"]:
        raise AssertionError(f"the card's mesh is {mctx.mesh} over "
                             f"{devices}, not 1x1 over cuda:0")
    emit({"phase": "dryrun_mesh", "mesh": mctx.mesh.shape,
          "devices": devices,
          "restart_plan_512_500": elastic_restart_plan(512, 500),
          "nvidia_smi": name_power})

    pins = json.loads(SPEC_PINS.read_text())
    card = torch.cuda.get_device_properties(0).total_memory
    cells = dryrun.all_cells()
    # the executed cells' steps are timed before the sweep's worker
    # processes take the host's cores
    totals = executed_cells(torch, dryrun, pins, card, name_power)
    t0 = time.perf_counter()
    records = dryrun.sweep(cells, (False, True), verbose=False)
    sweep_s = time.perf_counter() - t0
    failed = [(r["arch"], r["shape"], r["mesh"], r["error"])
              for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"cells that did not lower: {failed}")
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in records}
    for arch, sh in cells:
        cfg, shape = get_config(arch), get_shape(sh)
        mem = dryrun.lower_cell(cfg, shape, mctx)[0].memory_analysis()
        per = {"1x1": [mem.argument_size_in_bytes, mem.output_size_in_bytes]}
        for mesh in ("16x16", "2x16x16"):
            rec = by[arch, sh, mesh]
            per[mesh] = [rec["argument_bytes"], rec["output_bytes"]]
        for mesh, got in per.items():
            if got != pins[arch]["bytes"][mesh][sh]:
                raise AssertionError(
                    f"{arch} x {sh} on {mesh}: {got} bytes, the "
                    f"reference's trees {pins[arch]['bytes'][mesh][sh]}")
        rec = by[arch, sh, "16x16"]
        emit({"phase": "dryrun_cell", "arch": arch, "shape": sh,
              "step": rec["step"], "bytes_per_device": per,
              "arguments_fit": {m: b[0] <= card for m, b in per.items()},
              "flops": rec["flops"], "attention_flops":
              rec["attention_flops"], "trace_s": rec["compile_s"],
              "nvidia_smi": name_power})

    emit({"phase": "dryrun_done", "seconds": time.perf_counter() - t_phase,
          "sweep_s": sweep_s, "cells": len(cells), "launches": totals,
          "nvidia_smi": name_power})
    return totals


# ------------------------------------------------------------ legacy store
# Phase 12 runs the frozen pre-columnar store (``state/legacy.py``, the A/B
# baseline of the columnar store) on the card.  (a) The four golden
# episodes under ``set_store_impl("legacy")``: decision-identical, every
# probe through ``sorted_probe``, ``window_agg`` never launched (the
# legacy store has no segment sum, so a launch would mean the columnar
# store ran).  (b) The store A/B: q8_justin under each store, alternating,
# ``AB_ROUNDS`` rounds, each episode in a fresh interpreter (allocator
# state left by one episode slows the next in one process), the minimum
# per store and their ratio.
# one round: two rounds took phase 12 to 175 s on an H100 (a development
# run); each fresh interpreter costs ~11 s of start-up besides its episode
AB_ROUNDS = 1
AB_EPISODE = "q8_justin"


def timed_episode(torch, key: str, golden: dict, dev: str
                  ) -> tuple[float, dict, dict]:
    """(wall s, ``run_episode``'s result, store-kernel launches) of one
    golden episode, the launch counts reset just before it."""
    from repro_torch.kernels.sorted_probe import ops as probe_ops
    from repro_torch.kernels.window_agg import ops as agg_ops
    probe_ops.launches = 0
    agg_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_episode(key, golden, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, res, {"sorted_probe": probe_ops.launches,
                       "window_agg": agg_ops.launches}


def ab_child(key: str, store: str) -> int:
    """``--ab-episode KEY --store STORE``: one golden episode on the card
    under ``store``, its wall seconds and launches as one JSON line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.state import lsm
    _build.library()
    lsm.set_store_impl(store)
    wall, res, launches = timed_episode(
        torch, key, json.loads(GOLDEN.read_text()), "cuda")
    emit({"episode": key, "store": store, "wall_s": wall,
          "launches": launches, "steps": res["steps"]})
    return 0


def ab_episode(key: str, store: str) -> dict:
    """One ``ab_child`` run in a fresh interpreter."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--ab-episode", key,
         "--store", store], capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"{key} under the {store} store failed: "
                             f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def legacy_phase(torch, golden: dict, dev: str, name_power: str) -> dict:
    """Phase 12.  Returns the store kernels' launch totals of (a)."""
    from repro_torch.state import lsm
    t_phase = time.perf_counter()
    totals = {"sorted_probe": 0, "window_agg": 0}
    # (a) the golden episodes under the legacy store
    lsm.set_store_impl("legacy")
    try:
        for key in ("q11_justin", "q8_justin", "q11_ds2", "q8_ds2"):
            wall, res, launches = timed_episode(torch, key, golden, dev)
            emit({"phase": "legacy_episode", "episode": key,
                  "wall_s": wall, "decisions_match_golden": True,
                  "launches": launches, **res})
            if launches["sorted_probe"] == 0:
                raise AssertionError(f"{key} under the legacy store never "
                                     f"launched sorted_probe")
            if launches["window_agg"]:
                raise AssertionError(
                    f"{key} under the legacy store launched window_agg "
                    f"{launches['window_agg']} times: the columnar store ran")
            totals["sorted_probe"] += launches["sorted_probe"]
    finally:
        lsm.set_store_impl("columnar")
    t_ab = time.perf_counter()

    # (b) the store A/B, each episode in a fresh interpreter
    walls = {"legacy": [], "columnar": []}
    for _ in range(AB_ROUNDS):
        for store in ("legacy", "columnar"):
            rec = ab_episode(AB_EPISODE, store)
            if store == "legacy" and rec["launches"]["window_agg"]:
                raise AssertionError(f"the legacy A/B episode launched "
                                     f"window_agg: {rec}")
            walls[store].append(rec["wall_s"])
            emit({"phase": "store_ab_episode", **rec,
                  "nvidia_smi": name_power})
    best = {k: min(v) for k, v in walls.items()}
    emit({"phase": "store_ab", "episode": AB_EPISODE, "rounds": AB_ROUNDS,
          "wall_s": walls, "min_s": best,
          "legacy_over_columnar": best["legacy"] / best["columnar"],
          "seconds": time.perf_counter() - t_ab, "nvidia_smi": name_power})

    emit({"phase": "legacy_done", "seconds": time.perf_counter() - t_phase,
          "launches": totals, "nvidia_smi": name_power})
    return totals


# ------------------------------------------------- the MoE block across ranks
# Phase 13 runs the MoE block across 8 ranks that share the one card: a
# gloo process group (``launch.mesh.run_ranks``), every rank on cuda:0
# with its own CUDA context; the compute stays on the card and the
# collectives go through host memory, so their times say nothing of
# NVLink.  Phase 3 holds both attention kernels against their plain
# versions at (b)'s shapes (``mesh_shape``).  (a) The pins: every case of ``tests/torch_mesh_cases.py``
# (float32, reduced) on the ranks against the reference's answers on 8
# devices (``tests/data/torch_mesh.json``) within ``MESH_PIN_TOL``, the
# CPU test's bound.  (b) Full width: mixtral-8x7b at its published widths
# with 2 of its 32 layers (4 before phase 17 came), bf16, on a 2x4 mesh in
# each of the three modes: 8 prompts of 512 tokens, then 2 decode steps
# fed the greedy tokens of the same 2 layers served 1x1 in this process
# (the reference path).
# "2d" computes the one-device function and is held to the 1x1 logits;
# "expert" and "ffn" route per dp shard and are held to each other; and
# the first layer's MoE block alone, on one input shared bit for bit, is
# held the same way (no upstream rounding can flip a route there), with
# the flipped routes reported.  Since phase 14 every rank holds its blocks
# of all the weights (FSDP over ``data``, TP over ``model``) and runs the
# decoder's sharded step, whose weight gathers go through gloo too (the
# experts' FSDP gathers: 2.9 GB a rank a step), so (b) runs 2 decode steps
# (16 before).
MESH_WORLD = 8
MESH_PIN_TOL = 2e-5
MESH_SHAPE = (2, 4)
MESH_SERVE = dict(arch="mixtral-8x7b", layers=2, requests=8,
                  prompt_len=512, decode=2, seed=0, reduced=False)
MESH_REL = 0.03                    # logits, PERF.md section 2
MESH_LAYER_REL = 2e-2              # the first layer's MoE output
MESH_MODES = ("expert", "ffn", "2d")


def mesh_cfg(sv: dict, mode: str | None = None):
    """(b)'s configuration: ``sv["arch"]`` cut to ``sv["layers"]`` layers
    (and an enc-dec's encoder to ``sv["enc_layers"]`` where given; its
    reduced form when ``sv["reduced"]``: the CPU rehearsal), under
    ``sv["knobs"]`` (config settings) where given, in ``mode`` when
    given."""
    from repro_torch.configs import get_config
    cfg = get_config(sv["arch"])
    if sv["reduced"]:
        cfg = cfg.reduced()
    cfg = cfg.replace(num_layers=sv["layers"])
    if "enc_layers" in sv:
        cfg = cfg.replace(enc_layers=sv["enc_layers"])
    cfg = cfg.replace(**sv.get("knobs", {}))
    return cfg if mode is None else cfg.replace(moe_shard=mode)


def mesh_sync(torch, dev: str) -> None:
    if dev != "cpu":
        torch.cuda.synchronize()


def mesh_layer_input(torch, cfg, sv: dict, dev: str):
    """The first MoE layer's input of (b): ``rms_norm`` of N(0, 1) hidden
    states [B, S, d] drawn from seed 7 on the card, in bf16 (the same
    bits in every process)."""
    from repro_torch.models.layers import rms_norm
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((sv["requests"], sv["prompt_len"], cfg.d_model),
                    generator=g, device=dev)
    return rms_norm(x.to(torch.bfloat16), torch.ones(cfg.d_model,
                                                     device=dev))


def mesh_routes(torch, moe, xf, router, k: int):
    """The experts ``_route_local`` selects for the tokens xf [N, d]: the
    same float32 product, softmax and top-k, on the same shapes."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    return moe.top_k(probs, k)[1]


def capture_routes(moe, store: list):
    """Record the experts every routing selects (``moe.top_k``'s indices,
    on the host) into ``store``; returns the function to put back."""
    orig = moe.top_k

    def top_k(probs, k):
        vals, idx = orig(probs, k)
        store.append(idx.cpu().numpy())
        return vals, idx

    moe.top_k = top_k
    return orig


def mesh_reference(torch, sv: dict, dev: str, prepare=None) -> dict:
    """A sharded serve's reference path: ``sv``'s layers served 1x1 in
    this process, the weights drawn as every rank draws them
    (``init_params``, the seed; the ranks keep only their blocks), and
    ``prepare(params, cfg)`` giving the tree and config served where it
    is given.
    Prefill, ``sv["decode"]`` greedy steps (the tokens fed are the argmax
    of the step before); for a MoE model also the experts each prefill
    layer routes to and the first MoE layer on ``mesh_layer_input`` with
    its routes.  An enc-dec's frames come from ``make_batch`` and the
    seed.  On the host as numpy."""
    import numpy as np
    from repro_torch.launch.serve import init_params, make_batch, pad_kv
    from repro_torch.models import get_model, moe
    cfg = mesh_cfg(sv)
    params = init_params(cfg, torch.device(dev), sv["seed"])
    if prepare is not None:
        params, cfg = prepare(params, cfg)
    model = get_model(cfg)
    toks = torch.as_tensor(np.random.default_rng(sv["seed"]).integers(
        0, cfg.vocab_size, (sv["requests"], sv["prompt_len"])), device=dev)
    res, routes = {}, []
    if cfg.num_experts:
        h = mesh_layer_input(torch, cfg, sv, dev)
        p0 = {k: v[0] for k, v in params["layers"]["moe"]["moe"].items()}
        res["layer0"] = moe.moe_ffn(p0, h, cfg)
        res["routes"] = mesh_routes(torch, moe, h.reshape(-1, cfg.d_model),
                                    p0["router"], cfg.top_k)
        del h
    moe.dropped = torch.zeros((), dtype=torch.int64, device=dev)
    orig = capture_routes(moe, routes)
    times = {}
    try:
        with torch.no_grad():
            mesh_sync(torch, dev)
            t0 = time.perf_counter()
            logits, caches = model.prefill(
                params, make_batch(cfg, toks, sv["seed"]), cfg)
            mesh_sync(torch, dev)
            times["prefill_s"] = time.perf_counter() - t0
            moe.top_k = orig
            out = [logits]
            fed = [logits.argmax(-1)]
            caches = pad_kv(caches, sv["decode"])
            t0 = time.perf_counter()
            for i in range(sv["decode"]):
                logits, caches = model.decode(params, caches,
                                              fed[-1][:, None],
                                              sv["prompt_len"] + i, cfg)
                out.append(logits)
                fed.append(logits.argmax(-1))
            mesh_sync(torch, dev)
            times["decode_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                           / sv["decode"])
        dropped = int(moe.dropped)
    finally:
        moe.dropped = None
        moe.top_k = orig
    res |= {"tokens": torch.cat([toks, torch.stack(fed[:-1], 1)], 1),
            "logits": torch.stack(out)}
    res = {k: v.cpu().numpy() if v.dtype != torch.bfloat16
           else v.float().cpu().numpy() for k, v in res.items()}
    del params, caches
    return res | {"dropped": dropped, "prefill_routes": routes,
                  "padded_heads": cfg.padded_heads, **times}


def rank_overheads(ranks: list, t_spawn: float, t_join: float) -> dict:
    """A ``run_ranks`` call's time outside its rank function (the ranks'
    ``t_enter`` / ``t_exit`` epoch stamps): from the spawn to the last
    rank's entry, and from the last rank's exit to the join."""
    return {"spawn_s": max(r["t_enter"] for r in ranks) - t_spawn,
            "join_s": t_join - max(r["t_exit"] for r in ranks)}


def collective_summary(mesh, per: int = 1) -> dict:
    """A mesh's collectives since its last reset: calls and output bytes
    by kind, each divided by ``per`` (the steps they span)."""
    calls, nbytes = {}, {}
    for (kind, _), rec in mesh.collective_log.items():
        calls[kind] = calls.get(kind, 0) + rec["calls"] / per
        nbytes[kind] = nbytes.get(kind, 0) + rec["bytes"] / per
    return {"calls": calls, "bytes": nbytes}


def rank_serve(torch, mctx, cfg, params, tokens, p_len: int, steps: int,
               dev: str, seed: int = 0) -> dict:
    """Serve on this rank of ``mctx``: the prefill over this rank's rows of
    ``tokens`` [B, p_len + steps] (numpy, global; its first ``p_len``
    columns; an enc-dec's frames from ``make_batch`` and ``seed``, as
    ``mesh_reference`` draws them), the caches grown to ``p_len + steps``
    slots, then ``steps``
    decode steps fed the rest, each timed between barriers on the host
    clock.  Returns the prefill s, decode ms a step, the collectives of
    the prefill and of a step (``collective_summary``), this rank's
    attention launches, peak memory, and the global logits of every step
    (float32 numpy; gathered after the timing)."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import get_model
    from repro_torch.models.convert import blocks, gathered
    from repro_torch.models.sharding import P
    model = get_model(cfg)
    mesh = mctx.mesh
    card = dev != "cpu"
    b = tokens.shape[0]
    dp = mctx.dp if b % mctx.dp_size == 0 else None
    toks = torch.as_tensor(blocks(np.asarray(tokens), P(dp, None), mctx),
                           device=dev)
    feed = {k: mctx.sharding(P(dp)).block(v).to(dev) for k, v in make_batch(
        cfg, torch.as_tensor(np.asarray(tokens)[:, :p_len]), seed).items()}
    layout = {"global_batch": b}
    res = {}
    flash_ops.launches = decode_ops.launches = 0
    if card:
        torch.cuda.reset_peak_memory_stats()
    mesh.reset_collectives()
    with torch.no_grad():
        dist.barrier()
        mesh_sync(torch, dev)
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, feed, cfg, mctx, **layout)
        mesh_sync(torch, dev)
        res["prefill_s"] = time.perf_counter() - t0
        res["prefill_collectives"] = collective_summary(mesh)
        out = [logits]
        caches = grow_caches(model, cfg, mctx, caches, p_len, steps, dp)
        if card:
            free, total = torch.cuda.mem_get_info()
            res["device_used_gb"] = (total - free) / 1e9
        mesh.reset_collectives()
        dist.barrier()
        mesh_sync(torch, dev)
        t0 = time.perf_counter()
        for i in range(steps):
            t = p_len + i
            logits, caches = model.decode(params, caches, toks[:, t:t + 1],
                                          t, cfg, mctx, n_slots=p_len + steps,
                                          **layout)
            out.append(logits)
        mesh_sync(torch, dev)
        res["decode_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                     / steps)
        res["decode_collectives_per_step"] = collective_summary(mesh, steps)
    res["launches"] = {"flash_attention": flash_ops.launches,
                       "decode_attention": decode_ops.launches}
    if card:
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    logits = torch.stack([gathered(lg, P(dp, "model"), mctx) for lg in out])
    res["logits_sum"] = float(logits.double().sum())
    if dist.get_rank() == 0:
        res["logits"] = logits.cpu().numpy()
    del caches, out, logits
    return res


def grow_caches(model, cfg, mctx, caches, s0: int, n: int, dp):
    """This rank's cache blocks of ``s0`` slots as its blocks of ``s0 + n``
    (the new slots empty; ``pad_kv`` grows the self-attention ``k``/``v``
    leaves alone): padded in place where ``model`` leaves the slots whole,
    else gathered, padded and cut again (``kv_spec`` may split or
    replicate the two lengths differently)."""
    from repro_torch.launch.serve import pad_kv
    from repro_torch.models.convert import blocks, gathered
    from repro_torch.models.model import drop_dp_axes

    def specs(slots):
        sp = model.cache_specs(cfg, mctx, slots)
        return sp if dp else drop_dp_axes(sp, mctx)

    def slots_split(sp) -> bool:
        return any(slots_split(v) if isinstance(v, dict)
                   else k in ("k", "v") and v[-2] is not None
                   for k, v in sp.items())

    old, new = specs(s0), specs(s0 + n)
    if old == new and not slots_split(new):
        return pad_kv(caches, n)
    return blocks(pad_kv(gathered(caches, old, mctx), n), new, mctx)


def mesh_serve_mode(torch, mctx, sv: dict, mode: str, tokens,
                    dev: str) -> dict:
    """One mode of (b) on this rank: its blocks of the weights every rank
    draws (the decoder's layout: ``param_specs``), the first MoE layer
    alone on this rank's rows of the shared input (its experts gathered
    from their FSDP storage), then ``rank_serve``, with the drops."""
    from repro_torch.models import get_model, moe
    from repro_torch.models.convert import gathered, moe_in_blocks, \
        shardings
    from repro_torch.models.sharding import P
    t0 = time.perf_counter()
    cfg = mesh_cfg(sv, mode)
    model = get_model(cfg)
    mesh = mctx.mesh
    card = dev != "cpu"
    b = sv["requests"]
    params = model.init(cfg, torch.Generator(dev).manual_seed(sv["seed"]),
                        dtype=getattr(torch, cfg.compute_dtype),
                        blocks=shardings(model.param_specs(cfg, mctx), mctx))
    res = {"mode": mode}
    h = mesh_layer_input(torch, cfg, sv, dev)
    rows = P(mctx.dp)
    p0 = moe_in_blocks({k: v[0] for k, v in params["layers"]["moe"][
        "moe"].items()}, cfg, mctx, b)
    y0 = gathered(moe.moe_ffn(p0, mctx.sharding(rows).block(h), cfg, mctx,
                              global_batch=b), rows, mctx)
    # the tokens this rank routes: all of them in "2d", its dp shard else
    routed = h if mode == "2d" else mctx.sharding(rows).block(h)
    res["routes"] = mesh_routes(torch, moe, routed.reshape(-1, cfg.d_model),
                                p0["router"], cfg.top_k).cpu().numpy()
    res["routes_dp_row"] = mesh.axis_index(mctx.dp)
    del h, p0
    moe.dropped = torch.zeros((), dtype=torch.int64, device=dev)
    res |= rank_serve(torch, mctx, cfg, params, tokens, sv["prompt_len"],
                      sv["decode"], dev)
    res["dropped"] = int(moe.dropped)
    moe.dropped = None
    if "logits" in res:
        res["layer0"] = y0.float().cpu().numpy()
    del params, y0
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    return res


def mesh_rank(rank: int, sv: dict, tokens, dev: str) -> dict:
    """Phase 13 on one rank of the 8 (on the card, all on cuda:0): (a) the
    pinned cases, then (b) each mode at ``sv``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch_mesh_cases as cases
    from repro_torch.launch.mesh import rank_mesh_ctx
    t_enter = time.time()
    t0 = time.perf_counter()
    pins = cases.rank_cases(rank, dev)
    pins_s = time.perf_counter() - t0
    mctx = rank_mesh_ctx(MESH_SHAPE, device=dev)
    return {"pins": pins, "pins_s": pins_s,
            "modes": [mesh_serve_mode(torch, mctx, sv, mode, tokens, dev)
                      for mode in MESH_MODES],
            "t_enter": t_enter, "t_exit": time.time()}


def mesh_rel(got, want) -> float:
    import numpy as np
    return float(np.abs(got - want).max() / np.abs(want).max())


def mesh_phase(torch, dev: str, name_power: str,
               sv: dict = MESH_SERVE) -> dict:
    """Phase 13.  Returns the attention kernels' launch totals of (b).
    ``dev`` "cpu" with a reduced ``sv`` rehearses it on the CPU."""
    import numpy as np
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_mesh_cases as cases
    t_phase = time.perf_counter()
    card = dev != "cpu"
    label = "gloo through host memory, 8 ranks on one card"
    cfg = mesh_cfg(sv)
    if card:
        reset_counts(torch)
    t0 = time.perf_counter()
    ref = mesh_reference(torch, sv, dev)
    ref_s = time.perf_counter() - t0
    ref_peak = torch.cuda.max_memory_allocated() / 1e9 if card else None
    if card:
        reset_counts(torch)
    t_spawn = time.time()
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, MESH_WORLD, sv, ref["tokens"],
                      "cuda:0" if card else "cpu", timeout_s=900)
    ranks_s = time.perf_counter() - t0
    over = rank_overheads(ranks, t_spawn, time.time())

    # (a) the pins, on the card
    pins = json.loads((ROOT / "tests" / "data" / "torch_mesh.json")
                      .read_text())
    worst = {}
    for key in cases.case_keys():
        want = cases.decode(pins[key])
        for r in ranks:
            got = r["pins"][key]
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"mesh pin {key}: malformed")
            err = float(np.abs(got - want).max())
            if err > MESH_PIN_TOL:
                raise AssertionError(f"mesh pin {key}: {err} on the card")
            worst[key] = max(worst.get(key, 0.0), err)
    emit({"phase": "mesh_pins", "cases": len(worst), "ranks": MESH_WORLD,
          "max_abs_err": max(worst.values()), "limit": MESH_PIN_TOL,
          "worst_case": max(worst, key=worst.get),
          "rank_pins_s": max(r["pins_s"] for r in ranks),
          "collectives": ranks[0]["pins"]["_collectives"],
          "nvidia_smi": name_power})

    # (b) full width, each mode against the 1x1 path or its pair
    by_mode = {m["mode"]: m for m in ranks[0]["modes"]}
    totals = {"flash_attention": 0, "decode_attention": 0}
    for i, mode in enumerate(MESH_MODES):
        per = [r["modes"][i] for r in ranks]
        want = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * sv["decode"]}
        for m in per:
            # on the CPU the wrappers run their plain versions: no launch
            if m["launches"] != (want if card else dict.fromkeys(want, 0)):
                raise AssertionError(f"mesh {mode}: a rank launched "
                                     f"{m['launches']}, want {want}")
            if m["logits_sum"] != per[0]["logits_sum"]:
                raise AssertionError(f"mesh {mode}: the ranks' logits "
                                     f"differ")
        for k in totals:
            totals[k] += sum(m["launches"][k] for m in per)
        logits = by_mode[mode]["logits"]
        if logits.shape != ref["logits"].shape or not np.isfinite(
                logits).all():
            raise AssertionError(f"mesh {mode}: logits malformed")
    checks = {
        "2d_vs_1x1": (by_mode["2d"], ref),
        "expert_vs_ffn": (by_mode["expert"], by_mode["ffn"])}
    flips = {}
    ref_routes = ref["routes"].reshape(sv["requests"], sv["prompt_len"], -1)
    for i, mode in enumerate(MESH_MODES):
        n = 0
        for r in ranks:
            m = r["modes"][i]
            if mode == "2d":
                n = max(n, int((m["routes"] != ref["routes"]).sum()))
            else:
                rows = sv["requests"] // 2
                row = m["routes_dp_row"]
                part = ref_routes[row * rows:(row + 1) * rows].reshape(
                    m["routes"].shape)
                n = max(n, int((m["routes"] != part).sum()))
        flips[mode] = n
    for name, (got, want) in checks.items():
        rel = {"prefill": mesh_rel(got["logits"][0], want["logits"][0]),
               "decode": mesh_rel(got["logits"][1:], want["logits"][1:]),
               "layer0_moe": mesh_rel(got["layer0"], want["layer0"])}
        emit({"phase": "mesh_check", "check": name, "rel_err": rel,
              "limits": {"logits": MESH_REL, "layer0_moe": MESH_LAYER_REL},
              "argmax_equal": float((got["logits"].argmax(-1)
                                     == want["logits"].argmax(-1)).mean()),
              "nvidia_smi": name_power})
        if not (rel["prefill"] < MESH_REL and rel["decode"] < MESH_REL
                and rel["layer0_moe"] < MESH_LAYER_REL):
            raise AssertionError(f"mesh {name}: {rel}")
    for i, mode in enumerate(MESH_MODES):
        per = [r["modes"][i] for r in ranks]
        emit({"phase": "mesh_serve", "arch": cfg.name, "mode": mode,
              "mesh": list(MESH_SHAPE), "reduced": {
                  "num_layers": [sv["layers"], 32]} if not sv["reduced"]
              else "reduced config",
              "requests": sv["requests"], "prompt_len": sv["prompt_len"],
              "decode": sv["decode"], "timing": label,
              "prefill_s": per[0]["prefill_s"],
              "prefill_s_max_rank": max(m["prefill_s"] for m in per),
              "decode_ms_per_step": per[0]["decode_ms_per_step"],
              "decode_ms_per_step_max_rank": max(
                  m["decode_ms_per_step"] for m in per),
              "prefill_collectives": per[0]["prefill_collectives"],
              "decode_collectives_per_step":
                  per[0]["decode_collectives_per_step"],
              "launches_per_rank": per[0]["launches"],
              "dropped": sum(m["dropped"] for m in per) // {
                  "expert": 1, "ffn": MESH_SHAPE[1],
                  "2d": MESH_SHAPE[0]}[mode],
              "assignments": cfg.num_layers * cfg.top_k * sv["requests"]
              * (sv["prompt_len"] + sv["decode"]),
              "layer0_routes_flipped_vs_1x1": flips[mode],
              "peak_gb_per_rank": max(m.get("peak_gb", 0) for m in per),
              "peak_gb_sum_ranks": sum(m.get("peak_gb", 0) for m in per),
              "rank_wall_s": max(m["wall_s"] for m in per),
              "device_used_gb": max(m.get("device_used_gb", 0)
                                    for m in per),
              "nvidia_smi": name_power})
    emit({"phase": "mesh_done", **over,
          "seconds": time.perf_counter() - t_phase,
          "reference_1x1_s": ref_s, "reference_1x1_peak_gb": ref_peak,
          "reference_1x1_dropped": ref["dropped"],
          "reference_1x1_prefill_s": ref["prefill_s"],
          "reference_1x1_decode_ms_per_step": ref["decode_ms_per_step"],
          "ranks_s": ranks_s, "launches": totals, "timing": label,
          "nvidia_smi": name_power})
    return totals


# ------------------------------------------ phase 14: the sharded decoder
# The decoder's prefill and decode steps across ranks, as the reference's
# GSPMD program runs them on its mesh (every weight FSDP over ``data`` and
# TP over ``model``, the caches by ``kv_spec``, the batch over ``data``),
# on 8 gloo ranks on the one card, as phase 13: the collectives go through
# host memory, so their times say nothing of NVLink.  (a) The pins: every
# case of ``tests/torch_sharded_cases.py`` against the reference's answers
# on 8 devices (``tests/data/torch_sharded.json``) within
# ``MESH_PIN_TOL``, each step's collectives equal to a ``CountingMesh``'s
# count of it.  (b) llama3.2-3b at full width, 14 of its 28 layers, bf16,
# on 2x4: 8 prompts of 512 tokens, 4 decode steps fed the greedy tokens of
# the
# port's 1x1 run on the same weights (held to it within ``SHARD_REL``).
# (c) mixtral-8x7b at full width with 2 of its 32 layers (4 before phase
# 17 came), 8 x 512, 1 decode step, in "2d" (the
# one-device function: held to 1x1) and in its own "ffn" (each dp shard
# routes its own rows: its experts gathered from FSDP storage equal
# ``convert.moe_blocks``' blocks bit for bit, the flipped routes counted).
# Phase 3 holds both attention kernels at (b)'s per-rank shapes
# (``rank_shape``) and the reduced cases' heads (its sweeps).
SHARD_MESH = (2, 4)
# 4 and 1 decode steps (a step is 2 s / 4 s of gloo gathers) and (b) at 14
# of the 28 layers: the whole run stays inside its limit
SHARD_SERVE = dict(arch="llama3.2-3b", layers=14, requests=8,
                   prompt_len=512, decode=4, seed=0, reduced=False)
SHARD_MOE = dict(MESH_SERVE, decode=1)
SHARD_MODES = ("2d", "ffn")
SHARD_REL = 0.03                   # logits, PERF.md section 2
# each rank's attention at (b): 8 / 2 rows, 24 / 4 q heads, 8 / 4 KV heads
SHARD_RANK = dict(requests=4, prompt_len=512, decode=4, heads=6,
                  kv_heads=2)


def held_param_bytes(cfg, mctx, dtype) -> int:
    """The dry-run's per-device bytes of the parameter tree on ``mctx``
    (``model.abstract_params``' shard shapes) with each leaf in the dtype
    the serving tree holds it (``transformer.leaf_dtype``: the matrices
    in ``dtype``)."""
    from repro_torch.models.model import abstract_params
    from repro_torch.models.transformer import leaf_dtype

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return sum(walk(v, k) for k, v in tree.items())
        return math.prod(tree.sharding.shard_shape(tree.shape)) * \
            leaf_dtype(key, cfg, dtype).itemsize

    return walk(abstract_params(cfg, mctx))


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def sharded_params(torch, cfg, mctx, seed: int, dev: str, blocks=None):
    """This rank's blocks of the serving tree every rank draws from
    ``seed`` (``param_specs``, or the shardings ``blocks``)."""
    from repro_torch.models import get_model
    from repro_torch.models.convert import shardings
    model = get_model(cfg)
    if blocks is None:
        blocks = shardings(model.param_specs(cfg, mctx), mctx)
    return model.init(cfg, torch.Generator(dev).manual_seed(seed),
                      dtype=getattr(torch, cfg.compute_dtype), blocks=blocks)


def sharded_rank(rank: int, sv_b: dict, tokens_b, sv_c: dict, tokens_c,
                 dev: str) -> dict:
    """Phase 14 on one rank of the 8 (on the card, all on cuda:0): (a) the
    pinned cases, then (b) llama3.2-3b, then (c) mixtral in each of
    ``SHARD_MODES``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch_sharded_cases as cases
    from repro_torch.launch.mesh import rank_mesh_ctx
    from repro_torch.models import get_model, moe
    from repro_torch.models.convert import moe_in_blocks, moe_shardings
    from repro_torch.models.sharding import P
    card = dev != "cpu"
    t_enter = time.time()
    t0 = time.perf_counter()
    out = {"pins": cases.rank_cases(rank, dev)}
    out["pins_s"] = time.perf_counter() - t0
    mctx = rank_mesh_ctx(SHARD_MESH, device=dev)
    bf16 = torch.bfloat16

    def free():
        gc.collect()
        if card:
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = mesh_cfg(sv_b)
    params = sharded_params(torch, cfg, mctx, sv_b["seed"], dev)
    out["b"] = {"param_bytes": tree_bytes(params),
                "param_bytes_dryrun": held_param_bytes(cfg, mctx, bf16),
                **rank_serve(torch, mctx, cfg, params, tokens_b,
                             sv_b["prompt_len"], sv_b["decode"], dev)}
    del params
    free()
    out["b"]["wall_s"] = time.perf_counter() - t0
    out["c"] = {}
    b = sv_c["requests"]
    for mode in SHARD_MODES:
        t0 = time.perf_counter()
        cfg = mesh_cfg(sv_c, mode)
        params = sharded_params(torch, cfg, mctx, sv_c["seed"], dev)
        rec = {"param_bytes": tree_bytes(params),
               "param_bytes_dryrun": held_param_bytes(cfg, mctx, bf16)}
        routes = []
        orig = capture_routes(moe, routes)
        try:
            rec |= rank_serve(torch, mctx, cfg, params, tokens_c,
                              sv_c["prompt_len"], sv_c["decode"], dev)
        finally:
            moe.top_k = orig
        # the prefill's routings, one per MoE layer, of this rank's rows
        rec["prefill_routes"] = routes[:cfg.num_layers]
        rec["dp_row"] = mctx.mesh.axis_index(mctx.dp)
        if mode == "ffn":
            stored = moe_in_blocks({k: v[0] for k, v in params["layers"][
                "moe"]["moe"].items()}, cfg, mctx, b)
            del params
            free()
            own = sharded_params(torch, cfg, mctx, sv_c["seed"], dev,
                                 moe_shardings(get_model(cfg).param_shapes(
                                     cfg), cfg, mctx, b))
            want = {k: v[0] for k, v in own["layers"]["moe"]["moe"].items()}
            rec["experts_equal"] = sorted(want) == sorted(stored) and all(
                torch.equal(stored[k], want[k]) for k in want)
            whole = moe.moe_param_shapes(cfg, 1)
            rec["expert_leaves_cut"] = sum(
                want[k].numel() < math.prod(whole[k]) for k in want)
            del own, stored, want
        else:
            del params
        out["c"][mode] = rec
        free()
        rec["wall_s"] = time.perf_counter() - t0
    out["t_enter"], out["t_exit"] = t_enter, time.time()
    return out


def hold_rank_pins(ranks: list, cases, pin_file: str, label: str) -> dict:
    """Raise unless every rank's answers to the pinned cases (``cases``'
    ``rank_cases``, under each rank's ``"pins"``) lie within
    ``MESH_PIN_TOL`` of ``tests/data/<pin_file>`` and each step's
    collectives equal its counting mesh's; returns each pinned array's
    largest error over the ranks."""
    import numpy as np
    pins = json.loads((ROOT / "tests" / "data" / pin_file).read_text())
    worst = {}
    for r in ranks:
        for name in cases.CASES:
            got = r["pins"][name]
            for key in [k for k in pins if k.startswith(f"{name}/")]:
                want = cases.decode(pins[key])
                have = got[key[len(name) + 1:]]
                if have.shape != want.shape or not np.isfinite(have).all():
                    raise AssertionError(f"{label} pin {key}: malformed")
                err = float(np.abs(have - want).max())
                if err > MESH_PIN_TOL:
                    raise AssertionError(f"{label} pin {key}: {err}")
                worst[key] = max(worst.get(key, 0.0), err)
            for step in cases.steps():
                if got[f"log/{step}"] != got[f"count/{step}"]:
                    raise AssertionError(f"{label} pin {name} {step}: the "
                                         f"rank's collectives differ from "
                                         f"the counting mesh's")
    return worst


def sharded_phase(torch, dev: str, name_power: str,
                  sv_b: dict = SHARD_SERVE, sv_c: dict = SHARD_MOE) -> dict:
    """Phase 14.  Returns the attention kernels' launch totals of (b) and
    (c).  ``dev`` "cpu" with reduced ``sv_b`` / ``sv_c`` rehearses it on
    the CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_sharded_cases as cases
    t_phase = time.perf_counter()
    card = dev != "cpu"
    label = "gloo through host memory, 8 ranks on one card"
    refs = {}
    for key, sv in (("b", sv_b), ("c", sv_c)):
        if card:
            reset_counts(torch)
        t0 = time.perf_counter()
        refs[key] = mesh_reference(torch, sv, dev)
        refs[key]["wall_s"] = time.perf_counter() - t0
        if card:
            refs[key]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if card:
        reset_counts(torch)
    t_spawn = time.time()
    t0 = time.perf_counter()
    ranks = run_ranks(sharded_rank, MESH_WORLD, sv_b, refs["b"]["tokens"],
                      sv_c, refs["c"]["tokens"],
                      "cuda:0" if card else "cpu", timeout_s=900)
    ranks_s = time.perf_counter() - t0
    over = rank_overheads(ranks, t_spawn, time.time())

    # (a) the pins, on every rank
    worst = hold_rank_pins(ranks, cases, "torch_sharded.json", "sharded")
    emit({"phase": "shard_pins", "cases": len(cases.CASES),
          "arrays": len(worst), "ranks": MESH_WORLD,
          "max_abs_err": max(worst.values()), "limit": MESH_PIN_TOL,
          "worst_case": max(worst, key=worst.get),
          "rank_pins_s": max(r["pins_s"] for r in ranks),
          "collectives_equal_counting_mesh": True,
          "nvidia_smi": name_power})

    totals = {"flash_attention": 0, "decode_attention": 0}

    def check_serve(part: str, per: list, cfg, sv: dict) -> None:
        want = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * sv["decode"]}
        for m in per:
            if m["launches"] != (want if card else dict.fromkeys(want, 0)):
                raise AssertionError(f"shard {part}: a rank launched "
                                     f"{m['launches']}, want {want}")
            if m["logits_sum"] != per[0]["logits_sum"]:
                raise AssertionError(f"shard {part}: the ranks' logits "
                                     f"differ")
            if m["param_bytes"] != m["param_bytes_dryrun"]:
                raise AssertionError(f"shard {part}: a rank holds "
                                     f"{m['param_bytes']} bytes of weights, "
                                     f"the dry-run's blocks "
                                     f"{m['param_bytes_dryrun']}")
        for k in totals:
            totals[k] += sum(m["launches"][k] for m in per)
        logits = per[0]["logits"]
        if not np.isfinite(logits).all():
            raise AssertionError(f"shard {part}: logits not finite")

    def line(part: str, per: list, cfg, sv: dict, ref: dict) -> tuple:
        m = per[0]
        rel = {"prefill": mesh_rel(m["logits"][0], ref["logits"][0]),
               "decode": mesh_rel(m["logits"][1:], ref["logits"][1:])}
        return {"arch": cfg.name, "mesh": list(SHARD_MESH),
                "reduced": {"num_layers": [sv["layers"], get_config(
                    sv["arch"]).num_layers]} if not sv["reduced"]
                else "reduced config",
                "requests": sv["requests"], "prompt_len": sv["prompt_len"],
                "decode": sv["decode"], "timing": label,
                "rel_err_vs_1x1": rel,
                "argmax_equal": float((m["logits"].argmax(-1)
                                       == ref["logits"].argmax(-1)).mean()),
                "prefill_s": m["prefill_s"],
                "prefill_s_max_rank": max(x["prefill_s"] for x in per),
                "decode_ms_per_step": m["decode_ms_per_step"],
                "decode_ms_per_step_max_rank": max(
                    x["decode_ms_per_step"] for x in per),
                "prefill_collectives": m["prefill_collectives"],
                "decode_collectives_per_step":
                    m["decode_collectives_per_step"],
                "launches_per_rank": m["launches"],
                "param_bytes_per_rank": m["param_bytes"],
                "param_bytes_dryrun": m["param_bytes_dryrun"],
                "peak_gb_per_rank": max(x.get("peak_gb", 0) for x in per),
                "device_used_gb": max(x.get("device_used_gb", 0)
                                      for x in per),
                "reference_1x1_prefill_s": ref["prefill_s"],
                "reference_1x1_decode_ms_per_step":
                    ref["decode_ms_per_step"],
                "reference_1x1_peak_gb": ref.get("peak_gb"),
                "rank_wall_s": max(x["wall_s"] for x in per),
                "nvidia_smi": name_power}, rel

    # (b) llama3.2-3b, full width and depth
    cfg = mesh_cfg(sv_b)
    per = [r["b"] for r in ranks]
    check_serve("b", per, cfg, sv_b)
    rec, rel = line("b", per, cfg, sv_b, refs["b"])
    emit({"phase": "shard_serve", "part": "b", **rec, "limit": SHARD_REL})
    if not (rel["prefill"] < SHARD_REL and rel["decode"] < SHARD_REL):
        raise AssertionError(f"shard (b) vs 1x1: {rel}")

    # (c) mixtral: "2d" against 1x1, "ffn"'s expert blocks and routes
    ref = refs["c"]
    rows = sv_c["requests"] // SHARD_MESH[0]
    for mode in SHARD_MODES:
        cfg = mesh_cfg(sv_c, mode)
        per = [r["c"][mode] for r in ranks]
        check_serve(f"c {mode}", per, cfg, sv_c)
        rec, rel = line(f"c {mode}", per, cfg, sv_c, ref)
        flips = 0
        for m in per:
            for got, want in zip(m["prefill_routes"], ref["prefill_routes"]):
                if mode == "ffn":
                    n = got.shape[0]
                    want = want[m["dp_row"] * n:(m["dp_row"] + 1) * n]
                flips = max(flips, int((got != want).sum()))
        rec["prefill_routes_flipped_vs_1x1"] = flips
        rec["assignments_a_rank_routes"] = sum(
            g.size for g in per[0]["prefill_routes"])
        if mode == "ffn":
            rec["experts_equal_moe_blocks"] = all(
                m["experts_equal"] for m in per)
            rec["expert_leaves_cut"] = per[0]["expert_leaves_cut"]
            if not rec["experts_equal_moe_blocks"]:
                raise AssertionError("shard (c) ffn: the experts gathered "
                                     "from FSDP storage differ from "
                                     "moe_blocks' blocks")
        emit({"phase": "shard_serve", "part": "c", "mode": mode, **rec,
              "limit": SHARD_REL if mode == "2d" else None})
        if mode == "2d" and not (rel["prefill"] < SHARD_REL
                                 and rel["decode"] < SHARD_REL):
            raise AssertionError(f"shard (c) 2d vs 1x1: {rel}")
    emit({"phase": "shard_done", **over,
          "seconds": time.perf_counter() - t_phase,
          "ranks_s": ranks_s, "launches": totals, "timing": label,
          "reference_1x1_s": {k: v["wall_s"] for k, v in refs.items()},
          "nvidia_smi": name_power})
    return totals


# ------------------------------------------- phase 15: training across ranks
# The decoder's training step across ranks (``make_train_step(...,
# mctx=)``): every rank holds its blocks of the float32 parameters and
# AdamW moments (FSDP over ``data``, TP over ``model``), computes its part
# of the forward pass, the backward pass (each FSDP gather's
# reduce-scatter, the psums of ``pvary``) and the update, on 8 gloo ranks
# on the one card as phases 13 and 14.  (a) The pins: every case of
# ``tests/torch_sharded_train_cases.py`` against the reference's jitted
# 8-device train step (``tests/data/torch_sharded_train.json``) within
# that module's bounds, each step's collectives equal to a
# ``CountingMesh``'s count of it.  (b) llama3.2-3b at full width
# (``TRAIN_RANKS["layers"]`` of its 28 layers), bf16 compute, float32
# parameters and moments, ``remat="full"``,
# on 2x4: ``TRAIN_RANKS["steps"]`` steps of a global batch of 2 x 2,048
# (phase 10 (b)'s), each rank drawing only its blocks, held to a 1x1 run
# of the same batches in the main process (run first, its memory freed
# before the ranks start: at 28 layers its float32 tree, gradients and
# moments took 51.4 GB) on
# the same weights at every step: the 1x1 run writes the weights each of
# its steps starts from, and before every step but the first each rank
# measures its updated blocks against them and then takes them.  So every
# step holds the sharded loss, gradient and update to 1x1 on one set of
# weights; two free-running trajectories in bf16 part after a step or two
# (Adam's first steps move a weight by about lr either way by its
# gradient's sign, and bf16 rounding turns the signs of a gradient's
# smallest elements), so they would test the rounding, not the sharding.
# (c) mixtral-8x7b in "2d" at full width, 1 of its 32 layers (depth cut
# only), 2 steps, against 1x1 the same way.
# (b) cut to 4 of the 28 layers when phase 16 came (the phase took
# 309-318 s at 28 layers, each step ~14-20 s of gloo traffic, a float32
# pass and a 12.85 GB weight write and read), with the layers' RMS norm
# scales at ones (``norms``: llama's own initialisation of them; the
# reference draws them N(0, 0.02) like every leaf of two or more
# dimensions).  Under the reference's draw a shallow llama is another
# model: its residual stream is nearly the tied embedding's row, so the
# final state predicts its own token (at 4 layers the first loss is 56.4,
# not ln V + 0.02^2 d / 2 = 12.4, and a third step's bf16 loss lay 0.0138
# from 1x1's, beyond the gate); at full depth its first loss is 12.8.
# With the scales at ones the layers' outputs dominate the stream at any
# depth (``first_loss_depth.py`` measures both draws by depth).  Every
# part's 1x1 first loss must lie within ``TRAIN_RANKS_INIT_LOSS`` of ln V +
# 0.02^2 d / 2 (``init_loss``, phase 10's gate)
TRAIN_RANKS = dict(arch="llama3.2-3b", layers=4, batch=2, seq=2048,
                   steps=3, seed=0, reduced=False, mode=None, norms="ones")
TRAIN_RANKS_MOE = dict(arch="mixtral-8x7b", layers=1, batch=2, seq=2048,
                       steps=2, seed=0, reduced=False, mode="2d",
                       norms="drawn")
TRAIN_RANKS_INIT_LOSS = 0.5
TRAIN_RANKS_LOSS = 1e-2            # |loss - 1x1 loss| at every step
# Each step's loss and gradient norm are also taken in float32 compute on
# the same weights and batch, on the ranks and on 1x1: |loss - 1x1 loss|
# and |norm - 1x1 norm| / 1x1 norm at every step.  A correct sharded
# gradient agrees with 1x1's there up to the order of float32 sums; in
# bf16 the norm is ill-conditioned once Adam has moved the weights (on an
# H100, llama3.2-3b's bf16 norm at its third step lies 10 % below the
# float32 one on 1x1 and 28 % on 2x4: PERF.md section 6), so the bf16
# norms are reported beside these, not gated
TRAIN_RANKS_F32_LOSS = 1e-4
TRAIN_RANKS_F32_NORM = 1e-4
# |updated block - 1x1's next weights|: AdamW from one set of weights moves
# each weight by lr * (m^ / (sqrt(v^) + eps) + wd * w), and over the first
# three steps |m^| / sqrt(v^) <= 1.001 (Cauchy-Schwarz with b1 0.9, b2
# 0.95), so two runs whose gradients differ part by at most 2 * 1.001 * lr
# (a weight whose gradient's sign differs); every element beyond
# TRAIN_RANKS_PARAM_ATOL is counted
TRAIN_RANKS_PARAM_ATOL = 1e-6
TRAIN_RANKS_UPDATE = 2 * 1.001 * 3e-4 + TRAIN_RANKS_PARAM_ATOL
# each rank's attention at (b): 1 of 2 rows, 24 / 4 q heads, 8 / 4 KV heads
TRAIN_RANK_SHAPE = dict(batch=1, seq=2048, heads=6, kv_heads=2)
TRAIN_MESH = (2, 4)


NORM_SCALES = ("ln1", "ln2", "ln", "ssm_ln")


def set_norm_scales(params: dict, value: float) -> dict:
    """Every stacked layer norm scale (a leaf named ``ln1``/``ln2``, or an
    SSM layer's ``ln``/``ssm_ln``, of two or more dimensions: a whole
    tree's or a rank's block) filled with ``value``, in place."""
    for k, v in params.items():
        if isinstance(v, dict):
            set_norm_scales(v, value)
        elif k in NORM_SCALES and v.dim() >= 2:
            v.fill_(value)
    return params


def train_ranks_init(torch, cfg, sv: dict, dev: str, **kw) -> dict:
    """(b)'s or (c)'s float32 tree (``kw``: ``blocks=`` for a rank's),
    drawn from ``sv["seed"]``, the norm scales at ones where
    ``sv["norms"]`` is "ones"."""
    from repro_torch.models import get_model
    params = get_model(cfg).init(
        cfg, torch.Generator(dev).manual_seed(sv["seed"]), **kw)
    return set_norm_scales(params, 1.0) if sv["norms"] == "ones" \
        else params


def train_ranks_batch(torch, cfg, sv: dict, i: int, dev: str) -> dict:
    """Step ``i``'s global batch: ``launch.train.synth_batch`` from a CPU
    generator seeded ``seed + 1000 + i`` (the same in every process)."""
    from repro_torch.launch.train import synth_batch
    return synth_batch(cfg, sv["batch"], sv["seq"], torch.Generator()
                       .manual_seed(sv["seed"] + 1000 + i), dev)


def train_ranks_weights(weights_dir: str, i: int) -> pathlib.Path:
    """Where (b)'s or (c)'s 1x1 run writes the weights of its step ``i``."""
    return pathlib.Path(weights_dir) / f"step{i}.pt"


def train_ranks_references(parts: dict, dev: str, weights: dict) -> dict:
    """The 1x1 runs of phase 15's, 17's or 18's models (``parts`` by key),
    one after another in this process (``train_ranks_reference``), each
    writing its weights under ``weights[key]``: ``{key: its record and its
    wall s}``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key, sv in parts.items():
        t0 = time.perf_counter()
        out[key] = train_ranks_reference(torch, sv, dev, weights[key])
        out[key]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        if dev != "cpu":
            torch.cuda.empty_cache()
    return out


def train_ranks_reference(torch, sv: dict, dev: str, weights_dir: str
                          ) -> dict:
    """(b)'s or (c)'s 1x1 run: the float32 tree every rank draws its
    blocks of, ``sv["steps"]`` steps of ``make_train_step`` on one device,
    the weights each step after the first starts from written to
    ``weights_dir`` (by their tree paths, on the host); losses, norms,
    step s, peak; each step's loss and norm in float32 compute on the
    same weights and batch (``f32_loss_norm``)."""
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import leaves
    cfg = mesh_cfg(sv, sv["mode"])
    params = train_ranks_init(torch, cfg, sv, dev)
    ocfg = AdamWConfig(opt_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    res = {"loss": [], "grad_norm": [], "step_s": [], "write_s": 0.0,
           "loss_f32": [], "grad_norm_f32": []}
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    for i in range(sv["steps"]):
        if i:
            t0 = time.perf_counter()
            torch.save({p: w.cpu() for p, w in leaves(params)},
                       train_ranks_weights(weights_dir, i))
            res["write_s"] += time.perf_counter() - t0
        data = train_ranks_batch(torch, cfg, sv, i, dev)
        for k, v in zip(("loss_f32", "grad_norm_f32"),
                        f32_loss_norm(torch, cfg, params, data)):
            res[k].append(v)
        mesh_sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, data)
        res["loss"].append(float(m["loss"]))
        res["grad_norm"].append(float(m["grad_norm"]))
        mesh_sync(torch, dev)
        res["step_s"].append(time.perf_counter() - t0)
    if dev != "cpu":
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def forward_collectives(torch, cfg, mctx, feed_shapes: dict, b: int
                        ) -> dict:
    """The collectives of the loss's forward pass alone (under a gradient,
    no backward), counted on a ``CountingMesh`` at this rank's coordinates
    on meta blocks: the forward's share of a step's log."""
    from repro_torch.models import get_model
    from repro_torch.models.model import abstract_params
    from repro_torch.models.sharding import CountingMesh, MeshCtx
    from repro_torch.train.tree import tree_map
    mesh = mctx.mesh
    counting = CountingMesh(tuple(mesh.devices.shape), mesh.axis_names,
                            mesh.coords)
    cm = MeshCtx(counting)
    params = tree_map(lambda s: torch.empty(
        s.sharding.shard_shape(s.shape), dtype=s.dtype, device="meta",
        requires_grad=True), abstract_params(cfg, cm))
    feed = {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in feed_shapes.items()}
    get_model(cfg).loss(params, feed, cfg, cm, global_batch=b)
    return collective_summary(counting)


def f32_loss_norm(torch, cfg, params, batch, mctx=None, specs=None,
                  global_batch=None) -> tuple[float, float]:
    """The loss and gradient norm of ``batch`` at ``params`` with the
    compute in float32 (on ``mctx``'s ranks where given: this rank's
    blocks under ``specs``), no update."""
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    fn = make_loss_fn(cfg.replace(compute_dtype="float32"), mctx)
    loss, grads = value_and_grad(fn, params, batch, mctx=mctx, specs=specs,
                                 global_batch=global_batch)
    return float(loss), float(global_norm(grads, mctx, specs))


def take_reference_weights(torch, params, specs, mctx, path) -> dict:
    """Measure this rank's blocks ``params`` (under the spec tree
    ``specs``) against the 1x1 run's weights at ``path``, then copy those
    weights' blocks into them: the largest distance, the elements beyond
    ``TRAIN_RANKS_PARAM_ATOL``, the elements, the seconds."""
    from repro_torch.train.optimizer import SLICE, spec_leaves
    from repro_torch.train.tree import leaves
    t0 = time.perf_counter()
    ref = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    out = {"max_abs": 0.0, "beyond": 0, "elements": 0}
    with torch.no_grad():
        for (p, w), spec in zip(leaves(params), spec_leaves(specs)):
            src = mctx.sharding(spec).block(ref[p]).reshape(-1)
            dst = w.view(-1)
            # in slices: eight ranks share the card with ~1 GB to spare
            for j in range(0, dst.numel(), SLICE):
                part = src[j:j + SLICE].to(w.device)
                gap = (dst[j:j + SLICE] - part).abs()
                out["max_abs"] = max(out["max_abs"], float(gap.max()))
                out["beyond"] += int((gap > TRAIN_RANKS_PARAM_ATOL).sum())
                dst[j:j + SLICE].copy_(part)
            out["elements"] += w.numel()
    out["seconds"] = time.perf_counter() - t0
    return out


def train_ranks_run(torch, mctx, sv: dict, dev: str, weights_dir: str
                    ) -> dict:
    """(b) or (c) on this rank: its blocks drawn from the seed, then
    ``sv["steps"]`` train steps on its rows of each global batch, every
    step after the first from the 1x1 run's weights in ``weights_dir``
    (``take_reference_weights``: the update's distance to them first); per
    step the loss, the norm, the wall s, the collectives by kind and the
    flash launches; the forward's collectives alone; the peak.  Then, the
    moments freed, each step's loss and norm in float32 compute from the
    same weights (``f32_loss_norm``) and its flash launches."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models import get_model
    from repro_torch.models.convert import blocks, shardings
    from repro_torch.models.sharding import P
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    card = dev != "cpu"
    cfg = mesh_cfg(sv, sv["mode"])
    model = get_model(cfg)
    b = sv["batch"]
    specs = model.param_specs(cfg, mctx)

    def draw():
        return train_ranks_init(torch, cfg, sv, dev,
                                blocks=shardings(specs, mctx))

    def rows(i):
        return {k: blocks(v, P(dp, *(None,) * (v.dim() - 1)), mctx)
                for k, v in train_ranks_batch(torch, cfg, sv, i, dev).items()}

    t0 = time.perf_counter()
    params = draw()
    draw_s = time.perf_counter() - t0
    ocfg = AdamWConfig(opt_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg, 1, mctx)
    dp = mctx.dp if b % mctx.dp_size == 0 else None
    mesh = mctx.mesh
    res = {"loss": [], "grad_norm": [], "step_s": [], "collectives": [],
           "launches": [], "update": [], "param_bytes": tree_bytes(params),
           "loss_f32": [], "grad_norm_f32": [], "launches_f32": [],
           "draw_s": [draw_s], "f32_s": []}
    if card:
        # the full-size matrices the draw cached go back to the card
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        free, total = torch.cuda.mem_get_info()
        if mesh.device_mesh.get_rank() == 0:
            emit({"phase": "train_rank_state", "arch": cfg.name,
                  "rank": 0,
                  "state_gb": torch.cuda.memory_allocated() / 1e9,
                  "device_used_gb": (total - free) / 1e9})
    for i in range(sv["steps"]):
        if i:
            res["update"].append(take_reference_weights(
                torch, params, specs, mctx,
                train_ranks_weights(weights_dir, i)))
        feed = rows(i)
        mesh.reset_collectives()
        before = (flash_ops.launches, flash_ops.bwd_launches)
        mesh_sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, feed, global_batch=b)
        res["loss"].append(float(m["loss"]))
        res["grad_norm"].append(float(m["grad_norm"]))
        mesh_sync(torch, dev)
        res["step_s"].append(time.perf_counter() - t0)
        res["launches"].append({
            "flash_attention": flash_ops.launches - before[0],
            "flash_attention_bwd": flash_ops.bwd_launches - before[1]})
        res["collectives"].append(collective_summary(mesh))
    if card:
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        free, total = torch.cuda.mem_get_info()
        res["device_used_gb"] = (total - free) / 1e9
    res["forward_collectives"] = forward_collectives(
        torch, cfg, mctx, {k: (tuple(v.shape), v.dtype)
                           for k, v in feed.items()}, b)
    del params, opt, step
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = draw()
    res["draw_s"].append(time.perf_counter() - t0)
    for i in range(sv["steps"]):
        if i:
            take_reference_weights(torch, params, specs, mctx,
                                   train_ranks_weights(weights_dir, i))
        before = (flash_ops.launches, flash_ops.bwd_launches)
        t0 = time.perf_counter()
        for k, v in zip(("loss_f32", "grad_norm_f32"), f32_loss_norm(
                torch, cfg, params, rows(i), mctx, specs, b)):
            res[k].append(v)
        res["f32_s"].append(time.perf_counter() - t0)
        res["launches_f32"].append({
            "flash_attention": flash_ops.launches - before[0],
            "flash_attention_bwd": flash_ops.bwd_launches - before[1]})
    del params
    return res


def train_attn_launches(cfg) -> dict:
    """The flash launches a rank makes in a train step (or a float32
    pass) of ``cfg``: each attention under ``remat`` runs forward twice
    (the recompute) and backward once; a hybrid's tail layers run outside
    ``remat`` (forward once); an SSM none."""
    twice = 2 if cfg.remat != "none" else 1
    if cfg.family == "hybrid":
        groups, tail = divmod(cfg.num_layers, len(cfg.block_pattern))
        g = groups * cfg.block_pattern.count("attn")
        t = cfg.block_pattern[:tail].count("attn")
        return {"flash_attention": twice * g + t, "flash_attention_bwd": g + t}
    n = attn_launches(cfg)[0]
    return {"flash_attention": twice * n, "flash_attention_bwd": n}


def train_ranks_rank(rank: int, cases_name: str, parts: dict, dev: str,
                     weights: dict, pin_names=None) -> dict:
    """Phase 15 or 17 on one rank of the 8 (on the card, all on cuda:0):
    (a) the pinned cases of the cases module ``cases_name`` (those of
    ``pin_names``, all by default), then each model of ``parts`` in turn,
    each from its 1x1 run's weights in the directory ``weights[key]``."""
    import importlib

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import rank_mesh_ctx
    cases = importlib.import_module(cases_name)
    t_enter = time.time()
    t0 = time.perf_counter()
    out = {"pins": cases.rank_cases(rank, dev, pin_names)}
    out["pins_s"] = time.perf_counter() - t0
    mctx = rank_mesh_ctx(TRAIN_MESH, device=dev)
    for key, sv in parts.items():
        out[key] = train_ranks_run(torch, mctx, sv, dev, weights[key])
        gc.collect()
        if dev != "cpu":
            torch.cuda.empty_cache()
    out["t_enter"], out["t_exit"] = t_enter, time.time()
    return out


def train_ranks_phase(torch, dev: str, name_power: str,
                      sv_b: dict = TRAIN_RANKS,
                      sv_c: dict = TRAIN_RANKS_MOE, pin_names=None) -> dict:
    """Phase 15.  Returns the flash kernels' launch totals of (b) and (c).
    ``dev`` "cpu" with reduced ``sv_b`` / ``sv_c`` (and a few
    ``pin_names``) rehearses it on the CPU."""
    return train_across_ranks(torch, dev, name_power, "shard_train",
                              "torch_sharded_train_cases",
                              {"b": sv_b, "c": sv_c}, pin_names)


def train_across_ranks(torch, dev: str, name_power: str, phase: str,
                       cases_name: str, parts: dict, pin_names=None) -> dict:
    """Phases 15, 17 and 18: the models of ``parts`` (by key) trained 1x1
    in this process, writing the weights each step starts from; then
    the 8 ranks (``train_ranks_rank``): the pins of the cases module
    ``cases_name`` and each model against its 1x1 run.  Lines
    ``<phase>_pins``, ``<phase>`` (one a model) and ``<phase>_done``.
    Returns the flash kernels' launch totals of the models."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import count_collectives
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import get_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.sharding import Mesh, MeshCtx
    sys.path.insert(0, str(ROOT / "tests"))
    import importlib
    cases = importlib.import_module(cases_name)
    t_phase = time.perf_counter()
    card = dev != "cpu"
    label = "gloo through host memory, 8 ranks on one card"
    main_gb = None
    if card:
        reset_counts(torch)
    # the 1x1 runs' weights (llama3.2-3b's 12.85 GB a step at 28 layers) on
    # the disk of the checkout, removed with the directory
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="train_ranks_",
                                      dir=ROOT / "build")
    weights = {}
    try:
        for key in parts:
            weights[key] = os.path.join(tmp.name, key)
            os.mkdir(weights[key])
        t0 = time.perf_counter()
        refs = train_ranks_references(parts, dev, weights)
        refs_s = time.perf_counter() - t0
        if card:
            main_gb = torch.cuda.memory_reserved() / 1e9
        t_spawn = time.time()
        t0 = time.perf_counter()
        ranks = run_ranks(train_ranks_rank, MESH_WORLD, cases_name, parts,
                          "cuda:0" if card else "cpu", weights, pin_names,
                          timeout_s=1100)
        ranks_s = time.perf_counter() - t0
        over = rank_overheads(ranks, t_spawn, time.time())
    finally:
        tmp.cleanup()

    # (a) the pins, on every rank
    pins = json.loads((ROOT / "tests" / "data" / cases.PIN_FILE).read_text())
    worst = {}
    for name in pin_names or cases.CASES:
        cfg = cases.port_config(name)
        recs = [r["pins"][name] for r in ranks]
        got = cases.check_case(name, recs, pins, cases.paths(
            get_model(cfg).param_shapes(cfg)))
        for r in recs:
            if r["log/0"] != r["count"] or any(
                    r[f"log/{i}"] != r["log/0"] for i in range(cases.STEPS)):
                raise AssertionError(f"{phase} pin {name}: the rank's "
                                     f"collectives differ from the counting "
                                     f"mesh's")
        worst[name] = got
    emit({"phase": f"{phase}_pins", "cases": len(worst),
          "ranks": MESH_WORLD, "steps": cases.STEPS,
          "loss_rel": max(w["loss_rel"] for w in worst.values()),
          "grad_abs": max(w["grad_abs"] for w in worst.values()),
          "param_abs": max(w["param_abs"] for w in worst.values()),
          "adam_sign_samples": {k: [w["adam_sign"], w["samples"]]
                                for k, w in worst.items() if w["adam_sign"]},
          "limits": {"loss_rel": cases.LOSS_RTOL,
                     "grad": [cases.GRAD_ATOL, cases.GRAD_RTOL],
                     "param": cases.PARAM_ATOL,
                     "adam_sign": cases.ADAM_SIGN_TOL},
          "rank_pins_s": max(r["pins_s"] for r in ranks),
          "collectives_equal_counting_mesh": True,
          "nvidia_smi": name_power})

    totals = {"flash_attention": 0, "flash_attention_bwd": 0}
    failed = []
    grid = MeshCtx(Mesh(np.arange(MESH_WORLD).reshape(TRAIN_MESH),
                        ("data", "model")))
    for part, sv in parts.items():
        cfg = mesh_cfg(sv, sv["mode"])
        full = get_config(sv["arch"])
        per = [r[part] for r in ranks]
        ref = refs[part]
        want = train_attn_launches(cfg)
        counted = count_collectives(cfg, ShapeConfig(
            "train", "train", sv["seq"], sv["batch"]), grid)
        counted = {k: counted[k] for k in ("calls", "bytes")}
        for m in per:
            for got in m["launches"] + m["launches_f32"]:
                if got != (want if card else dict.fromkeys(want, 0)):
                    raise AssertionError(f"{phase} {part}: a rank "
                                         f"launched {got} a step, want "
                                         f"{want}")
                for k in totals:
                    totals[k] += got[k]
            if any(m[k] != per[0][k] for k in ("loss", "grad_norm",
                                                "loss_f32", "grad_norm_f32")):
                raise AssertionError(f"{phase} {part}: the ranks' "
                                     f"losses differ")
            if any(c != counted for c in m["collectives"]):
                raise AssertionError(f"{phase} {part}: a rank's collectives "
                                     f"{m['collectives']}, the dry-run's "
                                     f"{counted}")
        m = per[0]

        def gaps(key):
            return ([abs(a - w) for a, w in zip(m[f"loss{key}"],
                                                 ref[f"loss{key}"])],
                    [abs(a - w) / w for a, w in zip(m[f"grad_norm{key}"],
                                                     ref[f"grad_norm{key}"])])

        loss_err, norm_rel = gaps("")
        loss_err32, norm_rel32 = gaps("_f32")
        # each step's update over the ranks' blocks (a block held by
        # several ranks counted on each)
        update = [{"max_abs": max(x["update"][i]["max_abs"] for x in per),
                   "beyond": sum(x["update"][i]["beyond"] for x in per),
                   "elements": sum(x["update"][i]["elements"] for x in per),
                   "read_s": max(x["update"][i]["seconds"] for x in per)}
                  for i in range(sv["steps"] - 1)]
        fwd = m["forward_collectives"]
        step0 = m["collectives"][0]
        cut = {k: [getattr(cfg, k), getattr(full, k)]
               for k in ("num_layers", "enc_layers")
               if getattr(cfg, k) != getattr(full, k)}
        emit({"phase": phase, "part": part, "arch": cfg.name,
              "family": cfg.family, "mode": sv["mode"],
              "mesh": list(TRAIN_MESH),
              "reduced": "reduced config" if sv["reduced"] else cut,
              "global_batch": [sv["batch"], sv["seq"]],
              "steps": sv["steps"], "remat": cfg.remat,
              "compute": cfg.compute_dtype, "params": cfg.param_dtype,
              "timing": label,
              "weights": "1x1's at every step",
              "loss": m["loss"], "loss_1x1": ref["loss"],
              "grad_norm": m["grad_norm"], "grad_norm_1x1": ref["grad_norm"],
              "loss_abs_err_vs_1x1": loss_err,
              "grad_norm_rel_err_vs_1x1": norm_rel,
              "update_vs_1x1": update,
              "loss_f32": m["loss_f32"], "loss_f32_1x1": ref["loss_f32"],
              "grad_norm_f32": m["grad_norm_f32"],
              "grad_norm_f32_1x1": ref["grad_norm_f32"],
              "loss_f32_abs_err_vs_1x1": loss_err32,
              "grad_norm_f32_rel_err_vs_1x1": norm_rel32,
              "norm_scales": sv["norms"], "init_loss": init_loss(cfg),
              "limits": {"init_loss_abs": TRAIN_RANKS_INIT_LOSS,
                         "loss_abs": TRAIN_RANKS_LOSS,
                         "update_abs": TRAIN_RANKS_UPDATE,
                         "counted_above": TRAIN_RANKS_PARAM_ATOL,
                         "loss_f32_abs": TRAIN_RANKS_F32_LOSS,
                         "grad_norm_f32_rel": TRAIN_RANKS_F32_NORM},
              "step_s": m["step_s"],
              "step_s_max_rank": [max(x["step_s"][i] for x in per)
                                  for i in range(sv["steps"])],
              "step_s_1x1": ref["step_s"],
              "draw_s_max_rank": [max(x["draw_s"][i] for x in per)
                                  for i in range(2)],
              "f32_pass_s_max_rank": [max(x["f32_s"][i] for x in per)
                                      for i in range(sv["steps"])],
              "collectives_equal_dryrun": True,
              "collectives_per_step": {
                  "forward_gathers": [fwd["calls"].get("all-gather", 0),
                                      fwd["bytes"].get("all-gather", 0)],
                  "recompute_gathers": [
                      step0["calls"]["all-gather"]
                      - fwd["calls"].get("all-gather", 0),
                      step0["bytes"]["all-gather"]
                      - fwd["bytes"].get("all-gather", 0)],
                  "reduce_scatters": [step0["calls"]["reduce-scatter"],
                                      step0["bytes"]["reduce-scatter"]],
                  "psums": [step0["calls"]["all-reduce"],
                            step0["bytes"]["all-reduce"]],
                  "forward_psums": [fwd["calls"].get("all-reduce", 0),
                                    fwd["bytes"].get("all-reduce", 0)]},
              "launches_per_rank_step": m["launches"][0],
              "param_bytes_per_rank": m["param_bytes"],
              "peak_gb_per_rank": [x.get("peak_gb") for x in per],
              "device_used_gb": max(x.get("device_used_gb", 0) for x in per),
              "peak_gb_1x1": ref.get("peak_gb"),
              "wall_s_1x1": ref["wall_s"], "write_s_1x1": ref["write_s"],
              "nvidia_smi": name_power})
        if not all(math.isfinite(x) for x in m["loss"] + m["grad_norm"]
                   + m["loss_f32"] + m["grad_norm_f32"]) \
                or abs(ref["loss"][0] - init_loss(cfg)) \
                > TRAIN_RANKS_INIT_LOSS \
                or max(loss_err) > TRAIN_RANKS_LOSS \
                or any(u["max_abs"] > TRAIN_RANKS_UPDATE for u in update) \
                or max(loss_err32) > TRAIN_RANKS_F32_LOSS \
                or max(norm_rel32) > TRAIN_RANKS_F32_NORM:
            failed.append(f"{phase} {part} vs 1x1: first 1x1 loss "
                          f"{ref['loss'][0]} (want {init_loss(cfg)} within "
                          f"{TRAIN_RANKS_INIT_LOSS}), losses {loss_err}, "
                          f"updates {update}, float32 losses {loss_err32} "
                          f"and norms {norm_rel32}")
    if failed:
        raise AssertionError("; ".join(failed))
    emit({"phase": f"{phase}_done", **over,
          "seconds": time.perf_counter() - t_phase, "ranks_s": ranks_s,
          "reference_1x1_all_s": refs_s,
          "reference_1x1_s": {k: r["wall_s"] for k, r in refs.items()},
          "main_process_reserved_gb": main_gb,
          "launches": totals, "timing": label, "nvidia_smi": name_power})
    return totals


# ------------------------------ phase 16: serving across ranks, other families
# The enc-dec, SSM and hybrid families' prefill and decode steps across
# ranks, as the reference's GSPMD program runs them on its mesh (every
# weight FSDP over ``data`` and TP over ``model``, the caches by the
# families' cache specs, the batch over ``data``), on 8 gloo ranks on the
# one card as phases 13-15: the collectives go through host memory, so
# their times say nothing of NVLink.  (a) The pins: every case of
# ``tests/torch_sharded_families_cases.py`` against the reference's
# answers on 8 devices (``tests/data/torch_sharded_families.json``) within
# ``MESH_PIN_TOL``, each step's collectives equal to a ``CountingMesh``'s
# count of it.  (b) whisper-medium (phase 8's shape: 8 x 384 over 1,500
# frames; 6 of its 24 encoder and 6 of its 24 decoder layers, 2 decode
# steps), mamba2-130m (full depth, 8 x 2,048, 2 steps) and
# recurrentgemma-2b (12 of 26 layers, 8 x 512, 2 steps: a step at full
# depth is about 1.1 GB of FSDP gathers a rank) at full width, bf16, on
# 2x4 (whisper at full
# depth and 4 steps, mamba2 at 4 steps, before phase 17 came: a whisper
# step costs 337 collective calls through gloo, 5-7 ms each), each rank
# drawing only its blocks, fed the greedy
# tokens of the port's 1x1 run on the same weights and held to it within
# ``SHARD_REL`` at the prefill and every decode step; each rank's
# collectives equal to ``dryrun.count_collectives``' count of the cell
# (the rank at coordinates 0 on meta tensors).  Phase 3 holds both
# attention kernels at (b)'s per-rank shapes (``FAMILY_RANK``).
FAMILY_MESH = (2, 4)
# whisper at 6 + 6 layers and recurrentgemma at 12 of 26 (4 full groups):
# the whole run stays inside its limit
FAMILY_SERVE = (
    dict(arch=WHISPER, layers=6, enc_layers=6, requests=8, prompt_len=384,
         decode=2, seed=0, reduced=False),
    dict(arch=SSM, layers=24, requests=8, prompt_len=2048, decode=2, seed=0,
         reduced=False),
    dict(arch=HYBRID, layers=12, requests=8, prompt_len=512, decode=2,
         seed=0, reduced=False))
# each rank's attention at (b): 4 of 8 rows; whisper's 4 of 16 heads (its
# KV heads too), recurrentgemma's span of 3 of 10 q heads on its KV head
FAMILY_RANK = {WHISPER: dict(requests=4, prompt_len=384, decode=2, heads=4,
                             kv_heads=4),
               HYBRID: dict(requests=4, prompt_len=512, decode=2, heads=3,
                            kv_heads=1)}


def family_rank(rank: int, svs: tuple, tokens: list, dev: str) -> dict:
    """Phase 16 on one rank of the 8 (on the card, all on cuda:0): (a) the
    pinned cases, then (b) each model of ``svs`` in turn, freed before
    the next."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch_sharded_families_cases as cases
    from repro_torch.launch.mesh import rank_mesh_ctx
    card = dev != "cpu"
    t_enter = time.time()
    t0 = time.perf_counter()
    out = {"pins": cases.rank_cases(rank, dev)}
    out["pins_s"] = time.perf_counter() - t0
    mctx = rank_mesh_ctx(FAMILY_MESH, device=dev)
    out["serve"] = []
    for sv, toks in zip(svs, tokens):
        t0 = time.perf_counter()
        cfg = mesh_cfg(sv)
        params = sharded_params(torch, cfg, mctx, sv["seed"], dev)
        rec = {"param_bytes": tree_bytes(params),
               "param_bytes_dryrun": held_param_bytes(cfg, mctx,
                                                      torch.bfloat16)}
        rec |= rank_serve(torch, mctx, cfg, params, toks, sv["prompt_len"],
                          sv["decode"], dev, seed=sv["seed"])
        del params
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        rec["wall_s"] = time.perf_counter() - t0
        out["serve"].append(rec)
    out["t_enter"], out["t_exit"] = t_enter, time.time()
    return out


def family_phase(torch, dev: str, name_power: str,
                 svs: tuple = FAMILY_SERVE) -> dict:
    """Phase 16.  Returns the attention kernels' launch totals of (b).
    ``dev`` "cpu" with reduced ``svs`` rehearses it on the CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import count_collectives
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.sharding import Mesh, MeshCtx
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_sharded_families_cases as cases
    t_phase = time.perf_counter()
    card = dev != "cpu"
    label = "gloo through host memory, 8 ranks on one card"
    refs = []
    for sv in svs:
        if card:
            reset_counts(torch)
        t0 = time.perf_counter()
        ref = mesh_reference(torch, sv, dev)
        ref["wall_s"] = time.perf_counter() - t0
        if card:
            ref["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        refs.append(ref)
    if card:
        reset_counts(torch)
    t_spawn = time.time()
    t0 = time.perf_counter()
    ranks = run_ranks(family_rank, MESH_WORLD, svs,
                      [r["tokens"] for r in refs],
                      "cuda:0" if card else "cpu", timeout_s=900)
    ranks_s = time.perf_counter() - t0
    over = rank_overheads(ranks, t_spawn, time.time())

    # (a) the pins, on every rank
    worst = hold_rank_pins(ranks, cases, "torch_sharded_families.json",
                           "families")
    emit({"phase": "family_pins", "cases": len(cases.CASES),
          "arrays": len(worst), "ranks": MESH_WORLD,
          "max_abs_err": max(worst.values()), "limit": MESH_PIN_TOL,
          "worst_case": max(worst, key=worst.get),
          "rank_pins_s": max(r["pins_s"] for r in ranks),
          "collectives_equal_counting_mesh": True,
          "nvidia_smi": name_power})

    # (b) each model against its 1x1 run
    totals = {"flash_attention": 0, "decode_attention": 0}
    mesh = MeshCtx(Mesh(np.arange(MESH_WORLD).reshape(FAMILY_MESH),
                        ("data", "model")))
    for i, (sv, ref) in enumerate(zip(svs, refs)):
        cfg = mesh_cfg(sv)
        per = [r["serve"][i] for r in ranks]
        per_prefill, per_step = attn_launches(cfg)
        want = {"flash_attention": per_prefill,
                "decode_attention": per_step * sv["decode"]}
        b, p_len, steps = sv["requests"], sv["prompt_len"], sv["decode"]
        counted = {
            "prefill": count_collectives(cfg, ShapeConfig(
                "prefill", "prefill", p_len, b), mesh),
            "decode": count_collectives(cfg, ShapeConfig(
                "decode", "decode", p_len + steps, b), mesh)}
        for m in per:
            if m["launches"] != (want if card else dict.fromkeys(want, 0)):
                raise AssertionError(f"family {cfg.name}: a rank launched "
                                     f"{m['launches']}, want {want}")
            if m["logits_sum"] != per[0]["logits_sum"]:
                raise AssertionError(f"family {cfg.name}: the ranks' "
                                     f"logits differ")
            if m["param_bytes"] != m["param_bytes_dryrun"]:
                raise AssertionError(f"family {cfg.name}: a rank holds "
                                     f"{m['param_bytes']} bytes of weights, "
                                     f"the dry-run's blocks "
                                     f"{m['param_bytes_dryrun']}")
            for part, key in (("prefill", "prefill_collectives"),
                              ("decode", "decode_collectives_per_step")):
                if m[key] != {k: counted[part][k] for k in ("calls",
                                                            "bytes")}:
                    raise AssertionError(f"family {cfg.name} {part}: a "
                                         f"rank's collectives {m[key]}, the "
                                         f"dry-run's {counted[part]}")
        for k in totals:
            totals[k] += sum(m["launches"][k] for m in per)
        m = per[0]
        logits = m["logits"]
        if not np.isfinite(logits).all():
            raise AssertionError(f"family {cfg.name}: logits not finite")
        rel = [mesh_rel(logits[j], ref["logits"][j])
               for j in range(steps + 1)]
        emit({"phase": "family_serve", "arch": cfg.name,
              "family": cfg.family, "mesh": list(FAMILY_MESH),
              "reduced": "reduced config" if sv["reduced"] else False,
              "layers": [sv["layers"], get_config(sv["arch"]).num_layers],
              "requests": b, "prompt_len": p_len, "decode": steps,
              "timing": label, "rel_err_vs_1x1": {
                  "prefill": rel[0], "decode_steps": rel[1:]},
              "limit": SHARD_REL,
              "argmax_equal": float((logits.argmax(-1)
                                     == ref["logits"].argmax(-1)).mean()),
              "prefill_s": m["prefill_s"],
              "prefill_s_max_rank": max(x["prefill_s"] for x in per),
              "decode_ms_per_step": m["decode_ms_per_step"],
              "decode_ms_per_step_max_rank": max(
                  x["decode_ms_per_step"] for x in per),
              "prefill_collectives": m["prefill_collectives"],
              "decode_collectives_per_step":
                  m["decode_collectives_per_step"],
              "collectives_equal_dryrun": True,
              "launches_per_rank": m["launches"],
              "param_bytes_per_rank": m["param_bytes"],
              "peak_gb_per_rank": max(x.get("peak_gb", 0) for x in per),
              "device_used_gb": max(x.get("device_used_gb", 0)
                                    for x in per),
              "reference_1x1_prefill_s": ref["prefill_s"],
              "reference_1x1_decode_ms_per_step":
                  ref["decode_ms_per_step"],
              "reference_1x1_peak_gb": ref.get("peak_gb"),
              "rank_wall_s": max(x["wall_s"] for x in per),
              "nvidia_smi": name_power})
        if max(rel) >= SHARD_REL:
            raise AssertionError(f"family {cfg.name} vs 1x1: {rel}")
    emit({"phase": "family_done", **over,
          "seconds": time.perf_counter() - t_phase,
          "ranks_s": ranks_s, "launches": totals, "timing": label,
          "reference_1x1_s": {r_sv["arch"]: r["wall_s"]
                              for r_sv, r in zip(svs, refs)},
          "nvidia_smi": name_power})
    return totals


# ------------------------------ phase 17: training across ranks, other families
# The enc-dec, SSM and hybrid families' train step across ranks
# (``make_train_step(..., mctx=)``: the loss, the backward pass through the
# collectives' transposes, the AdamW update, each rank on its blocks), on 8
# gloo ranks on the one card as phases 13-16.  (a) The pins: every case of
# ``tests/torch_sharded_families_train_cases.py`` against the reference's
# jitted 8-device train step
# (``tests/data/torch_sharded_families_train.json``) within that module's
# bounds on every rank, each step's collectives equal to a
# ``CountingMesh``'s count.  (b) Each model at full width, float32
# parameters and moments, bf16 compute, ``remat="full"``, 2 steps on 2x4,
# each rank drawing only its blocks, every step from the weights of a 1x1
# run of the same batches in the main process, as phase 15 (b)
# (``train_across_ranks``): whisper-medium, 4 of its 24 encoder and 4 of
# its 24 decoder layers, a global batch of 2 x 448 tokens (its published
# decoder length) over 1,500 frames; mamba2-130m, 6 of its 24 layers, 2 x
# 2,048;
# recurrentgemma-2b, 2 x 2,048, 4 of its 26 layers (one full ``rec, rec,
# attn`` group under ``remat`` and a tail ``rec`` layer outside it).  The
# depths are cut for time: a step of a rank goes at the pace of its
# collective calls through gloo, 5-10 ms each (whisper at full depth:
# 1,619 calls, 12-13 s a step and 14-17 s a float32 pass; at 12 + 12
# layers 8-10 s each).  Every model's norm scales at ones, each model's own
# initialisation: under the reference's N(0, 0.02) draw of the stacked
# scales, mamba2's and recurrentgemma's layers add next to nothing to the
# tied embedding's row of the token, and the first loss is that of the
# token itself (``first_loss_depth.py --arch``).  Gates as phase 15 (b), and each rank's collectives a step
# equal to ``dryrun.count_collectives``' count of the cell; launches: 2
# forward and 1 backward flash launch per attention a rank a step
# (``train_attn_launches``; mamba2 none).  Phase 3 and phase 10 (a) hold
# and time the flash forward and backward at (b)'s per-rank shapes
# (``family_train_attn``).
TRAIN_FAMILIES = {
    "whisper": dict(arch=WHISPER, layers=4, enc_layers=4, batch=2,
                    seq=448, steps=2, seed=0, reduced=False, mode=None,
                    norms="ones"),
    # 6 of its 24 layers (12 layers: a step 659 gloo calls): the run's
    # time limit
    "mamba2": dict(arch=SSM, layers=6, batch=2, seq=2048, steps=2, seed=0,
                   reduced=False, mode=None, norms="ones"),
    "recurrentgemma": dict(arch=HYBRID, layers=4, batch=2, seq=2048,
                           steps=2, seed=0, reduced=False, mode=None,
                           norms="ones")}
# each rank's attention at (b): 1 of 2 rows; whisper's 4 of 16 heads (its
# KV heads too), recurrentgemma's span of 3 of 10 q heads on its KV head
TRAIN_FAMILY_RANK = {WHISPER: dict(heads=4, kv_heads=4),
                     HYBRID: dict(heads=3, kv_heads=1)}


def family_train_attn(torch, dev):
    """(key, arch, q, k, v, mask) as each rank of phase 17 (b) launches the
    flash kernel and its backward: whisper-medium's encoder (1 row, 4 of
    16 heads, 1,500 frames, D 64, not causal), its decoder's
    self-attention (448 positions, causal) and cross-attention (448
    against 1,500, not causal), and recurrentgemma-2b's span of 3 of 10 q
    heads on its one KV head (2,048 positions under the 2,048 window, D
    256); q, k and v views of [B, S, H, D] projections."""
    g = torch.Generator(device="cpu").manual_seed(67)
    rows = TRAIN_FAMILIES["whisper"]["batch"] // TRAIN_MESH[0]

    def proj(cfg, n, heads):
        return _randn(torch, g, (rows, n, heads, cfg.head_dim), dev,
                      torch.bfloat16).transpose(1, 2)

    cfg = shape_cfg(WHISPER, TRAIN_FAMILY_RANK[WHISPER])
    f, s, h = cfg.enc_seq, TRAIN_FAMILIES["whisper"]["seq"], cfg.num_heads
    for key, sq, skv, causal in (("rank_train_encoder_shape", f, f, False),
                                 ("rank_train_self_shape", s, s, True),
                                 ("rank_train_cross_shape", s, f, False)):
        yield (key, WHISPER, proj(cfg, sq, h), proj(cfg, skv, h),
               proj(cfg, skv, h), dict(causal=causal))
    cfg = shape_cfg(HYBRID, TRAIN_FAMILY_RANK[HYBRID])
    s = TRAIN_FAMILIES["recurrentgemma"]["seq"]
    yield ("rank_train_hybrid_shape", HYBRID, proj(cfg, s, cfg.num_heads),
           proj(cfg, s, 1), proj(cfg, s, 1),
           dict(causal=True, window=cfg.window))


def family_train_phase(torch, dev: str, name_power: str,
                       parts: dict = TRAIN_FAMILIES, pin_names=None) -> dict:
    """Phase 17.  Returns the flash kernels' launch totals of (b).  ``dev``
    "cpu" with reduced ``parts`` (and a few ``pin_names``) rehearses it on
    the CPU."""
    return train_across_ranks(torch, dev, name_power, "family_train",
                              "torch_sharded_families_train_cases", parts,
                              pin_names)


# ------------------ phase 18: the reference's attention and remat knobs
# The settings of ``ArchConfig`` that the reference's tuning plan
# (``benchmarks/perf_hillclimb.py``) turns: ``remat="dots"``, ``attn_shard``
# "seq" and "heads", ``pad_heads_to`` (and ``attn_f32_scores``, whose card
# error phase 3's flash row reports). (a) llama3.2-3b at full width and depth,
# 2 x 2,048 tokens, float32 parameters and moments, bf16 compute, under "full"
# and then "dots" from the same seed, ``KNOB_REMAT["steps"]`` AdamW steps each:
# the first step's products counted (``aten.mm`` under ``count_mm``: under
# "dots" the backward runs each product's two gradients and the loss chunks'
# own recomputation, and no layer product again), the losses, gradient norms
# and the parameters after the last step equal (bit for bit expected; else
# within ``KNOB_REMAT_REL``), step s and peak GB of both.  (b) llama3.2-3b at
# full width, 4 of its 28 layers, norm scales at ones (phase 15 (b)'s model),
# bf16, on 2x4 under ``attn_shard="seq"`` (each rank's queries its block of 128
# of 512 positions with every head, keys and values to its block's end) and
# under "auto": 8 x 512 prompts and 2 decode steps fed the greedy tokens of the
# 1x1 run on the same weights, both within ``SHARD_REL`` of 1x1 and of each
# other, each rank's collectives equal to the dry-run's count of the cell, one
# flash launch per layer a prefill and one decode launch per layer a step; then
# 2 training steps of 2 x 2,048 under "seq" from 1x1's weights every step under
# phase 15 (b)'s gates (``train_across_ranks``, with
# ``tests/torch_sharded_knobs_train_cases.py``'s pinned "seq" case on every
# rank first).  (c) The same model with ``pad_heads_to=32`` and
# ``attn_shard="heads"`` on 2x4 (8 whole padded heads a rank), served as (b)
# against the unpadded model on 1x1 carried from the padded tree's real-head
# columns (``convert.unpad_heads``).  Phase 3 holds the flash forward and
# backward at (b)'s largest rank shapes (``seq_rank_shape``,
# ``seq_train_rank_shape``).
KNOB_REMAT = dict(arch="llama3.2-3b", batch=2, seq=2048, steps=3, seed=0,
                  reduced=False)
KNOB_REMAT_REL = 1e-6
KNOB_SERVE = dict(arch="llama3.2-3b", layers=4, requests=8, prompt_len=512,
                  decode=2, seed=0, reduced=False, norms="ones")
KNOB_PARTS = {"seq": {"attn_shard": "seq"}, "auto": {},
              "pad": {"pad_heads_to": 32, "attn_shard": "heads"}}
KNOB_TRAIN = dict(TRAIN_RANKS, steps=2, knobs={"attn_shard": "seq"})
KNOB_TRAIN_PINS = ["llama/2x4/seq"]
# each rank's attention at (b): 4 of 8 rows and the last block of 128 of
# 512 query positions over every key (serve); 1 of 2 rows and 512 of
# 2,048 over every key (train); 24 q heads on 8 KV heads
KNOB_RANK = dict(requests=4, rows=128, keys=512, train_rows=512,
                 train_keys=2048)


def count_mm(torch):
    """A dispatch mode that counts ``aten.mm`` / ``aten.addmm`` calls, the
    products without a batch dimension: ``.fwd`` outside a backward pass,
    ``.bwd`` inside one (the products it recomputes included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.fwd = self.bwd = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                if torch._C._current_graph_task_id() == -1:
                    self.fwd += 1
                else:
                    self.bwd += 1
            return func(*args, **(kwargs or {}))
    return CountMM()


def remat_steps(torch, cfg, sv: dict, dev: str, against=None) -> dict:
    """(a)'s AdamW steps under ``cfg.remat`` from the seed's tree: losses,
    gradient norms, the products of the first step's forward and backward
    passes (``count_mm``, ``"mm"``), step s (the mean of the steps after
    the first), the peak GB, the flash launches, and the parameters after
    the last step (on the host, by path); or, given ``against`` (another
    run's), the leaves that differ from them and the largest relative
    gap."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import leaves
    if dev != "cpu":
        reset_counts(torch)
    before = (flash_ops.launches, flash_ops.bwd_launches)
    params = get_model(cfg).init(cfg, torch.Generator(dev).manual_seed(
        sv["seed"]))
    ocfg = AdamWConfig(opt_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    mm = count_mm(torch)
    res = {"loss": [], "grad_norm": [], "step_s": []}
    for i in range(sv["steps"]):
        data = synth_batch(cfg, sv["batch"], sv["seq"], torch.Generator()
                           .manual_seed(sv["seed"] + 1000 + i), dev)
        mesh_sync(torch, dev)
        t0 = time.perf_counter()
        with mm if i == 0 else contextlib.nullcontext():
            params, opt, m = step(params, opt, data)
        res["loss"].append(float(m["loss"]))
        res["grad_norm"].append(float(m["grad_norm"]))
        res["step_s"].append(time.perf_counter() - t0)
    res["mm"] = [mm.fwd, mm.bwd]
    if dev != "cpu":
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["mean_step_s"] = statistics.mean(res["step_s"][1:])
    res["launches"] = {"flash_attention": flash_ops.launches - before[0],
                       "flash_attention_bwd":
                           flash_ops.bwd_launches - before[1]}
    del opt, step
    if against is None:
        res["params"] = {p: t.cpu() for p, t in leaves(params)}
    else:
        mine = dict(leaves(params))
        gaps = {}
        for p, t in against.items():
            t = t.to(mine[p].device)
            if not torch.equal(t, mine[p]):
                gaps[p] = float((t - mine[p]).abs().max()
                                / t.abs().max().clamp_min(1e-30))
        res["params_unequal"] = sorted(gaps)
        res["params_max_rel_gap"] = max(gaps.values(), default=0.0)
    del params
    return res


def remat_phase(torch, dev: str, name_power: str,
                sv: dict = KNOB_REMAT) -> dict:
    """Phase 18 (a).  Returns the flash launch totals.  ``dev`` "cpu" with
    a reduced ``sv`` rehearses it on the CPU."""
    from repro_torch.configs import get_config
    card = dev != "cpu"
    base = get_config(sv["arch"])
    if sv["reduced"]:
        base = base.reduced()
    chunks = -(-sv["batch"] * sv["seq"] // base.loss_chunk)
    full = remat_steps(torch, base.replace(remat="full"), sv, dev)
    dots = remat_steps(torch, base.replace(remat="dots"), sv, dev,
                       against=full.pop("params"))
    steps = {"full": full, "dots": dots}
    want = {"flash_attention": 2 * base.num_layers * sv["steps"],
            "flash_attention_bwd": base.num_layers * sv["steps"]}
    for remat, rec in steps.items():
        if rec["launches"] != (want if card else dict.fromkeys(want, 0)):
            raise AssertionError(f"knob (a) {remat}: {rec['launches']} "
                                 f"flash launches, want {want}")
    gaps = [abs(a - b) / abs(a) for key in ("loss", "grad_norm")
            for a, b in zip(full[key], dots[key])]
    (fwd, bwd), want_bwd = dots["mm"], 2 * dots["mm"][0] + chunks
    emit({"phase": "knob_remat", "part": "a", "arch": base.name,
          "layers": base.num_layers, "global_batch": [sv["batch"],
                                                      sv["seq"]],
          "steps": sv["steps"], "compute": base.compute_dtype,
          "params": base.param_dtype, "dots_bwd_mm_want": want_bwd,
          "full": full, "dots": dots,
          "loss_norm_max_rel_gap": max(gaps), "limit": KNOB_REMAT_REL,
          "nvidia_smi": name_power})
    if bwd != want_bwd or full["mm"][0] != fwd or full["mm"][1] <= bwd:
        raise AssertionError(f"knob (a): the first step's products "
                             f"{dots['mm']} under dots ({full['mm']} under "
                             f"full), want a backward of {want_bwd}")
    if max(gaps) > KNOB_REMAT_REL \
            or dots["params_max_rel_gap"] > KNOB_REMAT_REL:
        raise AssertionError(f"knob (a): dots against full: losses and "
                             f"norms {max(gaps)}, parameters "
                             f"{dots['params_max_rel_gap']}")
    if not all(math.isfinite(x) for r in steps.values()
               for x in r["loss"] + r["grad_norm"]):
        raise AssertionError("knob (a): losses not finite")
    return {k: full["launches"][k] + dots["launches"][k] for k in want}


def knob_norms(params: dict, sv: dict) -> dict:
    """(b)'s or (c)'s serving tree with its norm scales at ones where
    ``sv["norms"]`` says so."""
    return set_norm_scales(params, 1.0) if sv.get("norms") == "ones" \
        else params


def knob_prepare(params: dict, cfg, sv: dict):
    """The 1x1 run of (b) or (c) (``mesh_reference``'s ``prepare``): the
    tree every rank draws its blocks of (``knob_norms``); a padded tree
    served as the unpadded model carried from its real-head columns
    (``convert.unpad_heads``)."""
    from repro_torch.models.convert import unpad_heads
    return unpad_heads(knob_norms(params, sv), cfg)


def knob_rank(rank: int, parts: dict, tokens: dict, dev: str) -> dict:
    """Phase 18 (b) and (c) serving on one rank of the 8 (on the card, all
    on cuda:0): each part of ``parts`` (``KNOB_SERVE`` with its
    ``knobs``) served from this rank's blocks, fed ``tokens[part]``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import rank_mesh_ctx
    card = dev != "cpu"
    t_enter = time.time()
    mctx = rank_mesh_ctx(SHARD_MESH, device=dev)
    out = {}
    for key, sv in parts.items():
        t0 = time.perf_counter()
        cfg = mesh_cfg(sv)
        params = knob_norms(sharded_params(torch, cfg, mctx, sv["seed"],
                                           dev), sv)
        rec = {"param_bytes": tree_bytes(params),
               "param_bytes_dryrun": held_param_bytes(cfg, mctx,
                                                      torch.bfloat16)}
        rec |= rank_serve(torch, mctx, cfg, params, tokens[key],
                          sv["prompt_len"], sv["decode"], dev)
        del params
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        rec["wall_s"] = time.perf_counter() - t0
        out[key] = rec
    out["t_enter"], out["t_exit"] = t_enter, time.time()
    return out


def knob_serve(torch, dev: str, name_power: str, sv: dict = KNOB_SERVE,
               parts: dict = KNOB_PARTS) -> dict:
    """Phase 18 (b) and (c) serving.  Returns the attention kernels'
    launch totals."""
    import numpy as np
    from repro_torch.launch.dryrun import count_collectives
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.sharding import Mesh, MeshCtx
    card = dev != "cpu"
    label = "gloo through host memory, 8 ranks on one card"
    svs = {k: dict(sv, knobs=kn) for k, kn in parts.items()}
    refs = {}
    for key in ("auto", "pad"):
        if card:
            reset_counts(torch)
        t0 = time.perf_counter()
        refs[key] = mesh_reference(torch, svs[key], dev, functools.partial(
            knob_prepare, sv=svs[key]))
        refs[key]["wall_s"] = time.perf_counter() - t0
    refs["seq"] = refs["auto"]            # one model, two layouts
    if card:
        reset_counts(torch)
    t_spawn = time.time()
    t0 = time.perf_counter()
    ranks = run_ranks(knob_rank, MESH_WORLD, svs,
                      {k: refs[k]["tokens"] for k in svs},
                      "cuda:0" if card else "cpu", timeout_s=900)
    ranks_s = time.perf_counter() - t0
    over = rank_overheads(ranks, t_spawn, time.time())
    grid = MeshCtx(Mesh(np.arange(MESH_WORLD).reshape(SHARD_MESH),
                        ("data", "model")))
    totals = {"flash_attention": 0, "decode_attention": 0}
    rels = {}
    for key, ksv in svs.items():
        cfg = mesh_cfg(ksv)
        per = [r[key] for r in ranks]
        ref = refs[key]
        b, p_len, steps = ksv["requests"], ksv["prompt_len"], ksv["decode"]
        want = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * steps}
        counted = {
            "prefill": count_collectives(cfg, ShapeConfig(
                "prefill", "prefill", p_len, b), grid),
            "decode": count_collectives(cfg, ShapeConfig(
                "decode", "decode", p_len + steps, b), grid)}
        for m in per:
            if m["launches"] != (want if card else dict.fromkeys(want, 0)):
                raise AssertionError(f"knob {key}: a rank launched "
                                     f"{m['launches']}, want {want}")
            if m["logits_sum"] != per[0]["logits_sum"]:
                raise AssertionError(f"knob {key}: the ranks' logits differ")
            if m["param_bytes"] != m["param_bytes_dryrun"]:
                raise AssertionError(f"knob {key}: a rank holds "
                                     f"{m['param_bytes']} bytes, the "
                                     f"dry-run's {m['param_bytes_dryrun']}")
            for part, k in (("prefill", "prefill_collectives"),
                            ("decode", "decode_collectives_per_step")):
                if m[k] != {x: counted[part][x] for x in ("calls",
                                                          "bytes")}:
                    raise AssertionError(f"knob {key} {part}: a rank's "
                                         f"collectives {m[k]}, the "
                                         f"dry-run's {counted[part]}")
        for k in totals:
            totals[k] += sum(m["launches"][k] for m in per)
        m = per[0]
        if not np.isfinite(m["logits"]).all():
            raise AssertionError(f"knob {key}: logits not finite")
        rel = {"prefill": mesh_rel(m["logits"][0], ref["logits"][0]),
               "decode": mesh_rel(m["logits"][1:], ref["logits"][1:])}
        rels[key] = rel
        emit({"phase": "knob_serve", "part": "c" if key == "pad" else "b",
              "layout": key, "knobs": ksv["knobs"], "arch": cfg.name,
              "mesh": list(SHARD_MESH),
              "reduced": {"num_layers": [ksv["layers"], 28]},
              "norm_scales": ksv["norms"], "requests": b,
              "prompt_len": p_len, "decode": steps, "timing": label,
              "reference_1x1": {"padded_heads": ref["padded_heads"],
                                "prefill_s": ref["prefill_s"]},
              "rel_err_vs_1x1": rel,
              "argmax_equal": float((m["logits"].argmax(-1)
                                     == ref["logits"].argmax(-1)).mean()),
              "prefill_s": m["prefill_s"],
              "prefill_s_max_rank": max(x["prefill_s"] for x in per),
              "decode_ms_per_step": m["decode_ms_per_step"],
              "prefill_collectives": m["prefill_collectives"],
              "decode_collectives_per_step":
                  m["decode_collectives_per_step"],
              "collectives_equal_dryrun": True,
              "launches_per_rank": m["launches"],
              "param_bytes_per_rank": m["param_bytes"],
              "peak_gb_per_rank": max(x.get("peak_gb", 0) for x in per),
              "rank_wall_s": max(x["wall_s"] for x in per),
              "limit": SHARD_REL, "nvidia_smi": name_power})
        if max(rel.values()) >= SHARD_REL:
            raise AssertionError(f"knob {key} vs 1x1: {rel}")
    seq, auto = ranks[0]["seq"]["logits"], ranks[0]["auto"]["logits"]
    rel = {"prefill": mesh_rel(seq[0], auto[0]),
           "decode": mesh_rel(seq[1:], auto[1:])}
    emit({"phase": "knob_serve", "part": "b", "layout": "seq_vs_auto",
          "rel_err": rel, "limit": SHARD_REL, **over,
          "ranks_s": ranks_s,
          "reference_1x1_s": {k: refs[k]["wall_s"] for k in ("auto", "pad")},
          "nvidia_smi": name_power})
    if max(rel.values()) >= SHARD_REL:
        raise AssertionError(f"knob seq vs auto on 2x4: {rel}")
    return totals


def knob_phase(torch, dev: str, name_power: str, sv_a: dict = KNOB_REMAT,
               sv_serve: dict = KNOB_SERVE, parts: dict = KNOB_PARTS,
               sv_train: dict = KNOB_TRAIN,
               pin_names: list = KNOB_TRAIN_PINS) -> dict:
    """Phase 18.  Returns the attention kernels' launch totals.  ``dev``
    "cpu" with reduced settings rehearses it on the CPU."""
    t_phase = time.perf_counter()
    card = dev != "cpu"
    totals = {"flash_attention": 0, "flash_attention_bwd": 0,
              "decode_attention": 0}
    t0 = time.perf_counter()
    for k, n in remat_phase(torch, dev, name_power, sv_a).items():
        totals[k] += n
    a_s = time.perf_counter() - t0
    if card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for k, n in knob_serve(torch, dev, name_power, sv_serve, parts).items():
        totals[k] += n
    serve_s = time.perf_counter() - t0
    if card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for k, n in train_across_ranks(
            torch, dev, name_power, "knob_train",
            "torch_sharded_knobs_train_cases", {"seq": sv_train},
            pin_names).items():
        totals[k] += n
    emit({"phase": "knob_done", "seconds": time.perf_counter() - t_phase,
          "remat_s": a_s, "serve_s": serve_s,
          "train_s": time.perf_counter() - t0, "launches": totals,
          "nvidia_smi": name_power})
    return totals


PROFILES = ("episode", "serve", "fleet", "decode", "train")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", nargs="*", choices=PROFILES, default=None,
                    help="also profile (all, or the ones named) q8_justin "
                         "(episode), the serve path (serve), the 128-tenant "
                         "fleet (fleet), the decode steps of the served "
                         "models of phases 5, 7 and 9 (decode) and a "
                         "llama3.2-3b training step (train) into "
                         "chiprun_out/")
    ap.add_argument("--ab-episode", help=argparse.SUPPRESS)
    ap.add_argument("--store", default="columnar", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ab_episode:
        return ab_child(args.ab_episode, args.store)
    profile = set(PROFILES) if args.profile == [] else set(
        args.profile or ())

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    # float32 products in full f32 (the plain versions and the logits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = json.loads(GOLDEN.read_text())
    t_start = time.perf_counter()

    # 1. device
    name_power = smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": name_power, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    dev = "cuda"

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          **_build.build_info})
    ptxas_clean(_build.build_info["ptxas"], PTXAS_CLEAN)
    # 3. kernels against their plain versions
    rows = [check_probe(torch, dev), check_agg(torch, dev),
            check_flash(torch, dev), check_decode(torch, dev)]
    torch.cuda.empty_cache()
    emit({"kernels": [r["name"] for r in rows]})

    # 4. golden episodes on the card
    totals = {"sorted_probe": 0, "window_agg": 0}
    walls = {}
    for key in ("q11_justin", "q8_justin", "q11_ds2", "q8_ds2"):
        wall, res, launches = timed_episode(torch, key, golden, dev)
        walls[key] = wall
        emit({"phase": "episode", "episode": key, "wall_s": wall,
              "decisions_match_golden": True, "launches": launches, **res})
        for k, n in launches.items():
            if n == 0:
                raise AssertionError(f"{key} never launched {k}")
            totals[k] += n
    if "episode" in profile:
        profile_run("q8_justin", lambda: run_episode("q8_justin", golden,
                                                     dev),
                    walls.get("q8_justin"), episode="q8_justin")

    # 5. serve at full width
    from repro_torch.configs import get_config
    totals.update(run_serve(torch, dev))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    check_decode_matches_prefill(torch, dev, get_config(ARCH),
                                 SERVE["prompt_len"])
    torch.cuda.empty_cache()
    if "serve" in profile:
        profile_serve(torch)

    # 6. scenarios: priced reconfiguration, faults, co-location, fleets
    launches, walls = scenario_phase(torch, dev)
    for k, n in launches.items():
        totals[k] += n
    torch.cuda.empty_cache()
    if "fleet" in profile:
        profile_run("d_fleet_128", lambda: run_fleet_case(
            port_api(), {"device": dev}, "d_fleet_128", "vectorized"),
            walls["d_fleet_128_vectorized"], run="d_fleet_128_vectorized")

    # 7. serve controller, sliding window and mixture of experts
    for k, n in serve_phase(torch, dev).items():
        totals[k] += n
    torch.cuda.empty_cache()
    if "decode" in profile:
        from repro_torch.configs import get_config
        for cfg, sv in ((get_config(ARCH), SERVE),
                        (get_config("h2o-danube-1.8b"),
                         SERVE_7["h2o-danube-1.8b"]),
                        (get_config("mixtral-8x7b").replace(
                            num_layers=MIXTRAL_LAYERS),
                         SERVE_7["mixtral-8x7b"])):
            profile_decode(torch, cfg, sv)
            gc.collect()
            torch.cuda.empty_cache()

    # 8. chunked attention, VLM and encoder-decoder
    for k, n in families_phase(torch, dev).items():
        totals[k] += n
    torch.cuda.empty_cache()

    # 9. state-space and hybrid: mamba2 and recurrentgemma
    for k, n in state_space_phase(torch, dev).items():
        totals[k] += n
    torch.cuda.empty_cache()
    if "decode" in profile:
        for arch, sv in SERVE_9.items():
            profile_decode(torch, get_config(arch), sv)
            gc.collect()
            torch.cuda.empty_cache()

    # 10. training: the flash backward kernel, llama3.2-3b at full width,
    # every reduced family against its pin, a restart through a checkpoint
    rows.append(check_flash_bwd(torch, dev))
    torch.cuda.empty_cache()
    for k, n in train_phase(torch, dev).items():
        totals[k] = totals.get(k, 0) + n
    torch.cuda.empty_cache()
    if "train" in profile:
        profile_train(torch, dev)
        gc.collect()
        torch.cuda.empty_cache()

    # 11. the dry-run: the card's mesh, every cell lowered, the cells that
    # fit one card run once
    for k, n in dryrun_phase(torch, name_power).items():
        totals[k] += n
    torch.cuda.empty_cache()

    # 12. the legacy store: golden episodes, the store A/B, the plain route
    for k, n in legacy_phase(torch, golden, dev, name_power).items():
        totals[k] += n
    torch.cuda.empty_cache()

    # 13-18 run their ranks on one pool of 8 processes, started once: a
    # fresh rank pays its start, its CUDA context and its first meta-device
    # trace again.  The ranks' allocators grow their segments in place: 8
    # ranks sharing the card would each keep ~0.9 GB reserved and unused
    # between fixed segments
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    with RankPool(MESH_WORLD):
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        # 13. the MoE block across 8 ranks on the card: the pins, then
        # mixtral at full width in each mode
        for k, n in mesh_phase(torch, dev, name_power).items():
            totals[k] += n
        torch.cuda.empty_cache()

        # 14. the decoder's sharded steps across 8 ranks on the card: the
        # pins, llama3.2-3b at full size, mixtral's MoE layers in "2d" and
        # "ffn"
        for k, n in sharded_phase(torch, dev, name_power).items():
            totals[k] += n
        torch.cuda.empty_cache()

        # 15. training across 8 ranks on the card: the pins, llama3.2-3b at
        # full size and mixtral's "2d" layer, each against its 1x1 run
        for k, n in train_ranks_phase(torch, dev, name_power).items():
            totals[k] += n
        torch.cuda.empty_cache()

        # 16. serving across 8 ranks on the card for the enc-dec, SSM and
        # hybrid families: the pins, then whisper-medium, mamba2-130m and
        # recurrentgemma-2b at full width, each against its 1x1 run
        for k, n in family_phase(torch, dev, name_power).items():
            totals[k] += n
        torch.cuda.empty_cache()

        # 17. training across 8 ranks on the card for the enc-dec, SSM and
        # hybrid families: the pins, then whisper-medium, mamba2-130m and
        # recurrentgemma-2b at full width, each against its 1x1 run
        for k, n in family_train_phase(torch, dev, name_power).items():
            totals[k] += n
        torch.cuda.empty_cache()

        # 18. the reference's attention and remat knobs: "dots" against
        # "full" at full size, "seq" and "auto" across 8 ranks, padded heads
        for k, n in knob_phase(torch, dev, name_power).items():
            totals[k] += n
        torch.cuda.empty_cache()

    for row in rows:
        row["launches"] = totals[row["name"]]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_share", "achieved", "achieved_unit", "warm_ms",
            "wrapper_ms")
    route = ("decode_route",)          # a decode row's: "mma" (bf16)
    emit({"kernels": [{
        **{k: r[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", *keys,
                             *(route if route[0] in r else ()))},
        **{x: {k: r[x][k] for k in ("shape", "max_abs_err", *keys,
                                    *(route if route[0] in r[x] else ()))}
           for x in SHAPE_KEYS if x in r}}
        for r in rows]})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
