"""DS2 (Kalavri et al., OSDI'18) — the CPU-only auto-scaler Justin extends.
Port of ``repro.core.ds2``; pure host code.

DS2's model: an operator's *true processing rate* per task is its observed
processing rate divided by its busyness (the useful-time fraction).  Given a
target source rate, true rates propagate topologically through the dataflow
using observed selectivities; the new parallelism is

    p_i = ceil( true_input_rate_i(target) / true_rate_per_task_i )

optionally headroom-scaled so the resulting busyness sits below a target.

Symbol map (paper §2.2/§4 → code):

=================  ======================================================
paper              here
=================  ======================================================
busyness           ``metrics[op]["busyness"]`` — fraction of task time
                   spent processing (the engine's per-window measurement
                   of Flink's "busy time"); DS2's only scaling signal,
                   which is why it over-provisions memory-pressured
                   operators (§4: capacity estimates made under pressure
                   are too low, forcing several reconfiguration steps)
true rate/task     ``true_rate_per_task`` = processed / busy_s, events/s
                   one task sustains at 100% busyness
selectivity        ``metrics[op]["selectivity"]`` = out/in events over
                   the window, used to propagate the target through the
                   dataflow topologically
p_i                ``ds2_parallelism`` result — the CPU half of C^t; in
                   "ds2" mode every slot also keeps the uniform base
                   managed-memory grant (the one-size-fits-all package
                   Takeaway 1 criticizes; see ``AutoScaler.resources``)
trigger            ``should_trigger`` — unmodified DS2: source rate below
                   target, or any operator busy above ``busy_high`` with
                   a backlog (backpressure)
=================  ======================================================
"""
from __future__ import annotations

import math


def true_rate_per_task(m: dict) -> float:
    """Events/s one task can sustain at 100% busyness."""
    busy = max(m["busy_s"], 1e-9)
    return m["processed"] / busy


def ds2_parallelism(flow, metrics: dict[str, dict], target_rate: float,
                    *, target_busyness: float = 0.8,
                    max_parallelism: int = 64,
                    max_scale_factor: float = 3.0) -> dict[str, int]:
    """One DS2 step: {op: new parallelism}.  Sources/sinks keep p (paper §5:
    sources are injectors, sinks have fixed p=1 and are never a bottleneck).

    ``max_scale_factor`` clamps per-step growth (the Flink operator's
    scale-up.max-factor): per-task capacity estimates made under memory
    pressure improve after each scale-out, which is why DS2 "typically
    requires several reconfiguration steps" (§4).
    """
    topo = flow.topo_order()
    sources = set(flow.sources())
    sinks = set(flow.sinks())
    # propagate true input rates at the target
    true_in: dict[str, float] = {}
    true_out: dict[str, float] = {}
    for name in topo:
        m = metrics[name]
        if name in sources:
            true_in[name] = target_rate
            true_out[name] = target_rate
            continue
        rate_in = sum(true_out[u] for u in flow.upstream(name))
        true_in[name] = rate_in
        true_out[name] = rate_in * m["selectivity"]

    new_p: dict[str, int] = {}
    for name in topo:
        m = metrics[name]
        if name in sources or name in sinks:
            new_p[name] = m["parallelism"]
            continue
        cap = true_rate_per_task(m)
        if cap <= 0:
            new_p[name] = m["parallelism"]
            continue
        need = true_in[name] / (cap * target_busyness)
        p_cur = m["parallelism"]
        p_want = max(1, math.ceil(need))
        p_clamp = max(p_cur + 1, math.ceil(p_cur * max_scale_factor))
        new_p[name] = int(min(p_want, p_clamp, max_parallelism))
    return new_p


def should_trigger(flow, metrics: dict[str, dict], target_rate: float,
                   *, busy_high: float = 0.8, rate_slack: float = 0.98
                   ) -> bool:
    """Unmodified DS2 trigger: high busyness + backpressure, or the sources
    cannot reach the target rate."""
    sources = flow.sources()
    src_rate = sum(metrics[s]["rate_out"] for s in sources)
    if src_rate < rate_slack * target_rate:
        return True
    for name, m in metrics.items():
        if name in sources:
            continue
        if m["busyness"] > busy_high and m["backlog"] > 0:
            return True
    return False
