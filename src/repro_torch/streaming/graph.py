"""Dataflow graph: operators + edges, with per-operator parallelism and
memory level (the configuration C^t that Justin/DS2 produce).  Port of
``repro.streaming.graph``; pure host bookkeeping."""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.streaming.operators import Operator, SinkOp, SourceOp


@dataclass
class OpNode:
    op: Operator
    parallelism: int = 1
    memory_level: int | None = 0     # None == ⊥ (no managed memory)


@dataclass
class Dataflow:
    name: str
    nodes: dict[str, OpNode] = field(default_factory=dict)
    edges: list[tuple[str, str]] = field(default_factory=list)

    def add(self, op: Operator, parallelism: int = 1,
            memory_level: int | None = 0, after: str | None = None) -> str:
        if op.name in self.nodes:
            raise ValueError(f"duplicate operator {op.name}")
        self.nodes[op.name] = OpNode(op, parallelism,
                                     memory_level if op.stateful else None)
        if after is not None:
            self.edges.append((after, op.name))
        return op.name

    def chain(self, *ops: Operator) -> "Dataflow":
        prev = None
        for op in ops:
            self.add(op, after=prev)
            prev = op.name
        return self

    def upstream(self, name: str) -> list[str]:
        return [s for s, d in self.edges if d == name]

    def downstream(self, name: str) -> list[str]:
        return [d for s, d in self.edges if s == name]

    def topo_order(self) -> list[str]:
        indeg = {n: len(self.upstream(n)) for n in self.nodes}
        order, queue = [], [n for n, d in indeg.items() if d == 0]
        while queue:
            n = queue.pop(0)
            order.append(n)
            for d in self.downstream(n):
                indeg[d] -= 1
                if indeg[d] == 0:
                    queue.append(d)
        if len(order) != len(self.nodes):
            raise ValueError("dataflow has a cycle")
        return order

    def sources(self) -> list[str]:
        return [n for n, node in self.nodes.items()
                if isinstance(node.op, SourceOp)]

    def sinks(self) -> list[str]:
        return [n for n, node in self.nodes.items()
                if isinstance(node.op, SinkOp)]

    def config(self) -> dict[str, tuple[int, int | None]]:
        """C^t as {op: (parallelism, memory_level)}."""
        return {n: (node.parallelism, node.memory_level)
                for n, node in self.nodes.items()}
