"""The numbers that decide ``correct``.

Every number is a gap between what the program produced and what the
plain reference gives for the same seed-drawn weights and inputs; a
cell's ``workloads/<cell>.json`` holds the limit each is held to."""
from __future__ import annotations

import statistics

import torch


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_gap(got: dict, want: dict, skip=()) -> float:
    """The worst leaf's gap between two norms, against the reference's
    norm of that leaf or the median leaf's, whichever is larger."""
    med = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in want if k not in skip)


def quiet_leaves(grad_norms: dict) -> set:
    """Leaves whose reference gradient is nought to rounding: under a
    thousandth of the median leaf's."""
    med = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v < 1e-3 * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """loss: the worst step's relative loss gap; grad: the worst leaf's
    gap of the first (clipped) gradient's norm; change: the worst leaf's
    gap of the norm of the parameters' change over the checked steps."""
    return {
        "loss": max(rel_gap(p, r) for p, r in zip(prog["losses"],
                                                   ref["losses"])),
        "grad": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
        "change": leaf_gap(prog["change_norms"], ref["change_norms"],
                           skip=quiet_leaves(ref["grad_norms"])),
    }


def logit_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (float32 logits)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def rms_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The root-mean-square of got - want over that of want."""
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor
               ) -> torch.Tensor:
    """The gap by which each chosen token's reference logit lies below
    the reference's best at its position: ref_logits [..., V], tokens
    [...] (the program's served tokens, or the control's argmax); the
    result has the tokens' shape."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return best - got


def hold(numbers: dict, limits: dict) -> dict:
    """{name: [value, limit]} for every number with a limit; a number
    passes at or under its limit."""
    return {k: [numbers[k], limits[k]] for k in limits}


def passed(held: dict) -> bool:
    return all(v == v and v <= lim for v, lim in held.values())
