"""Faults planted underneath the timed path, for the checks that the
comparison catches them: the program's own entry points patched while a
run sets up and measures.

* ``unchanged``: a step returns its state unchanged (training: AdamW
  leaves the parameters and moments as they were; decode: a step leaves
  the caches as they were, its keys and values never written);
* ``half_batch``: half of the batch left out (training: the gradient and
  the loss are the mean over the first half of the rows; serving: the
  second half of the rows gets the first half's answers);
* ``altered``: one answer altered where it is produced (the first row's
  logits put a different token first)."""
from __future__ import annotations

import contextlib

import torch

NAMES = ("unchanged", "half_batch", "altered")
APPLIES = {"train": ("unchanged", "half_batch"),
           "decode_pool": ("unchanged", "half_batch", "altered"),
           "prefill_pool": ("half_batch", "altered")}


def _alter(logits: torch.Tensor) -> torch.Tensor:
    top = logits[0].argmax()
    logits[0, (top + 1) % logits.shape[-1]] = logits[0].max() + 1.0
    return logits


def _halve(t: torch.Tensor) -> torch.Tensor:
    h = t.shape[0] // 2
    t[h:2 * h] = t[:h]
    return t


def _leaves(tree: dict):
    """The cache tensors of a tree ([..., slots, D] each)."""
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


@contextlib.contextmanager
def planted(name: str | None):
    """Patch the port for the duration of the block (nothing for None)."""
    if name is None:
        yield
        return
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer, train_step
    saved = {(tfm, "decoder_decode_step"): tfm.decoder_decode_step,
             (tfm, "decoder_prefill"): tfm.decoder_prefill,
             (optimizer, "adamw_update"): optimizer.adamw_update,
             (train_step, "value_and_grad"): train_step.value_and_grad}
    adamw, vag = optimizer.adamw_update, train_step.value_and_grad
    decode, prefill = tfm.decoder_decode_step, tfm.decoder_prefill

    if name == "unchanged":
        def adamw_fault(params, grads, opt_state, ocfg, **kw):
            return params, dict(opt_state, step=opt_state["step"] + 1), {
                "grad_norm": torch.zeros(())}

        def decode_fault(params, caches, tokens, t, *a, **kw):
            slots = [(c, c[..., t, :].clone()) for c in _leaves(caches)]
            logits, caches = decode(params, caches, tokens, t, *a, **kw)
            for c, old in slots:
                c[..., t, :] = old
            return logits, caches
        optimizer.adamw_update = adamw_fault
        tfm.decoder_decode_step = decode_fault
    elif name == "half_batch":
        def vag_fault(loss_fn, params, batch, microbatch=1, **kw):
            h = next(iter(batch.values())).shape[0] // 2
            return vag(loss_fn, params, {k: v[:h] for k, v in batch.items()},
                       microbatch, **kw)

        def decode_fault(*a, **kw):
            logits, caches = decode(*a, **kw)
            return _halve(logits), caches

        def prefill_fault(*a, **kw):
            logits, caches = prefill(*a, **kw)
            return _halve(logits), caches
        train_step.value_and_grad = vag_fault
        tfm.decoder_decode_step = decode_fault
        tfm.decoder_prefill = prefill_fault
    elif name == "altered":
        def decode_fault(*a, **kw):
            logits, caches = decode(*a, **kw)
            return _alter(logits), caches

        def prefill_fault(*a, **kw):
            logits, caches = prefill(*a, **kw)
            return _alter(logits), caches
        tfm.decoder_decode_step = decode_fault
        tfm.decoder_prefill = prefill_fault
    else:
        raise KeyError(f"no fault {name!r}; known: {NAMES}")
    try:
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
