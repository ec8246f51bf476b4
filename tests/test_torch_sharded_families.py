"""The enc-dec, SSM and hybrid families' steps across ranks against the
JAX package's on 8 devices.

8 gloo ranks on the CPU (``launch.mesh.run_ranks``, spawned once for the
module, one intra-op thread each) run every case of
``torch_sharded_families_cases``: reduced whisper-medium (encoder,
self- and cross-attention caches), mamba2-130m (the SSD mixer) and
recurrentgemma-2b (RG-LRU blocks and local attention on one KV head) on
a 2x4 ``("data", "model")`` mesh and a 2x2x2 ``("pod", "data",
"model")`` one: a prefill over ``[batch, 16]`` tokens and 4 decode steps,
every rank holding only its blocks of the parameters, the caches and the
batch.  The gathered logits and caches are held to the reference's
answers in ``tests/data/torch_sharded_families.json`` (written by
``test_torch_pins.py --write-sharded-families``) within 2e-5 absolute,
float32 with values of order 1; every rank gathers the same.  Each rank's
collectives equal a ``CountingMesh``'s count of the same step on meta
tensors, and a count written out per layer.
"""
import collections
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_families_cases as C  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import hybrid, ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import blocks  # noqa: E402
from repro_torch.models.sharding import CountingMesh, MeshCtx  # noqa: E402

PINS = json.loads((pathlib.Path(__file__).resolve().parent / "data"
                   / "torch_sharded_families.json").read_text())
ATOL = 2e-5


@pytest.fixture(scope="module")
def ranks() -> list:
    """Every rank's answers to every case (one spawn of 8 ranks)."""
    return run_ranks(C.rank_cases, C.WORLD, "cpu", timeout_s=600)


def _mctx(mesh: str, coords=None) -> MeshCtx:
    shape, names = C.MESHES[mesh]
    return MeshCtx(CountingMesh(shape, names, coords))


def test_pin_file_covers_every_case():
    keys = set()
    for name, (_, _, _, batch, slots) in C.CASES.items():
        cfg = C.port_config(name)
        shapes = get_model(cfg).cache_shapes(cfg, batch, slots)
        keys |= {f"{name}/{s}" for s in C.steps()}
        keys |= {f"{name}/{k}" for k in C.cache_paths(shapes)}
    assert set(PINS) == {"_meta", *keys}
    assert PINS["_meta"]["replace"] == C.REPLACE
    assert PINS["_meta"]["cases"] == {
        k: [list(v) if isinstance(v, tuple) else v for v in case]
        for k, case in C.CASES.items()}


@pytest.mark.parametrize("name", list(C.CASES))
def test_port_on_ranks_matches_reference_pin(ranks, name):
    got = ranks[0][name]
    for step in C.steps():
        want = C.decode(PINS[f"{name}/{step}"])
        assert got[step].shape == want.shape == (C.CASES[name][3], 256)
        assert 0.5 < np.abs(want).max() < 20          # values of order 1
        assert np.abs(got[step] - want).max() <= ATOL, (name, step)
    caches = [k for k in PINS if k.startswith(f"{name}/cache/")]
    assert caches
    for key in caches:
        want = C.decode(PINS[key])
        have = got[key[len(name) + 1:]]
        assert have.shape == want.shape
        assert np.abs(have - want).max() <= ATOL, key


def test_every_rank_gathers_the_same(ranks):
    for name in C.CASES:
        for key, val in ranks[0][name].items():
            if isinstance(val, np.ndarray):
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r[name][key], val,
                                                  (name, key))


def test_every_rank_counts_what_a_counting_mesh_counts(ranks):
    """Calls and output bytes per kind and axes, step by step."""
    for r in ranks:
        for name in C.CASES:
            for step in C.steps():
                assert r[name][f"log/{step}"] == r[name][f"count/{step}"], \
                    (name, step)


def _branches(name: str) -> dict:
    """The cache layout branches case ``name`` takes, by cache."""
    cfg = C.port_config(name)
    mctx = _mctx(C.CASES[name][2])
    slots = C.CASES[name][4]
    if cfg.family == "encdec":
        return {"self": tfm.kv_branch(cfg, mctx, slots),
                "cross": tfm.kv_branch(cfg, mctx, cfg.enc_seq)}
    if cfg.family == "hybrid":
        return {"prefill": tfm.kv_branch(cfg, mctx, min(cfg.window,
                                                        C.PROMPT)),
                "decode": tfm.kv_branch(cfg, mctx, slots)}
    specs = ssm.ssm_cache_specs(cfg, mctx)
    return {k: "split" if "model" in v else "replicated"
            for k, v in specs.items()}


def test_the_cases_cover_every_layout_branch():
    """whisper's self and cross caches in all three ``kv_spec`` branches;
    mamba2's SSM state split and replicated, its conv state split (the
    replicated conv state cannot be laid out: below), heads that
    ``model`` cuts through; recurrentgemma's RG-LRU width split, its
    caches in "slots" and "replicated", its prefill and decode in
    different branches, 10 q heads over 4 ranks; a batch the data axes
    do not divide in every family; both meshes."""
    got = collections.defaultdict(set)
    for name in C.CASES:
        cfg = C.port_config(name)
        for cache, branch in _branches(name).items():
            got[(cfg.family, cache)].add(branch)
    assert got == {
        ("encdec", "self"): {"heads", "slots", "replicated"},
        ("encdec", "cross"): {"heads", "slots", "replicated"},
        ("ssm", "conv"): {"split"},
        ("ssm", "state"): {"split", "replicated"},
        ("hybrid", "prefill"): {"slots"},
        ("hybrid", "decode"): {"slots", "replicated"}}
    assert any(len(set(_branches(n).values())) > 1 for n in C.CASES
               if C.CASES[n][0] == "recurrentgemma-2b")
    cfgs = {n: C.port_config(n) for n in C.CASES}
    tp = {n: C.MESHES[C.CASES[n][2]][0][-1] for n in C.CASES}
    assert any(c.family == "ssm" and (c.d_inner // tp[n]) % c.ssm_headdim
               for n, c in cfgs.items())
    assert any(c.family == "hybrid" and c.num_heads % tp[n]
               for n, c in cfgs.items())
    assert all(c.lru_width % tp[n] == 0 for n, c in cfgs.items()
               if c.family == "hybrid")
    for family in ("encdec", "ssm", "hybrid"):
        assert {C.CASES[n][2] for n, c in cfgs.items()
                if c.family == family} == set(C.MESHES)
        assert any(C.CASES[n][3] == 1 for n, c in cfgs.items()
                   if c.family == family)


def expected_calls(name: str, step: str) -> dict:
    """The collectives of one step written out layer by layer: the
    embedding's psum over ``model``; then per layer its FSDP gathers over
    the data axes (one per matrix stored over them) and
    whisper: per attention (self, cross and the encoder's) 4 gathers,
    ``wk``/``wv``'s columns gathered over ``model`` where the KV heads do
    not divide it, its output's psum; a slot-split cache's two gathers a
    decode step; per FFN 3 gathers and a psum.
    mamba2: ``wz``, ``wxbc``, ``wdt`` and ``out_proj`` over the data
    axes; the prefill gathers ``wxbc`` and the conv filters whole over
    ``model`` and the final states, decode the conv's output; the norm's
    sum of squares and the output psummed, and a decode step's y over N
    where N is split.
    recurrentgemma: a recurrent layer's ``wx``, ``wy``, ``wo`` and the
    FFN's over the data axes, one reduce-scatter of the gates, the
    mixer's and the FFN's psums; an attention layer as whisper's, ``wq``
    gathered over ``model`` too where the q heads do not divide it."""
    cfg = C.port_config(name)
    _, _, mesh, batch, slots = C.CASES[name]
    shape, names = C.MESHES[mesh]
    tp = shape[-1]
    dp = "all-gather " + ",".join(a for a in names if a != "model")
    decode = step != "prefill"
    calls = collections.Counter({"all-reduce model": 1})

    def attn(branch: str, n: int = 1) -> None:
        calls[dp] += 4 * n
        calls["all-reduce model"] += n
        calls["all-gather model"] += n * (
            2 * (cfg.num_kv_heads % tp > 0) + (cfg.num_heads % tp > 0)
            + 2 * (decode and branch == "slots"))

    def ffn(n: int = 1) -> None:
        calls[dp] += 3 * n
        calls["all-reduce model"] += n

    if cfg.family == "encdec":
        mctx = _mctx(mesh)
        if not decode:
            attn("train", cfg.enc_layers)
            ffn(cfg.enc_layers)
        attn(tfm.kv_branch(cfg, mctx, slots if decode else C.PROMPT),
             cfg.num_layers)
        attn(tfm.kv_branch(cfg, mctx, cfg.enc_seq), cfg.num_layers)
        ffn(cfg.num_layers)
    elif cfg.family == "ssm":
        n = cfg.num_layers
        calls[dp] += 4 * n
        calls["all-gather model"] += n * (1 if decode else 4)
        calls["all-reduce model"] += n * (
            2 + (decode and cfg.ssm_state % tp == 0))
    else:
        groups, tail = hybrid._pattern_counts(cfg)
        kinds = list(cfg.block_pattern) * groups + \
            list(cfg.block_pattern[:tail])
        branch = tfm.kv_branch(cfg, _mctx(mesh), slots if decode
                               else min(cfg.window, C.PROMPT))
        for kind in kinds:
            if kind == "rec":
                calls[dp] += 3
                calls["reduce-scatter model"] += 1
                calls["all-reduce model"] += 1
            else:
                attn(branch)
            ffn()
    return {k: v for k, v in calls.items() if v}


def test_every_rank_issues_the_collectives_written_out(ranks):
    for name in C.CASES:
        for step in C.steps():
            want = expected_calls(name, step)
            for r in ranks:
                got = {k: v[0] for k, v in r[name][f"log/{step}"].items()}
                assert got == want, (name, step)


@pytest.mark.parametrize("arch,replace,leaf", [
    ("mamba2-130m", {"ssm_state": 15}, ("layers", "wxbc")),
    ("recurrentgemma-2b", {"lru_width": 66}, ("groups", "0_rec", "wx"))])
def test_what_cannot_be_laid_out_raises(arch, replace, leaf):
    """The undivided branches of the recurrent caches' specs (mamba2's
    conv state where ``model`` does not divide conv_dim, recurrentgemma's
    where it does not divide the RG-LRU width) come with parameters that
    ``param_specs`` cuts over ``model`` all the same, which neither
    package can lay out (the reference's ``device_put`` raises the same
    ValueError, ROADMAP "Reference caveats")."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced().replace(**replace)
    mctx = _mctx("2x4")
    model = get_model(cfg)
    specs = model.cache_specs(cfg, mctx, 20)
    assert "model" not in (specs["conv"] if cfg.family == "ssm"
                           else specs["groups"]["0_rec"]["conv"])
    shapes, pspecs = model.param_shapes(cfg), model.param_specs(cfg, mctx)
    for key in leaf:
        shapes, pspecs = shapes[key], pspecs[key]
    with pytest.raises(ValueError, match="splits dim 2"):
        blocks(np.zeros(shapes, np.float32), pspecs, mctx)
