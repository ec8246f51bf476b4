"""The port's checkpoints and fault-tolerant training driver
(``repro_torch.train.checkpoint``, ``repro_torch.launch.train``) on the
CPU: the counterparts of ``tests/test_checkpoint.py`` (round trip, config
mismatch, pruning, an uncommitted checkpoint ignored, restart after an
injected failure, resume, int8 compression converging, microbatching),
and checkpoints crossing between the two packages both ways with equal
manifests, a bfloat16 leaf included (stored as the reference's numpy
stores it: 2-byte void, manifest dtype "bfloat16")."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train.tree import leaves, tree_map  # noqa: E402


def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((64, 32), generator=g),
            "nested": {"b": torch.arange(100, dtype=torch.int32),
                       "c": torch.randn((7,), generator=g),
                       "h": torch.randn((5, 3), generator=g)
                       .to(torch.bfloat16)}}


def _equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(leaves(a), leaves(b)))


def test_save_restore_roundtrip(tmp_path):
    tree = make_tree()
    ck.save(str(tmp_path), 10, tree, cfg="cfgA")
    like = tree_map(torch.zeros_like, tree)
    restored, step = ck.restore(str(tmp_path), like, cfg="cfgA")
    assert step == 10
    assert _equal(tree, restored)


def test_restore_rejects_config_mismatch(tmp_path):
    tree = make_tree()
    ck.save(str(tmp_path), 1, tree, cfg="cfgA")
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(str(tmp_path), tree, cfg="cfgB")


def test_restore_rejects_shape_mismatch(tmp_path):
    tree = make_tree()
    ck.save(str(tmp_path), 1, tree)
    bad = dict(tree, a=torch.zeros((64, 31)))
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(str(tmp_path), bad)


def test_keep_n_pruning(tmp_path):
    tree = make_tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, tree, keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step"))
    assert dirs == ["step_00000004", "step_00000005"]


def test_uncommitted_checkpoint_ignored(tmp_path):
    tree = make_tree()
    ck.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000009")      # a torn write
    with open(tmp_path / "step_00000009" / "manifest.json", "w") as f:
        f.write("{}")
    assert ck.latest_step(str(tmp_path)) == 1
    assert ck.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "absent"), tree)


def test_small_shards_split_as_the_reference_splits(tmp_path):
    """With shards of 1 MB the leaves spill into several files, in the
    reference's order and at the reference's boundaries."""
    g = torch.Generator().manual_seed(4)
    tree = {f"w{i}": torch.randn((300, 300), generator=g) for i in range(5)}
    ck.save(str(tmp_path / "t"), 1, tree, shard_mb=1)
    jck.save(str(tmp_path / "j"), 1, {k: jnp.asarray(v.numpy())
                                      for k, v in tree.items()}, shard_mb=1)
    mt, mj = (json.loads((tmp_path / d / "step_00000001" /
                          "manifest.json").read_text()) for d in "tj")
    assert mt == mj and mt["n_shards"] > 1


def _jax_tree(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(
        t.numpy()), tree)


def test_checkpoints_cross_between_packages(tmp_path):
    """The same (params, opt_state)-shaped tree saved by each package:
    equal manifests (names, shards, keys, shapes, dtypes, config hash);
    each package restores the other's file to the same values (the
    reference hands back a bf16 leaf as its 2-byte void)."""
    cfg = get_config("llama4-maverick-400b-a17b").reduced()
    jcfg = jax_get_config("llama4-maverick-400b-a17b").reduced()
    tree = (make_tree(1), {"m": make_tree(2),
                           "step": torch.tensor(7, dtype=torch.int32)})
    ck.save(str(tmp_path / "port"), 3, tree, cfg=cfg)
    jck.save(str(tmp_path / "ref"), 3, _jax_tree(tree), cfg=jcfg)
    mp, mr = (json.loads((tmp_path / d / "step_00000003" /
                          "manifest.json").read_text())
              for d in ("port", "ref"))
    assert mp == mr
    assert mp["index"]["[0]['nested']['h']"]["dtype"] == "bfloat16"
    assert mp["index"]["[1]['step']"] == {"shard": 0, "key": "[1]['step']",
                                          "shape": [], "dtype": "int32"}

    # the port restores the reference's checkpoint
    like = tree_map(torch.zeros_like, tree)
    got, step = ck.restore(str(tmp_path / "ref"), like, cfg=cfg)
    assert step == 3 and _equal(got, tree)

    # the reference restores the port's
    jgot, step = jck.restore(str(tmp_path / "port"), _jax_tree(tree),
                             cfg=jcfg)
    assert step == 3
    for (path, want), arr in zip(leaves(tree), jax.tree.leaves(jgot)):
        if want.dtype == torch.bfloat16:
            assert arr.dtype == np.dtype("V2"), path
            assert np.array_equal(arr.view(np.int16),
                                  want.view(torch.int16).numpy()), path
        else:
            assert np.array_equal(arr, want.numpy()), path


@pytest.mark.parametrize("arch", list_archs())
def test_config_hash_is_the_references(arch):
    for t, j in ((get_config(arch), jax_get_config(arch)),
                 (get_config(arch).reduced(), jax_get_config(arch).reduced())):
        assert repr(t) == repr(j)
        assert ck.config_hash(t) == jck.config_hash(j)


KW = dict(reduced=True, batch=2, seq=64, device="cpu", verbose=False)


def test_train_restart_after_failure(tmp_path):
    """Injected preemption: training restores the last committed
    checkpoint and repeats the steps after it, to the same losses."""
    plain = train("llama3.2-3b", steps=6, **KW)
    r = train("llama3.2-3b", steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
              fail_at=5, **KW)
    assert r["restarts"] == 1
    assert r["losses"] == plain["losses"][:5] + plain["losses"][4:]
    assert np.isfinite(r["final_loss"])


def test_train_cold_restart_without_checkpoint():
    plain = train("mamba2-130m", steps=3, **KW)
    r = train("mamba2-130m", steps=3, fail_at=2, **KW)
    assert r["restarts"] == 1
    assert r["losses"] == plain["losses"][:2] + plain["losses"]


def test_train_resume_continues_from_checkpoint(tmp_path):
    full = train("mamba2-130m", steps=6, **KW)
    train("mamba2-130m", steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
          **KW)
    assert ck.latest_step(str(tmp_path)) == 4
    r = train("mamba2-130m", steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
              resume="auto", **KW)
    assert r["losses"] == full["losses"][4:]


def test_gradient_compression_training_converges():
    r_plain = train("llama3.2-3b", steps=10, **KW)
    r_comp = train("llama3.2-3b", steps=10, compress_grads=True, **KW)
    # int8 + error feedback stays close to uncompressed training
    assert abs(r_comp["final_loss"] - r_plain["final_loss"]) < 0.2


def test_microbatch_accumulation_matches():
    r1 = train("llama3.2-3b", steps=6, **dict(KW, batch=4), microbatch=1)
    r2 = train("llama3.2-3b", steps=6, **dict(KW, batch=4), microbatch=2)
    assert abs(r1["final_loss"] - r2["final_loss"]) < 0.1


def test_repeated_batch_loss_falls():
    r = train("llama3.2-3b", steps=4, repeat_batch=True, **KW)
    assert r["losses"][-1] < r["losses"][0] - 0.05
    assert "step_s" not in r          # host timings are the card's only
