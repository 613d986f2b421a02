"""Checkpoints (``repro_torch.checkpoint`` and the trainer's
``save_checkpoint``/``restore_checkpoint``/``run_scanned(start_round=,
ckpt_dir=)``) against the JAX package.

The port's copies of ``tests/test_checkpoint.py``'s cases (round trip,
bit flips, truncation, a payload CRC mismatch, a missing leaf and a shape
drift, ``latest_checkpoint`` skipping corrupt files, a file without the
integrity record); the leaf keys against ``jax.tree_util``'s paths on
trees of dicts, ``NamedTuple``s, lists and empty states, in both
directions; a restored trainer continuing its own run bit for bit (sync,
timed with the staleness buffer, and with faults and the defense state)
and the main golden; and the two packages' checkpoints crossing over: a
checkpoint the reference writes restores in the port and continues as
the reference's own continuation does, and the reverse.

Gates across the packages: masks, ``made``, late, stale and fault counts
exactly equal; energies and ``t_round`` rtol 1e-4; accuracy within 1/128.
"""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.core import faults as jf
from repro.core.rounds import AsyncConfig as JAsync

from repro_torch import checkpoint as tck
from repro_torch.core import faults as tf
from repro_torch.core.rounds import AsyncConfig

from test_torch_rounds import assert_timed_equal
from test_torch_trainer import N_CLIENTS, ROUNDS, _mlp_data
from torch_dist import mlp_trainer

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def tree():
    rng = np.random.default_rng(0)
    return {"params": {"w1": torch.tensor(rng.normal(size=(8, 4)).astype(np.float32)),
                       "w2": torch.tensor(rng.normal(size=(4,)).astype(np.float32))},
            "battery": torch.tensor(rng.uniform(0, 1, 6).astype(np.float32)),
            "step": torch.tensor(7, dtype=torch.int32),
            "flags": torch.tensor([True, False, True])}


def _flip_bit(path, offset_frac=0.5):
    raw = bytearray(open(path, "rb").read())
    raw[int(len(raw) * offset_frac)] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def _assert_tree_equal(a, b):
    for (pa, la), (pb, lb) in zip(tck.leaf_paths(a), tck.leaf_paths(b)):
        assert pa == pb
        assert isinstance(lb, torch.Tensor) and la.dtype == lb.dtype
        assert torch.equal(la, lb), pa


# ------------------------------------------------------ the file format ----
def test_roundtrip_and_verify(tmp_path, tree):
    p = tck.save_checkpoint(str(tmp_path), 3, tree, {"next_round": 3})
    assert p.endswith("ckpt_00000003.npz")
    assert tck.verify_checkpoint(p)
    _assert_tree_equal(tree, tck.restore_checkpoint(p, tree))
    assert tck.load_metadata(p) == {"next_round": 3}


@pytest.mark.parametrize("frac", [0.3, 0.5, 0.8])
def test_bit_flip_detected(tmp_path, tree, frac):
    p = tck.save_checkpoint(str(tmp_path), 1, tree)
    _flip_bit(p, frac)
    assert not tck.verify_checkpoint(p)
    with pytest.raises(tck.CheckpointError):
        tck.restore_checkpoint(p, tree)


def test_truncated_file_detected(tmp_path, tree):
    p = tck.save_checkpoint(str(tmp_path), 1, tree)
    size = os.path.getsize(p)
    pristine = open(p, "rb").read()
    for keep in (100, size // 2, size - 10):
        open(p, "wb").write(pristine[:keep])
        assert not tck.verify_checkpoint(p)
        with pytest.raises(tck.CheckpointError):
            tck.restore_checkpoint(p, tree)


def test_payload_crc_catches_uncompressed_flip(tmp_path, tree):
    p = tck.save_checkpoint(str(tmp_path), 1, tree)
    with np.load(p, allow_pickle=False) as d:
        entries = {k: d[k] for k in d.files}
    arr = np.array(entries["battery"])
    arr[0] += 1.0
    np.savez(p, **dict(entries, battery=arr))
    assert not tck.verify_checkpoint(p)
    with pytest.raises(tck.CheckpointError, match="CRC-32|battery"):
        tck.restore_checkpoint(p, tree)


def test_missing_leaf_and_shape_mismatch(tmp_path, tree):
    p = tck.save_checkpoint(str(tmp_path), 1, tree)
    with np.load(p, allow_pickle=False) as d:
        entries = {k: d[k] for k in d.files}
    np.savez(p, **{k: v for k, v in entries.items() if "battery" not in k})
    with pytest.raises(tck.CheckpointError, match="battery"):
        tck.restore_checkpoint(p, tree)
    p2 = tck.save_checkpoint(str(tmp_path / "b"), 1, tree)
    with pytest.raises(tck.CheckpointError, match="shape"):
        tck.restore_checkpoint(p2, dict(tree, battery=torch.zeros(9)))


def test_latest_checkpoint_skips_corrupt(tmp_path, tree):
    p1 = tck.save_checkpoint(str(tmp_path), 1, tree)
    p2 = tck.save_checkpoint(str(tmp_path), 2, tree)
    p3 = tck.save_checkpoint(str(tmp_path), 3, tree)
    _flip_bit(p3)
    open(p2, "wb").write(b"not a zip at all")
    with pytest.warns(UserWarning, match="corrupt"):
        assert tck.latest_checkpoint(str(tmp_path)) == p1
    _flip_bit(p1)
    with pytest.warns(UserWarning):
        assert tck.latest_checkpoint(str(tmp_path)) is None
    assert tck.latest_checkpoint(str(tmp_path / "absent")) is None


def test_legacy_checkpoint_without_record_loads(tmp_path, tree):
    arrays = {"/".join(str(p) for p in path): leaf.numpy()
              for path, leaf in tck.leaf_paths(tree)}
    p = os.path.join(str(tmp_path), "ckpt_00000005.npz")
    np.savez(p, __meta__=json.dumps({"next_round": 5}), **arrays)
    assert tck.verify_checkpoint(p)
    _assert_tree_equal(tree, tck.restore_checkpoint(p, tree))
    assert tck.latest_checkpoint(str(tmp_path)) == p


# ------------------------------------------------------------- leaf keys ----
class _Inner(NamedTuple):
    eta: object
    rho: object


class _State(NamedTuple):
    lam: object
    params: _Inner
    e_cmp: object


def _trees(leaf):
    """The same structure with ``leaf(v)`` leaves, and the port's and the
    reference's spelling of an empty state (None, ())."""
    state = _State(lam=leaf(1.0), params=_Inner(eta=leaf([2.0, 3.0]),
                                                rho=leaf(4.0)), e_cmp=leaf([5.0]))
    body = {"params": {"conv0": {"w": leaf([[1.0]]), "b": leaf([0.5])},
                       "fc": {"w": leaf([1.5])}},
            "ctrl_state": state, "battery": leaf([9.0, 8.0]),
            "lst": [leaf(1.0), (leaf(2.0),)]}
    return body


def test_leaf_keys_are_the_reference_paths(tmp_path):
    j_tree = dict(_trees(lambda v: jnp.asarray(v, jnp.float32)),
                  astate=(), fstate=())
    t_tree = dict(_trees(lambda v: torch.tensor(v, dtype=torch.float32)),
                  astate=None, fstate=())
    flat, _ = jax.tree_util.tree_flatten_with_path(j_tree)
    j_keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
              for path, _ in flat]
    t_keys = ["/".join(str(p) for p in path) for path, _ in tck.leaf_paths(t_tree)]
    assert t_keys == j_keys
    assert "ctrl_state/.params/.eta" in t_keys and "lst/1/0" in t_keys
    # port -> reference
    pt = tck.save_checkpoint(str(tmp_path / "t"), 1, t_tree, {"next_round": 1})
    back = jck.restore_checkpoint(pt, j_tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(j_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # reference -> port
    pj = jck.save_checkpoint(str(tmp_path / "j"), 1, j_tree, {"next_round": 1})
    _assert_tree_equal(t_tree, tck.restore_checkpoint(pj, t_tree))
    assert tck.load_metadata(pj) == jck.load_metadata(pt) == {"next_round": 1}


# ----------------------------------------------------- trainer round trips ----
def _torch(**kw):
    return mlp_trainer(_mlp_data()[0], **kw)


CASES = {
    "sync": (dict(), dict()),
    "timed": (dict(device_profile="tiered",
                   async_cfg=AsyncConfig(deadline_q=0.5, staleness=True,
                                         harvest_j=2e-3)),
              dict(device_profile="tiered",
                   async_cfg=JAsync(deadline_q=0.5, staleness=True,
                                    harvest_j=2e-3))),
    "faults": (dict(fault_cfg=tf.FaultConfig(corrupt_rate=0.3, crash_rate=0.1,
                                             churn_dwell=3),
                    defense=tf.DefenseConfig()),
               dict(fault_cfg=jf.FaultConfig(corrupt_rate=0.3, crash_rate=0.1,
                                             churn_dwell=3),
                    defense=jf.DefenseConfig())),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_restore_continues_bitwise(tmp_path, case):
    """A fresh trainer restored from the round-8 checkpoint continues the
    run bit for bit: masks, energies, wall clock, fault counts, params."""
    kw = CASES[case][0]
    a = _torch(**kw)
    a.run_scanned(ROUNDS, chunk=4, ckpt_dir=str(tmp_path), ckpt_every=1,
                  verbose=False)
    mid = os.path.join(str(tmp_path), "ckpt_00000008.npz")
    assert tck.verify_checkpoint(mid)
    assert tck.latest_checkpoint(str(tmp_path)).endswith("ckpt_00000012.npz")
    assert sorted(os.listdir(tmp_path)) == [
        f"ckpt_{r:08d}.npz" for r in (4, 8, 12)]
    b = _torch(**kw)
    assert b.restore_checkpoint(mid) == 8
    b.run_scanned(ROUNDS, chunk=4, start_round=8, verbose=False)
    assert [lg.round for lg in b.history] == list(range(8, ROUNDS))
    for la, lb in zip(a.history[8:], b.history):
        for k in ("selected", "gamma", "energy", "battery"):
            np.testing.assert_array_equal(getattr(la, k), getattr(lb, k))
        assert (la.accuracy, la.t_round, la.n_stale, la.n_faulted,
                la.clip_frac) == (lb.accuracy, lb.t_round, lb.n_stale,
                                  lb.n_faulted, lb.clip_frac)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_restored_run_continues_the_main_golden(tmp_path):
    g = json.load(open(os.path.join(GOLDEN_DIR,
                                    "fairenergy_main_12round.json")))
    a = _torch()
    a.run_scanned(ROUNDS, chunk=4, ckpt_dir=str(tmp_path), verbose=False)
    b = _torch()
    nxt = b.restore_checkpoint(os.path.join(str(tmp_path), "ckpt_00000004.npz"))
    b.run_scanned(ROUNDS, chunk=4, start_round=nxt, verbose=False)
    assert b._calibrated
    for lg, la in zip(b.history, a.history[4:]):
        r = lg.round
        np.testing.assert_array_equal(lg.selected.astype(int), g["selected"][r])
        np.testing.assert_allclose(lg.energy, g["energy"][r], rtol=1e-4)
        assert lg.accuracy == g["accuracy"][r] == la.accuracy
        np.testing.assert_array_equal(lg.energy, la.energy)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each case's reference run over 12 rounds, a checkpoint every chunk
    of 4 rounds in its own directory."""
    from test_scan_engine import make_trainer
    runs = {}
    with jax.threefry_partitionable(False):
        for case, (_, jkw) in CASES.items():
            d = str(tmp_path_factory.mktemp(f"jax_{case}"))
            tr = make_trainer("fairenergy", **jkw)
            tr.run_scanned(ROUNDS, chunk=4, ckpt_dir=d, verbose=False)
            runs[case] = (tr, d)
    return runs


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_checkpoint_restores_in_the_port(jax_runs, case):
    """The port restores the reference's round-4 checkpoint and continues
    as the reference's own run does."""
    jtr, d = jax_runs[case]
    t = _torch(**CASES[case][0])
    assert t.restore_checkpoint(os.path.join(d, "ckpt_00000004.npz")) == 4
    t.run_scanned(ROUNDS, start_round=4, verbose=False)
    assert_timed_equal(t.history, jtr.history[4:], f"{case} from the reference")


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_restores_in_the_reference(jax_runs, tmp_path, case):
    """The reference restores the port's round-4 checkpoint and continues
    as its own uninterrupted run does."""
    from test_scan_engine import make_trainer
    tkw, jkw = CASES[case]
    t = _torch(**tkw)
    t.run_scanned(4, ckpt_dir=str(tmp_path), verbose=False)
    path = os.path.join(str(tmp_path), "ckpt_00000004.npz")
    meta = jck.load_metadata(path)
    assert meta["next_round"] == 4 and meta["controller"] == "fairenergy"
    with jax.threefry_partitionable(False):
        j = make_trainer("fairenergy", **jkw)
        assert j.restore_checkpoint(path) == 4
        j.run_scanned(ROUNDS, start_round=4, verbose=False)
    jtr, _ = jax_runs[case]
    assert_timed_equal(j.history, jtr.history[4:], f"{case} from the port")


def test_sharded_checkpoint_resumes_and_restores_unsharded(tmp_path):
    """The timed trainer on 2 gloo ranks checkpoints its whole stale
    buffer (gathered; the mesh's first rank writes the file), a fresh
    mesh trainer resumes from it bit for bit, and an unsharded trainer
    restores the same file and continues as the unsharded run does."""
    from torch_dist import checkpoint_body, history_arrays, spawn
    kw = CASES["timed"][0]
    d = str(tmp_path / "ckpt")
    ranks = spawn(checkpoint_body, 2, tmp_path, _mlp_data()[0], kw, d,
                  str(tmp_path))
    base = _torch(**kw)
    base.run_scanned(ROUNDS, verbose=False)
    want = history_arrays(base)
    for got in ranks:
        for k in ("selected", "made", "n_stale", "energy", "t_round"):
            np.testing.assert_array_equal(got[f"resumed.{k}"],
                                          got[f"full.{k}"][8:], err_msg=k)
            np.testing.assert_allclose(got[f"full.{k}"], want[k], rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_array_equal(got["resumed.params"],
                                      got["full.params"])
    c = _torch(**kw)
    assert c.restore_checkpoint(os.path.join(d, "ckpt_00000008.npz")) == 8
    assert c.carry.astate.buf.shape[0] == N_CLIENTS
    c.run_scanned(ROUNDS, start_round=8, verbose=False)
    for la, lc in zip(base.history[8:], c.history):
        np.testing.assert_array_equal(la.selected, lc.selected)
        np.testing.assert_array_equal(la.made, lc.made)
        np.testing.assert_allclose(la.energy, lc.energy, rtol=1e-5)


def test_run_scanned_rejects_bad_resume_args():
    tr = _torch()
    with pytest.raises(ValueError, match="start_round"):
        tr.run_scanned(ROUNDS, start_round=ROUNDS)
    with pytest.raises(ValueError, match="start_round"):
        tr.run_scanned(ROUNDS, start_round=-1)
    with pytest.raises(ValueError, match="ckpt_every"):
        tr.run_scanned(ROUNDS, ckpt_every=0)
