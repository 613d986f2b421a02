"""``--shard-clients`` of the experiment CLI (ROADMAP A-10b) on the CPU.

Two gloo ranks (``tests/torch_dist.py``) run ``launch.experiments`` with
``--shard-clients`` at N = 8, 4 rounds, on the smoke CNN, each rank with 4
of the clients; rank 0's JSON must equal the unsharded CLI's in every
entry but the wall time (``elapsed_s``): accuracies, energies,
participation and the protocol's K and eco parameters, bit for bit
(C-17: the aggregates and norms sum in float64, so the client split does
not change a bit). Both ranks return the same results.
"""
import json

import numpy as np

from repro_torch.configs.fmnist_cnn import SMOKE as T_SMOKE
from repro_torch.launch import experiments as tex

from torch_dist import experiments_cli_body, spawn

from test_torch_train import one_torch_thread  # noqa: F401

ARGV = ["--device", "cpu", "--clients", "8", "--rounds", "4"]


def _load(path) -> dict:
    res = json.loads(path.read_text())
    res.pop("elapsed_s")
    return res


def test_sharded_cli_json_equals_the_unsharded(tmp_path, monkeypatch):
    monkeypatch.setattr(tex, "CNN_FULL", T_SMOKE)
    plain = tmp_path / "plain.json"
    tex.cli(ARGV + ["--out", str(plain)])
    shard = tmp_path / "sharded.json"
    ranks = spawn(experiments_cli_body, 2, tmp_path,
                  ARGV + ["--out", str(shard)], str(tmp_path), timeout=240.0)
    assert _load(shard) == _load(plain)
    np.testing.assert_array_equal(ranks[0]["energy"], ranks[1]["energy"])
    assert int(ranks[0]["k"]) == int(ranks[1]["k"]) == _load(plain)["k"]
