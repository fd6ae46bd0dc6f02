"""The port's baseline CLIs and package dispatcher against the reference's
(``python -m sgcn_tpu_torch.baselines`` / ``python -m sgcn_tpu_torch`` vs
``python -m sgcn_tpu.baselines`` / ``python -m sgcn_tpu``), through their
``main()`` with ``sys.argv``, on the CPU (``--device cpu``; the
reference's ``-b cpu``), on a small graph made by the port's prep CLI.

The two packages draw their initial weights from different generators,
so the oracle's losses are compared with a float64 numpy run of the same
SGD-with-momentum steps from the port's weights; the broadcast CLI's
rows are not printed, its report is compared key by key.
"""

import json
import sys

import numpy as np
import pytest
import torch

from sgcn_tpu import __main__ as ref_dispatch
from sgcn_tpu.baselines.__main__ import main as ref_baselines_main
from sgcn_tpu_torch import __main__ as dispatch
from sgcn_tpu_torch.baselines.__main__ import main as baselines_main
from sgcn_tpu_torch.io.datasets import er_graph
from sgcn_tpu_torch.io.mtx import (read_dense_features, read_mtx,
                                   read_onehot_labels, write_mtx)
from sgcn_tpu_torch.models.gcn import init_gcn_params
from sgcn_tpu_torch.prep.__main__ import main as prep_main

N, EPOCHS = 300, 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("baselines")
    write_mtx(str(d / "g.mtx"), er_graph(N, avg_deg=6, seed=2))
    prep_main(["-a", str(d / "g.mtx"), "-o", str(d), "-n", "g", "-l", "2",
               "-f", "8", "-c", "3"])
    return d


def _run(main, argv, capsys, monkeypatch, prog):
    monkeypatch.setattr(sys, "argv", [prog] + argv)
    main()
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def _oracle_argv(d):
    return ["oracle", "-a", str(d / "g.A.mtx"), "-f", str(d / "g.H.mtx"),
            "-y", str(d / "g.Y.mtx"), "-c", str(d / "config"),
            "--epochs", str(EPOCHS), "--lr", "0.5"]


def test_oracle_cli(files, capsys, monkeypatch):
    """The oracle's JSON line has the reference's keys; its per-epoch
    losses (stderr) equal, within rtol 1e-5, a float64 numpy run of the
    same steps (sigmoid between layers, softmax cross-entropy, SGD with
    momentum 0.9) from the port's seed-0 weights."""
    got, err = _run(baselines_main, _oracle_argv(files) + ["--device",
                                                          "cpu"],
                    capsys, monkeypatch, "baselines")
    want, _ = _run(ref_baselines_main, _oracle_argv(files) + ["-b", "cpu"],
                   capsys, monkeypatch, "baselines")
    assert set(got) == set(want)
    assert got["baseline"] == "oracle" and got["epochs"] == EPOCHS
    assert got["process_time_s"] > 0
    losses = [float(line.split()[-1]) for line in err.splitlines()
              if line.startswith("epoch ")]
    assert len(losses) == EPOCHS and losses[-1] == pytest.approx(
        got["final_loss"], abs=1e-6)
    a = read_mtx(str(files / "g.A.mtx")).astype(np.float64)
    x = read_dense_features(str(files / "g.H.mtx")).astype(np.float64)
    y = read_onehot_labels(str(files / "g.Y.mtx"))
    ws = [w.numpy().astype(np.float64) for w in init_gcn_params(
        torch.Generator().manual_seed(0), [(1, 8), (8, 3)])]
    bufs = [np.zeros_like(w) for w in ws]
    want_losses = []
    for _ in range(EPOCHS):
        z0 = (a @ x) @ ws[0]
        h1 = 1 / (1 + np.exp(-z0))
        z1 = (a @ h1) @ ws[1]
        p = np.exp(z1 - z1.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        want_losses.append(-np.mean(np.log(p[np.arange(N), y])))
        g1 = p.copy()
        g1[np.arange(N), y] -= 1
        g1 /= N
        grads = [None, (a @ h1).T @ g1]
        gz0 = (a.T @ (g1 @ ws[1].T)) * h1 * (1 - h1)
        grads[0] = (a @ x).T @ gz0
        for i in range(2):
            bufs[i] = 0.9 * bufs[i] + grads[i]
            ws[i] = ws[i] - 0.5 * bufs[i]
    print(f"oracle losses {losses} vs float64 {want_losses}")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)


def test_cagnet_cli(files, capsys, monkeypatch):
    """The broadcast CLI's report: the reference's keys, the same epochs,
    phase counts and wire volume ``(k−1)·n``; ``backend`` names the
    device."""
    argv = ["cagnet", "-a", str(files / "g.A.mtx"), "-c",
            str(files / "config"), "-s", "4", "--epochs", "2"]
    got, _ = _run(baselines_main, argv + ["--device", "cpu"], capsys,
                  monkeypatch, "baselines")
    want, _ = _run(ref_baselines_main, argv + ["-b", "cpu"], capsys,
                   monkeypatch, "baselines")
    assert set(got) == set(want)
    assert got["baseline"] == want["baseline"] == "cagnet1d"
    assert got["backend"] == "cpu"
    for key in ("epochs", "send_volume_per_exchange"):
        assert got[key] == want[key]
    assert got["send_volume_per_exchange"] == 3 * N
    assert {k: v["count"] for k, v in got["phases"].items()} == \
        {k: v["count"] for k, v in want["phases"].items()}
    monkeypatch.setattr(sys, "argv", ["baselines"] + argv + ["--epochs",
                                                             "0"])
    with pytest.raises(SystemExit, match="epochs"):
        baselines_main()


def test_default_device_is_the_card(files, monkeypatch):
    """Without ``--device cpu`` the CLIs run on the card: here, without
    one, they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (_oracle_argv(files),
                 ["cagnet", "-a", str(files / "g.A.mtx"), "-s", "2"]):
        monkeypatch.setattr(sys, "argv", ["baselines"] + argv)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            baselines_main()


def test_dispatcher_prints_the_ports_map(capsys, monkeypatch):
    """``python -m sgcn_tpu_torch``: the port's tools (the reference's
    map, the static-analysis tool included) on stdout with exit code 0;
    stray arguments print the map on stderr and return 2, as the
    reference does."""
    monkeypatch.setattr(sys, "argv", ["sgcn_tpu_torch"])
    assert dispatch.main() == 0
    out = capsys.readouterr().out
    names = [m for m, _ in dispatch._TOOLS]
    assert names == [m.replace("sgcn_tpu", "sgcn_tpu_torch")
                     for m, _ in ref_dispatch._TOOLS]
    for m in names:
        assert f"python -m {m}" in out
    monkeypatch.setattr(sys, "argv", ["sgcn_tpu_torch", "train"])
    assert dispatch.main() == 2 == ref_dispatch.main()
    err = capsys.readouterr().err
    assert "unknown arguments ['train']" in err
    assert "python -m sgcn_tpu_torch.train" in err
