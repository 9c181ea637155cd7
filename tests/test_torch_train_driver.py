"""The port's training driver (``repro_torch.launch.train``) on the CPU:
it trains, checkpoints, crashes at the injected step and resumes from the
newest checkpoint, as ``tests/test_system.py::test_train_driver_resume``
holds the reference's; ``get_api`` serves every family.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import train
from repro_torch.models import get_api, nequip, recsys, transformer
from repro_torch._tree import tree_leaves
from repro_torch.train import (AdamWConfig, CheckpointManager, adamw_init,
                               compress_init)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run(args, tmp):
    # one thread: the smoke config's ops are tiny, and more threads only
    # contend with the other test processes
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "stablelm-1.6b", "--steps", "30", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(tmp), "--ckpt-every", "10",
         "--log-every", "10", *args], env=env, capture_output=True,
        text=True, timeout=600)


def test_train_driver_resume(tmp_path):
    """Runs, checkpoints, crashes on injection, resumes from step 20; the
    resumed run ends where an uninterrupted run ends, bit for bit."""
    r = _run(["--fail-at-step", "25"], tmp_path / "a")
    assert r.returncode != 0 and "injected failure" in r.stderr
    mgr = CheckpointManager(str(tmp_path / "a"))
    assert mgr.all_steps() == [10, 20]
    r2 = _run(["--resume"], tmp_path / "a")
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "resumed from step 20" in r2.stdout
    assert "first-10 mean loss" in r2.stdout and "device=cpu" in r2.stdout
    r3 = _run([], tmp_path / "b")
    assert r3.returncode == 0, r3.stdout + r3.stderr
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == \
        CheckpointManager(str(tmp_path / "b")).all_steps() == [10, 20, 29]
    a = np.load(tmp_path / "a" / "ckpt_0000000029" / "state.npz")
    b = np.load(tmp_path / "b" / "ckpt_0000000029" / "state.npz")
    assert sorted(a.files) == sorted(b.files)
    assert "['opt']['m']['layers']['wq']" in a.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_driver_restores_the_saved_state(tmp_path):
    """The trainer's checkpoint restores, through the manager, into the
    state tree it trains: every leaf equal to the npz, bf16 included."""
    r = _run(["--steps", "11", "--ckpt-every", "10"], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    cfg = get_smoke_config("stablelm-1.6b")
    params = transformer.init_params(cfg, device="cpu")
    like = {"params": params, "opt": adamw_init(params),
            "ef": compress_init(params)}
    state, meta = CheckpointManager(str(tmp_path)).restore(like, step=10)
    assert meta["step"] == 10
    with np.load(tmp_path / "ckpt_0000000010" / "state.npz") as npz:
        w = state["params"]["layers"]["wq"]
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            w.float().numpy(), npz["['params']['layers']['wq']"])
        assert int(state["opt"]["step"]) == int(npz["['opt']['step']"]) == 11
        assert not torch.equal(w, params["layers"]["wq"])


@pytest.mark.parametrize("arch", ["wide-deep", "sasrec"])
def test_train_driver_recsys_with_compression(arch, tmp_path, capsys):
    """The recsys family through the trainer, in process, with top-k and
    int8 error feedback: finite losses, a checkpoint at the last step."""
    for scheme in ("topk", "int8"):
        d = tmp_path / scheme
        train.main(["--device", "cpu", "--arch", arch, "--steps", "3",
                    "--batch", "8", "--ckpt-dir", str(d), "--compress",
                    scheme, "--log-every", "1"])
        out = capsys.readouterr().out
        assert "family=recsys" in out and "step     2 loss=" in out
        assert "nan" not in out.lower()
        assert CheckpointManager(str(d)).all_steps() == [2]


def test_train_driver_on_cuda_raises_without_a_card(monkeypatch, tmp_path):
    """``--device cuda`` (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("arch,family", [
    ("yi-9b", "lm"), ("granite-moe-3b-a800m", "lm"), ("deepseek-moe-16b", "lm"),
    ("nequip", "gnn"), ("dien", "recsys")])
def test_get_api_families(arch, family):
    api = get_api(get_smoke_config(arch))
    assert api.family == family and api.opt_cfg == AdamWConfig()
    mod = {"lm": transformer, "gnn": nequip, "recsys": recsys}[family]
    gen = torch.Generator().manual_seed(3)
    p = api.init_params(gen, device="cpu")
    assert p.keys() == mod.param_spec(api.config).keys()
    q = api.init_params(seed=3, device="cpu")
    for (_, a), (_, b) in zip(tree_leaves(p), tree_leaves(q)):
        assert torch.equal(a, b)
    if family == "lm":
        assert p["embed"].dtype == torch.bfloat16
        assert ("dense_layers" in p) == (arch == "deepseek-moe-16b")
        assert ("router" in p["layers"]) == api.config.moe


def test_get_api_refuses_other_configs():
    with pytest.raises(TypeError):
        get_api(object())
