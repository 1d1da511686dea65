"""The port's token pipeline, checkpoints, training loop and launcher,
on the CPU.

- ``TokenStream`` batches bit for bit equal to the reference's for several
  seeds, steps and shard layouts (the union of the shards is the
  single-host stream), placed on the stream's device as int32.
- Checkpoints: a round trip of a train state (float32, bfloat16 and int8
  leaves, bfloat16 bit for bit), the reference's layout (``step_XXXXXXXXX``
  with ``manifest.json`` and ``arr_XXXXX.npy``, a ``.done`` marker),
  keep-N garbage collection, uncommitted steps ignored, leaf-count and
  shape mismatches rejected, and a checkpoint written by the reference
  read by the port.
- The loop: a run stopped at step 4 (SIGTERM's path: the loop checkpoints
  and stops) and resumed to step 8 equals a straight 8-step run bit for
  bit (parameters, optimizer state, losses); the straggler watermark.
- ``python -m repro_torch.launch.train --smoke --device cpu --steps 3``
  prints the reference's ``[train] done`` line; in one process
  ``--model-par 2`` fails on the reference's assertion that the model
  axis divides the ranks (``launch.mesh.make_host_mesh``).
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.data import pipeline as jdata
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.launch import train as launch_train
from repro_torch.models.model import LM
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# TokenStream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,steps,n_shards", [
    (0, (0, 1, 7), 1), (3, (0, 250), 2), (11, (5, 6), 4)])
def test_token_stream_equals_reference(seed, steps, n_shards):
    kw = dict(vocab=512, seq_len=96, global_batch=8, seed=seed,
              n_shards=n_shards)
    for step in steps:
        rows = []
        for shard in range(n_shards):
            t = TokenStream(DataConfig(**kw, shard_id=shard), device="cpu")
            j = jdata.TokenStream(jdata.DataConfig(**kw, shard_id=shard))
            got, want = t.batch_at(step), j.batch_at(step)
            for key in ("tokens", "labels"):
                assert got[key].dtype == torch.int32
                np.testing.assert_array_equal(got[key].numpy(), want[key])
            rows.append(got["tokens"])
        whole = TokenStream(DataConfig(**{**kw, "n_shards": 1}),
                            device="cpu").batch_at(step)["tokens"]
        assert torch.equal(torch.cat(rows), whole)


def test_token_stream_cursor_and_iteration():
    cfg = DataConfig(vocab=300, seq_len=40, global_batch=2, seed=5)
    s = TokenStream(cfg, device="cpu")
    first = [next(s) for _ in range(3)]
    assert s.cursor() == {"step": 3}
    r = TokenStream.from_cursor(cfg, {"step": 1}, device="cpu")
    assert torch.equal(next(r)["tokens"], first[1]["tokens"])
    assert bool((first[0]["labels"][:, -1] == -1).all())


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"embed": torch.randn(6, 4, generator=g).bfloat16(),
                       "norm": torch.randn(4, generator=g)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32),
                    "m": {"embed": {"q": torch.randint(
                        -127, 128, (6, 4), generator=g).to(torch.int8),
                        "s": torch.rand(6, generator=g)},
                        "norm": torch.randn(4, generator=g)}}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def test_checkpoint_round_trip_and_layout(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 7, tree, extras={"cursor": {"step": 7}})
    assert os.path.basename(path) == "step_000000007"
    assert (tmp_path / "step_000000007.done").exists()
    man = json.loads((tmp_path / "step_000000007" / "manifest.json")
                     .read_text())
    assert man["step"] == 7 and man["n_leaves"] == 6
    assert man["extras"] == {"cursor": {"step": 7}}
    assert "['params']['embed']" in man["paths"]
    dtypes = dict(zip(man["paths"], (leaf["dtype"] for leaf in
                                     man["leaves"])))
    assert dtypes["['params']['embed']"] == "bfloat16"
    assert dtypes["['opt']['m']['embed']['q']"] == "int8"
    assert sorted(os.listdir(tmp_path / "step_000000007")) == [
        "arr_0000%d.npy" % i for i in range(6)] + ["manifest.json"]
    back, step, extras = ckpt.restore(str(tmp_path), tree)
    assert step == 7 and extras["cursor"] == {"step": 7}
    assert list(back) == list(tree)
    for a, b in zip(_leaves(back), _leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keep_n_and_uncommitted_steps(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.committed_steps(str(tmp_path)) == [3, 4]
    assert not (tmp_path / "step_000000001").exists()
    # A step without its marker (a crash mid-save) is ignored.
    os.makedirs(tmp_path / "step_000000009")
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.restore(str(tmp_path), tree)[1] == 4
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), tree)


def test_checkpoint_rejects_mismatches(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 1, tree)
    bad = _tree()
    bad["params"]["norm"] = torch.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), bad)
    fewer = _tree()
    del fewer["params"]["norm"]
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), fewer)


def test_reads_the_reference_checkpoint(tmp_path):
    """A float32 tree written by ``repro.ckpt.checkpoint`` (the same
    layout, dict keys in sorted order) restores into the port's tree."""
    rng = np.random.default_rng(0)
    tree = {"b": rng.standard_normal(3).astype(np.float32),
            "a": {"x": rng.standard_normal((2, 2)).astype(np.float32),
                  "step": np.int32(5)}}
    jckpt.save(str(tmp_path), 2, tree, extras={"cursor": {"step": 2}})
    like = {"b": torch.zeros(3), "a": {"x": torch.zeros(2, 2),
                                       "step": torch.tensor(0)}}
    back, step, extras = ckpt.restore(str(tmp_path), like)
    assert step == 2 and extras == {"cursor": {"step": 2}}
    np.testing.assert_array_equal(back["b"].numpy(), tree["b"])
    np.testing.assert_array_equal(back["a"]["x"].numpy(), tree["a"]["x"])
    assert int(back["a"]["step"]) == 5


# ---------------------------------------------------------------------------
# The loop and the launcher
# ---------------------------------------------------------------------------

def _setup(ckpt_dir, total, stop_at=None):
    cfg = get_config("smollm-360m").reduced(n_layers=2)
    model = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    ocfg = topt.OptConfig(lr=3e-3, warmup_steps=2, total_steps=total)
    state = tstep.init_state(model, ocfg)
    step = tstep.build_train_step(model, ocfg)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4), device="cpu")
    lines = []

    def log(line):
        lines.append(line)
        if stop_at is not None and line.startswith(f"[loop] step {stop_at} "):
            # The handler the loop installed, called as SIGTERM would.
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    lc = tloop.LoopConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                          ckpt_every=100, log_every=1)
    return lc, state, step, stream, log, lines


def test_stopped_and_resumed_run_equals_a_straight_run(tmp_path):
    lc, state, step, stream, log, _ = _setup(tmp_path / "a", 8)
    straight, ls = tloop.run(lc, state=state, train_step=step, stream=stream,
                             log=log)
    assert ls.step == 8 and ls.n_stragglers >= 0 and ls.watermark_s > 0
    lc, state, step, stream, log, lines = _setup(tmp_path / "b", 8, 4)
    _, ls1 = tloop.run(lc, state=state, train_step=step, stream=stream,
                       log=log)
    assert ls1.preempted and ls1.step == 4
    assert ckpt.committed_steps(str(tmp_path / "b")) == [4]
    lc, state, step, stream, log, lines = _setup(tmp_path / "b", 8)
    resumed, ls2 = tloop.run(lc, state=state, train_step=step,
                             stream=stream, log=log)
    assert lines[0] == "[loop] resumed from step 4"
    assert stream.step == 8 and ls2.step == 8
    assert [h[1] for h in ls1.history + ls2.history] == \
        [h[1] for h in ls.history]
    for a, b in zip(_leaves(resumed), _leaves(straight)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launcher_prints_the_done_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3", "--ckpt-dir",
         str(tmp_path / "ck")], capture_output=True, text=True, env=env,
        timeout=300, check=True).stdout
    assert "[train] done: step 3, loss " in out
    assert ckpt.committed_steps(str(tmp_path / "ck")) == [3]


def test_launcher_refuses_model_parallelism(tmp_path):
    with pytest.raises(AssertionError):
        launch_train.main(["--smoke", "--device", "cpu", "--model-par", "2",
                           "--ckpt-dir", str(tmp_path)])
    assert ckpt.committed_steps(str(tmp_path)) == []
