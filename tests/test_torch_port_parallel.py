"""Data parallelism of the port (``parallel/mesh.py``) against the JAX
mesh's global-batch semantics, on the CPU over gloo.

Ranks are real processes (``tests/torch_port_dp_worker.py``) that meet
at a free ``localhost`` port through the coordinator flags, each with a
timeout, as ``tests/test_parallel.py`` runs JAX's two processes. What
is held:

* rendezvous: rank, world size, ``is_main_process``, non-main prints
  silenced but for ``force=True``; ``shard_rows``; the trainer's metric
  means over sharded and replicated batches (a replicated batch counts
  once); the coordinator flags parse into JAX's config;
* the loader: over two epochs the ranks' shards of the odom, fg and bg
  train splits, concatenated, are the one-process batches bit for bit;
  a ragged val batch is replicated;
* one step of each model over 2 ranks against JAX's global-batch step:
  odom against JAX's step on the 8-device virtual mesh (``make_mesh``,
  ``shard_batch``) to rtol 1e-5 / atol 1e-6, as
  ``test_dp_gradients_match_single_device`` holds JAX; fg against the
  port's one-process step to rtol 1e-5 / atol 1e-6 of each gradient
  tensor's largest entry, and against JAX at the fg training tests'
  tolerances (``tests/test_torch_port_train_fg.py``); bg in float64 at
  crop 128, batch 2 (one sample a rank, one of them mostly ignore-255)
  at the bg training tests' tolerances
  (``tests/test_torch_port_train_bg.py``: gradients 1e-4 of each
  tensor's largest entry, BN statistics 1e-6, the loss rtol 1e-6),
  where per-rank BN statistics or the mean of per-rank loss means miss
  them. After the optimizer step every parameter is within
  lr·|Δg|/eps + 4 ulp of JAX's (Adam's first step is lr·g/(|g| + eps));
* ``cli.train`` on odom over 2 ranks for 2 epochs: only rank 0 writes,
  its ``metrics.jsonl`` and ``best_model`` within 1e-5 of a one-process
  run's, and a two-rank ``--continue_training`` resumes as the one
  process does;
* a batch size the world does not divide raises.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core import build_model as jax_build_model
from panoptic_forecasting_tpu.core.config import load_config as jax_load_config
from panoptic_forecasting_tpu.data.synthetic import write_fg_fixture as jax_write_fg_fixture
from panoptic_forecasting_tpu.data.synthetic import write_odom_fixture as jax_write_odom_fixture
from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
from panoptic_forecasting_tpu.models.hardnet import HarDNet as JaxHarDNet
from panoptic_forecasting_tpu.parallel.mesh import make_mesh, shard_batch
from panoptic_forecasting_tpu.train.optim import build_optimizer as jax_build_optimizer
from panoptic_forecasting_tpu_torch.cli import train as train_cli
from panoptic_forecasting_tpu_torch.core import build_dataset
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.core.config import load_config
from panoptic_forecasting_tpu_torch.data import synthetic
from panoptic_forecasting_tpu_torch.data.cards import DataCard
from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.models.convert import (
    bg_state_dict_from_jax, fg_state_dict_from_jax, odom_state_dict_from_jax,
)
from panoptic_forecasting_tpu_torch.parallel import mesh
from panoptic_forecasting_tpu_torch.train.loop import to_device, train

import torch_port_dp_worker as dp_worker
from test_torch_port_train_bg import CFG as BG_CFG, DEPTH_STATS, _bn_inputs, _random_batch
from test_torch_port_train_fg import fg_train_cfg

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_dp_worker.py")
CPU = torch.device("cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job, spec, tmp_path, world=2, timeout=300):
    """Run ``job`` of the worker on ``world`` ranks; -> (outputs, results)."""
    spec = dict(spec, addr=f"127.0.0.1:{_free_port()}", world=world)
    path = str(tmp_path / f"{job}_{len(os.listdir(tmp_path))}.spec")
    torch.save(spec, path)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, WORKER, job, path, str(r)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs, [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(world)]


# ---- rendezvous, config, loader ------------------------------------------------

def test_two_ranks_rendezvous_through_the_coordinator_flags(tmp_path):
    outs, (r0, r1) = run_ranks("rendezvous", {}, tmp_path)
    assert (r0["rank"], r0["world"], r0["main"]) == (0, 2, True)
    assert (r1["rank"], r1["world"], r1["main"]) == (1, 2, False)
    assert "RANK0 PLAIN" in outs[0] and "RANK0 FORCED" in outs[0]
    assert "RANK1 PLAIN" not in outs[1] and "RANK1 FORCED" in outs[1]
    assert (r0["rows"], r1["rows"]) == ([0, 1, 2], [3, 4, 5])
    assert r0["ragged"] == r1["ragged"] == [0, 1, 2, 3, 4]  # replicated
    # rows 1..4 (sharded) and 10, 20, 30 once (replicated): 7 samples
    for r in (r0, r1):
        assert r["vector_means"] == {"loss": (1 + 2 + 3 + 4 + 60) / 7}
        # one sharded scalar (shares 0.25 + 0.75) and one replicated: 2 batches
        assert r["scalar_means"] == {"loss": (1.0 + 4.0) / 2}


@pytest.mark.parametrize("extra", [
    [], ["--distributed"],
    ["--distributed", "--coordinator_address", "10.0.0.1:1234", "--num_processes", "4",
     "--process_id", "3", "--set", "platform", "cpu"],
])
def test_distributed_flags_parse_as_jax(extra, tmp_path):
    argv = ["--working_dir", str(tmp_path), "--seed", "3"] + extra
    assert dict(load_config(argv)) == dict(jax_load_config(argv))


def test_incomplete_coordinator_flags_raise(tmp_path):
    cfg = load_config(["--working_dir", str(tmp_path), "--distributed",
                       "--coordinator_address", "127.0.0.1:1", "--set", "platform", "cpu"])
    with pytest.raises(ValueError, match="all of"):
        mesh.init_distributed(cfg)


@pytest.fixture(scope="module")
def split_cfgs(tmp_path_factory):
    """{task: config of its train split on a small port fixture}."""
    root = tmp_path_factory.mktemp("splits")
    odom, fg = str(root / "odom"), str(root / "fg")
    synthetic.write_odom_fixture(odom, n_snippets=3)
    synthetic.write_fg_fixture(fg, n_scenes=3, max_instances=3, feat_channels=32, feat_hw=7)
    bg, _ = synthetic.write_bg_fixture(str(root / "bg"), n_snippets=3, height=64,
                                       width=128, gap_lens=(9, 3))
    training = {"batch_size": 4, "val_batch_size": 3, "steps_per_epoch": 3,
                "num_data_threads": 0}
    bg_cfg = {"task": "bg", "seed": 0, "working_dir": str(root / "bg_run"),
              "data": dict(bg, data_splits=["train", "val"], data_inp_size=3,
                           only_background=True, use_depths=True, crop_size=32,
                           scale_min=0.5, scale_max=2.0,
                           depth_norm_params_file=str(root / "bg_run" / "stats.npz")),
              "model": {"num_inputs": 3, "convert2onehot": True},
              "training": dict(training, batch_size=2, steps_per_epoch=None)}
    return {
        "odom": {"task": "odom", "seed": 0, "working_dir": str(root / "odom_run"),
                 "data": {"data_splits": ["train", "val"], "data_dir": odom},
                 "training": training},
        "fg": dict(fg_train_cfg(fg), training=training),
        "bg": bg_cfg,
    }


def _same(a, b, what):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _cat(a, b):
    if isinstance(a, dict):
        return {k: _cat(a[k], b[k]) for k in a}
    if isinstance(a, list):
        return a + b
    return np.concatenate([a, b])


def _epoch(data, cfg, split, epoch, monkeypatch, rank=None):
    """One epoch of the split's loader as rank ``rank`` of 2 (None: one
    process)."""
    if rank is not None:
        monkeypatch.setattr(mesh, "world_size", lambda: 2)
        monkeypatch.setattr(mesh, "rank", lambda: rank)
    loader = data.loader(split, cfg, seed=0, shard=rank is not None)
    loader.set_epoch(epoch)
    out = list(loader)
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("task", ["odom", "fg", "bg"])
def test_rank_shards_concatenate_to_the_one_process_batches(task, split_cfgs, monkeypatch):
    cfg = split_cfgs[task]
    data = build_dataset(cfg)
    for epoch in (1, 2):
        whole = _epoch(data, cfg, "train", epoch, monkeypatch)
        shards = [_epoch(data, cfg, "train", epoch, monkeypatch, r) for r in (0, 1)]
        assert len(whole) == len(shards[0]) == len(shards[1]) > 0
        for i, (b, s0, s1) in enumerate(zip(whole, *shards)):
            assert s0.pop("sharded") is True and s1.pop("sharded") is True
            _same(_cat(s0, s1), b, f"{task} epoch {epoch} batch {i}")
    # val batches of 3: replicated (every rank the whole batch, unmarked)
    whole = _epoch(data, cfg, "val", 1, monkeypatch)
    for r in (0, 1):
        got = _epoch(data, cfg, "val", 1, monkeypatch, r)
        ragged = [i for i, b in enumerate(whole) if len(_leaf(b)) % 2]
        assert ragged, task
        for i in ragged:
            assert "sharded" not in got[i]
            _same(got[i], whole[i], f"{task} val batch {i}")


def _leaf(tree):
    while isinstance(tree, dict):
        tree = tree["inputs"] if "inputs" in tree else next(iter(tree.values()))
    return tree


def test_a_batch_size_the_world_does_not_divide_raises(split_cfgs, monkeypatch):
    cfg = dict(split_cfgs["odom"], training=dict(split_cfgs["odom"]["training"],
                                                 batch_size=5))
    data = build_dataset(cfg)
    from panoptic_forecasting_tpu_torch.core import build_model

    model = build_model(cfg, data.card, "cpu")
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="largest device count that divides"):
        train(model, data, cfg)


# ---- one step of each model over 2 ranks against JAX ------------------------------

ODOM_MODEL = {"predict_type": "offset", "normalize_input": True, "rnn_hidden": 16,
              "loss_fn": "smooth_l1"}


def _odom_case(root):
    """test_dp_gradients_match_single_device's set-up: JAX's gradient on
    the 8-device mesh, loss and Adam step; the port's case."""
    data_dir = str(root / "odom")
    jax_write_odom_fixture(data_dir, n_snippets=3)
    cfg = {"task": "odom", "seed": 0, "working_dir": str(root / "odom_run"),
           "data": {"data_splits": ["train"], "data_dir": data_dir}, "model": ODOM_MODEL,
           "training": {"batch_size": 16, "lr": 1e-3, "use_adam": True,
                        "clip_grad_norm": 5.0}}
    jdata = jax_build_dataset(cfg)
    jmodel = jax_build_model(cfg, jdata.card)
    batch = next(iter(jdata.loader("train", cfg, seed=0)))
    batch.pop("meta", None)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch)["params"]

    def loss_fn(p, b):
        mean_loss, metrics, _ = jmodel.loss(p, {}, b, train=True)
        return mean_loss, metrics

    mesh8 = make_mesh()
    assert mesh8.devices.size == 8
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, shard_batch(mesh8, batch))
    opt = jax_build_optimizer(cfg)
    new = optax.apply_updates(params, opt.update(grads, opt.init(params), params)[0])
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    card = build_dataset(cfg).card
    return ({"name": "odom", "cfg": cfg, "card": card.to_json(),
             "state": odom_state_dict_from_jax(np_(params)), "batch": np_(batch), "n": 16,
             "dtype": torch.float32},
            {"loss": float(loss), "metrics": np_(metrics),
             "grads": odom_state_dict_from_jax(np_(grads)),
             "params": odom_state_dict_from_jax(np_(new)), "before": np_(params)})


def _fg_case(root):
    """The first batch of fg_train.yaml's split (batch 4), JAX's global
    step on it, and the port's case."""
    jroot = str(root / "fg")
    jax_write_fg_fixture(jroot, n_scenes=3, max_instances=3, feat_channels=32, feat_hw=7)
    cfg = fg_train_cfg(jroot)
    jdata = jax_build_dataset(cfg)
    jmodel = jax_build_model(cfg, jdata.card)
    batch = next(iter(jdata.loader("train", cfg, seed=0)))
    batch = {k: v for k, v in batch.items() if k != "meta"}
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: jmodel.init(r, batch))(jax.random.PRNGKey(0))["params"])

    def loss_fn(p):
        mean, metrics, _ = jmodel.loss(p, {}, batch, None, train=True)
        return mean, metrics

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    opt = jax_build_optimizer(cfg)
    new = optax.apply_updates(params, jax.jit(opt.update)(grads, opt.init(params), params)[0])
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    card = build_dataset(fg_train_cfg(jroot)).card
    return ({"name": "fg", "cfg": cfg, "card": card.to_json(),
             "state": fg_state_dict_from_jax(params), "batch": np_(batch), "n": 4,
             "dtype": torch.float32},
            {"loss": float(loss), "metrics": np_(metrics),
             "grads": fg_state_dict_from_jax(np_(grads)),
             "params": fg_state_dict_from_jax(np_(new))})


def _bg_batch():
    """The bg training tests' kink-margin batch with its second sample
    mostly ignored: the shards' valid counts differ ~5x."""
    batch = _random_batch(0)
    batch["labels"]["seg"][1, :100] = 255
    return batch


def _bg_case():
    """JAX's float64 global-batch step (BN over both samples, the mean
    over every valid pixel) from the seeded f32 init."""
    batch = _bg_batch()
    jax_model = JaxBGModel(BG_CFG)
    jax_model.depth_mean, jax_model.depth_std = DEPTH_STATS
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: jax_model.init(r, batch))(jax.random.PRNGKey(0)))
    with jax.enable_x64(True):
        jax_model.module = JaxHarDNet(n_classes=11, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(p, s, b):
            loss, metrics, new_s = jax_model.loss(p, s, b, train=True)
            return loss, new_s

        (loss, new_s), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], {"batch_stats": v64["batch_stats"]}, batch)
        grads = jax.tree_util.tree_map(np.asarray, grads)
        new_s = jax.tree_util.tree_map(np.asarray, new_s["batch_stats"])
    card = DataCard(task="bg", num_classes=11)
    card.set_stats("depth", np.array([DEPTH_STATS[0]]), np.array([DEPTH_STATS[1]]))
    cfg = dict(BG_CFG, task="bg", training={"lr": 2e-3, "mom": 0.9, "wd": 1e-4,
                                             "clip_grad_norm": 5.0})
    state = bg_state_dict_from_jax(variables, DEPTH_STATS)
    # the batch keeps its margin: no ReLU input within 1e-6 of its kink
    model = BGModel(BG_CFG, depth_stats=DEPTH_STATS, device="cpu")
    model.load_state_dict(state)
    counts, margins = _bn_inputs(model.double().train())
    with torch.no_grad():
        model.loss(to_device(batch, CPU))
    return ({"name": "bg", "cfg": cfg, "card": card.to_json(), "state": state,
             "batch": batch, "n": 2, "dtype": torch.float64},
            {"loss": float(loss), "grads": bg_state_dict_from_jax({"params": grads}),
             "stats": bg_state_dict_from_jax({"params": v64["params"],
                                              "batch_stats": new_s}),
             "margin": min(margins), "counts": counts})


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """({name: case}, {name: JAX's global-batch step}, the port's step
    over 2 ranks (rank 0's and rank 1's results), the port's fg step in
    one process)."""
    root = tmp_path_factory.mktemp("steps")
    cases, want = zip(_odom_case(root), _fg_case(root), _bg_case())
    _, ranks = run_ranks("step", {"cases": list(cases)}, root)
    one = {"fg": dp_worker.one_step(cases[1], 0)}  # no process group
    return ({c["name"]: c for c in cases}, {c["name"]: w for c, w in zip(cases, want)},
            ranks, one)


def _max_rel(got, want):
    """Largest |got − want| over the largest |want| of the tensor."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _adam_bound(case, got, want, grads, jgrads, before, lr):
    """Each parameter within lr·|Δg|/eps + 4 ulp of JAX's after Adam's
    first step, the fg training tests' bound)."""
    for n, g in grads.items():
        dg = np.abs(g.numpy() - jgrads[n].numpy())
        b = np.asarray(before[n])
        ulp = 4 * np.spacing(np.maximum(np.abs(b), np.float32(lr)))
        assert np.all(np.abs(got[n].numpy() - want[n].numpy()) <= lr * dg / 1e-8 + ulp), \
            (case, n)


def test_odom_step_over_two_ranks_matches_jax_mesh(steps):
    cases, want, (r0, r1), _ = steps
    w, a, b = want["odom"], r0["odom"], r1["odom"]
    assert a["rows"] == b["rows"] == 8
    np.testing.assert_allclose(a["means"]["loss"], float(np.mean(w["metrics"]["loss"])),
                               rtol=1e-5)
    for n, g in a["grads"].items():
        np.testing.assert_allclose(g.numpy(), w["grads"][n].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        assert torch.equal(g, b["grads"][n]), n  # the all-reduce gives every rank the same
    before = odom_state_dict_from_jax(w["before"])
    _adam_bound("odom", a["state"], w["params"], a["grads"], w["grads"], before, 1e-3)
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k


def test_fg_step_over_two_ranks_matches_one_process_and_jax(steps):
    cases, want, (r0, r1), one = steps
    w, a, b, o = want["fg"], r0["fg"], r1["fg"], one["fg"]
    assert a["rows"] == b["rows"] == 2 and o["rows"] == 4
    for k, v in o["means"].items():  # the epoch metrics of the global batch
        np.testing.assert_allclose(a["means"][k], v, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(a["means"][k], float(np.mean(w["metrics"][k])),
                                   rtol=2e-5, atol=1e-7, err_msg=k)
    for n, g in a["grads"].items():
        scale = float(np.abs(o["grads"][n].numpy()).max())
        np.testing.assert_allclose(g.numpy(), o["grads"][n].numpy(), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=n)
        jscale = float(np.abs(w["grads"][n].numpy()).max())
        np.testing.assert_allclose(g.numpy(), w["grads"][n].numpy(), rtol=0,
                                   atol=1e-4 * jscale + 1e-12, err_msg=n)
        assert torch.equal(g, b["grads"][n]), n
    before = cases["fg"]["state"]
    _adam_bound("fg", a["state"], w["params"], a["grads"], w["grads"], before, 1e-3)
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k


def _bg_errors(res, want):
    """(loss rel. error, largest gradient error over its tensor's largest
    entry, largest BN statistic error) of a 2-rank result against JAX's."""
    grad = max(_max_rel(g.numpy(), want["grads"][n].numpy()) for n, g in res["grads"].items())
    stat = max(float(np.abs(v.numpy() - want["stats"][k].numpy()).max())
               for k, v in res["state"].items() if "running" in k)
    return abs(res["means"]["loss"] - want["loss"]) / abs(want["loss"]), grad, stat


def test_bg_step_over_two_ranks_matches_jax_float64(steps):
    _, want, (r0, r1), _ = steps
    w = want["bg"]
    assert w["margin"] > 1e-6 and min(w["counts"].values()) == 8
    for r in (r0, r1):
        assert r["bg"]["rows"] == 1
        loss_err, grad_err, stat_err = _bg_errors(r["bg"], w)
        assert loss_err < 1e-6 and grad_err < 1e-4 and stat_err < 1e-6, (
            loss_err, grad_err, stat_err)
    # each rank's loss is its share: the shares add up to the global loss
    np.testing.assert_allclose(r0["bg"]["loss"] + r1["bg"]["loss"], w["loss"], rtol=1e-6)
    for k, v in r0["bg"]["state"].items():
        assert torch.equal(v, r1["bg"]["state"][k]), k


def test_bg_step_per_rank_statistics_or_loss_means_miss_jax(steps):
    """The same batch under the two rules JAX does not compute: each
    rank's own BN statistics, or the mean of the ranks' loss means (the
    shards' valid counts differ ~5x)."""
    _, want, (r0, _), _ = steps
    _, grad_err, stat_err = _bg_errors(r0["bg_per_rank_bn"], want["bg"])
    assert grad_err > 1e-4 and stat_err > 1e-6, (grad_err, stat_err)
    grad_err = max(_max_rel(g.numpy(), want["bg"]["grads"][n].numpy())
                   for n, g in r0["bg_mean_of_means"]["grads"].items())
    assert grad_err > 1e-4, grad_err


# ---- cli.train over 2 ranks ------------------------------------------------------

def _odom_argv(data_dir, wd, epochs):
    return ["--working_dir", wd, "--config_file",
            os.path.join(REPO, "configs", "odom", "odom_train.yaml"),
            "--set", "data.data_dir", data_dir, "--set", "platform", "cpu",
            "--set", "model.rnn_hidden", "16", "--set", "training.batch_size", "8",
            "--set", "training.val_batch_size", "3", "--set", "training.steps_per_epoch",
            "3", "--set", "training.num_epochs", str(epochs),
            "--set", "training.num_data_threads", "0"]


def _metrics(wd):
    with open(os.path.join(wd, "logs", "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]


def _assert_close_runs(got_wd, want_wd, got_state, want_state):
    got, want = _metrics(got_wd), _metrics(want_wd)
    assert [(r["split"], r["step"]) for r in got] == [(r["split"], r["step"]) for r in want]
    for a, b in zip(got, want):
        for k in b:
            if k not in ("split", "step"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    for k, v in want_state.items():
        np.testing.assert_allclose(got_state[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_cli_train_odom_over_two_ranks_matches_one_process(tmp_path):
    data_dir = str(tmp_path / "odom")
    synthetic.write_odom_fixture(data_dir, n_snippets=2)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    with pytest.warns(UserWarning):  # lr_scheduler_type
        train_cli.main(_odom_argv(data_dir, one, 2))
    _, (r0, r1) = run_ranks("train", {"argv": _odom_argv(data_dir, two, 2),
                                      "working_dir": two}, tmp_path)
    assert r0["step"] == r1["step"] == 6 and r0["history"] == r1["history"]
    assert r1["writes"] == []  # rank 1 wrote nothing into the working dir
    files = sorted(os.path.relpath(os.path.join(d, f), two)
                   for d, _, fs in os.walk(two) for f in fs)
    want = {ckpt.BEST, ckpt.LATEST, ckpt.TRAINER, "config.yaml", "data_card.json",
            os.path.join("logs", "metrics.jsonl")}
    # and TensorBoard's event files, where tensorboardX imports
    assert want <= set(files) and all("tfevents" in f for f in set(files) - want), files
    best = lambda wd: torch.load(os.path.join(wd, ckpt.BEST), weights_only=True)  # noqa: E731
    _assert_close_runs(two, one, best(two), best(one))

    # resumed for a third epoch: two ranks as one process
    with pytest.warns(UserWarning):
        want = train_cli.main(_odom_argv(data_dir, one, 3) + ["--continue_training"])
    _, (r0, r1) = run_ranks("train", {"argv": _odom_argv(data_dir, two, 3)
                                      + ["--continue_training"], "working_dir": two},
                            tmp_path)
    assert [h["epoch"] for h in r0["history"]] == [3] and r0["step"] == want["step"] == 9
    assert r1["writes"] == []
    _assert_close_runs(two, one, r0["state"], want["model"].state_dict())
