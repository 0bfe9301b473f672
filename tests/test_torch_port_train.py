"""Port parity of the training machinery on the odometry task:
``train/optim.py`` (each optimizer branch and the LR schedules against
optax and the JAX schedule), the loader's sample order, the odometry
loss, ``train/loop.py::train`` (histories, accumulation, resume), the
optimizer-state bridge ``models/convert.py::opt_state_from_jax``,
``cli/train.py`` on both training configs, and the configs' keys.

Inputs come from numpy seeds and both packages' ``write_odom_fixture``;
the port starts from the JAX init (``jax.jit`` of ``OdomModel.init``)
carried by ``models/convert.py``. Tolerances: one optimizer step to
rtol 1e-6 / atol 1e-7 (f32 arithmetic in another order, on parameters
and updates of order 1); LR schedules to rtol 1e-12 (the same float64
products); loader indices exactly; the odometry loss to rtol 1e-5;
train() histories to rtol 2e-5 (six f32 Adam steps; the losses are
O(1)) and the best epoch exactly; a resumed run bit-equal to a straight
one; a step from a bridged JAX optimizer state to rtol 1e-5 / atol 1e-7.
"""

import os
from contextlib import nullcontext

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core import build_model as jax_build_model
from panoptic_forecasting_tpu.data.loader import Loader as JaxLoader
from panoptic_forecasting_tpu.data.synthetic import write_odom_fixture as jax_write_odom_fixture
from panoptic_forecasting_tpu.train import loop as jax_loop
from panoptic_forecasting_tpu.train.optim import (
    build_optimizer as jax_build_optimizer, lr_for_epoch as jax_lr_for_epoch,
)
from panoptic_forecasting_tpu_torch.cli import common, train as train_cli
from panoptic_forecasting_tpu_torch.core import build_dataset, build_model
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.data import synthetic
from panoptic_forecasting_tpu_torch.data.loader import Loader
from panoptic_forecasting_tpu_torch.models.convert import (
    odom_state_dict_from_jax, opt_state_from_jax,
)
from panoptic_forecasting_tpu_torch.models.layers import GRUCell
from panoptic_forecasting_tpu_torch.train.loop import to_device, train
from panoptic_forecasting_tpu_torch.train.optim import build_optimizer, lr_for_epoch

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- the optimizer --------------------------------------------------------

BRANCHES = {
    "adam": {"use_adam": True},
    "adam_l2": {"use_adam": True, "wd": 0.05},
    "adamw": {"use_adamw": True, "wd": 0.05},
    "adam_over_adamw": {"use_adam": True, "use_adamw": True, "wd": 0.05},
    "sgd_momentum_l2": {"mom": 0.9, "wd": 0.01},
    "sgd": {},
    "clip_value": {"use_adam": True, "clip_grad": 0.3, "clip_grad_norm": 0.1},
    "clip_norm_above": {"use_adam": True, "clip_grad_norm": 1.0},
    "clip_norm_below": {"mom": 0.9, "clip_grad_norm": 1e3},
}


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(5, 4)
        self.b = torch.nn.Linear(4, 3)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_optimizer_steps_match_optax(branch):
    """Two steps with two seeded gradients on a random parameter tree."""
    cfg = {"training": dict(lr=0.01, **BRANCHES[branch])}
    rng = np.random.RandomState(3)
    model = Tiny()
    params = {n: rng.randn(*p.shape).astype(np.float32)
              for n, p in model.named_parameters()}
    model.load_state_dict({n: torch.from_numpy(v) for n, v in params.items()})
    grads = [{n: (rng.randn(*v.shape) * 2).astype(np.float32) for n, v in params.items()}
             for _ in range(2)]
    jopt = jax_build_optimizer(cfg)
    jstate = jopt.init(params)
    opt = build_optimizer(model, cfg)
    for g in grads:
        updates, jstate = jopt.update(g, jstate, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), params[n], rtol=1e-6,
                                       atol=1e-7, err_msg=n)
    if "clip_norm" in branch:  # the limit was (not) reached as named
        norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in grads[0].values()))
        assert (norm >= cfg["training"]["clip_grad_norm"]) == (branch == "clip_norm_above")


def test_frozen_gru_biases_stay_under_decay():
    """The hidden-side r/z biases keep their value through steps that
    would move them (L2 decay, AdamW), the rest of the bias moves."""
    cell = GRUCell(3, 4)
    torch.nn.init.uniform_(cell.bias_hh_l0, -1, 1)
    before = cell.bias_hh_l0.detach().clone()
    for branch in ("adam_l2", "adamw", "sgd_momentum_l2"):
        opt = build_optimizer(cell, {"training": dict(lr=0.1, **BRANCHES[branch])})
        for _ in range(2):
            cell(torch.randn(2, 4), torch.randn(2, 3)).square().sum().backward()
            assert torch.count_nonzero(cell.bias_hh_l0.grad[:8]) == 0
            opt.step()
            opt.zero_grad()
        assert torch.equal(cell.bias_hh_l0.detach()[:8], before[:8]), branch
        assert not torch.equal(cell.bias_hh_l0.detach()[8:], before[8:]), branch


@pytest.mark.parametrize("schedule", [
    {}, {"lr_scheduler_type": "step"},
    {"lr_decay_type": "step", "lr_decay_factor": 0.5, "lr_decay_steps": 2},
    {"lr_decay_type": "poly", "num_epochs": 5},
])
def test_lr_schedule_matches_jax(schedule):
    cfg = {"training": dict(lr=0.01, **schedule)}
    with pytest.warns(UserWarning) if "lr_scheduler_type" in schedule else nullcontext():
        got, want = lr_for_epoch(cfg), jax_lr_for_epoch(cfg)
    for epoch in range(4):
        np.testing.assert_allclose(got(epoch), want(epoch), rtol=1e-12)


# ---- the loader -----------------------------------------------------------

class Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array(i)}


LOADER_MODES = {
    "shuffle": dict(shuffle=True),
    "drop_last": dict(shuffle=True, drop_last=True),
    "steps_per_epoch": dict(shuffle=True, drop_last=True, steps_per_epoch=7),
    "weights": dict(weights=np.arange(1, 24, dtype=np.float64)),
    "in_order": dict(),
}


@pytest.mark.parametrize("mode", sorted(LOADER_MODES))
def test_loader_order_matches_jax(mode):
    kw = LOADER_MODES[mode]
    got, want = Loader(Indices(23), 5, seed=4, **kw), JaxLoader(Indices(23), 5, seed=4, **kw)
    for epoch in range(1, 4):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        a = [b["i"].tolist() for b in got]
        assert a == [b["i"].tolist() for b in want]
        assert len(a) == len(got) == len(want)


# ---- odometry loss and train() ------------------------------------------

ODOM = {
    "task": "odom", "seed": 0,
    "data": {"data_splits": ["train", "val"], "input_len": 9, "output_len": 9},
    "model": {"predict_type": "direct", "normalize_input": True,
              "use_normalized_loss": True, "rnn_hidden": 32, "loss_fn": "mse"},
    "training": {"batch_size": 8, "steps_per_epoch": 3, "num_epochs": 2,
                 "lr": 5e-3, "clip_grad_norm": 5.0, "use_adam": True,
                 "num_data_threads": 0},
}


@pytest.fixture(scope="module")
def odom_dirs(tmp_path_factory):
    jax_dir = str(tmp_path_factory.mktemp("odom_jax"))
    port_dir = str(tmp_path_factory.mktemp("odom_port"))
    jax_write_odom_fixture(jax_dir, n_snippets=4)
    synthetic.write_odom_fixture(port_dir, n_snippets=4)
    return jax_dir, port_dir


def _cfgs(odom_dirs, tmp_path, model=None, **training):
    jax_dir, port_dir = odom_dirs
    out = []
    for name, d in (("jax", jax_dir), ("port", port_dir)):
        out.append(dict(ODOM, working_dir=str(tmp_path / name),
                        data=dict(ODOM["data"], data_dir=d),
                        model=dict(ODOM["model"], **(model or {})),
                        training=dict(ODOM["training"], **training)))
    return out


def _jax_init(jax_model, jax_data, jcfg):
    """JAX train()'s init: the seed's key on a batch of a fresh loader."""
    example = next(iter(jax_data.loader("train", jcfg, seed=jcfg["seed"])))
    variables = jax.jit(lambda r: jax_model.init(r, example))(
        jax.random.PRNGKey(jcfg["seed"]))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _port_start(cfg, jax_params, card):
    """The JAX init as the port's checkpoint, named by ``load_model``."""
    model = build_model(cfg, card, "cpu")
    ckpt.load_weights(model, odom_state_dict_from_jax(jax_params))
    path = ckpt.save_model(cfg["working_dir"] + "_init", model)
    return dict(cfg, load_model=path)


@pytest.mark.parametrize("model", [
    {}, {"use_normalized_loss": False, "loss_fn": "smooth_l1"},
    {"normalize_input": False, "predict_type": "offset"},
])
def test_odom_loss_matches_jax(odom_dirs, tmp_path, model):
    jcfg, cfg = _cfgs(odom_dirs, tmp_path, model)
    jax_data = jax_build_dataset(jcfg)
    jax_model = jax_build_model(jcfg, jax_data.card)
    params = _jax_init(jax_model, jax_data, jcfg)
    batch = next(iter(jax_data.loader("val", jcfg, test=True)))
    jloss, jmetrics, _ = jax_model.loss(params, {}, batch)
    data = build_dataset(cfg)
    port = build_model(cfg, data.card, "cpu")
    ckpt.load_weights(port, odom_state_dict_from_jax(params))
    loss, metrics = port.loss(to_device(batch, torch.device("cpu")))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["loss"].detach().numpy(),
                               np.asarray(jmetrics["loss"]), rtol=1e-5)


def _both_train(odom_dirs, tmp_path, **training):
    jcfg, cfg = _cfgs(odom_dirs, tmp_path, **training)
    jax_data = jax_build_dataset(jcfg)
    jax_model = jax_build_model(jcfg, jax_data.card)
    params = _jax_init(jax_model, jax_data, jcfg)
    os.makedirs(jcfg["working_dir"], exist_ok=True)
    want = jax_loop.train(jax_model, jax_data, jcfg)
    data = build_dataset(cfg)
    cfg = _port_start(cfg, params, data.card)
    got = train(build_model(cfg, data.card, "cpu"), data, cfg)
    return got, want


def _assert_histories(got, want):
    assert [h["epoch"] for h in got["history"]] == [h["epoch"] for h in want["history"]]
    for a, b in zip(got["history"], want["history"]):
        for split in ("train", "val"):
            assert sorted(a[split]) == sorted(b[split])
            for k in a[split]:
                np.testing.assert_allclose(a[split][k], b[split][k], rtol=2e-5,
                                           err_msg=f"{split} {k}")
    assert got["best_val_epoch"] == want["best_val_epoch"]
    assert got["step"] == want["step"]


def test_odom_train_history_matches_jax(odom_dirs, tmp_path):
    got, want = _both_train(odom_dirs, tmp_path)
    _assert_histories(got, want)
    assert got["step"] == 6
    for name in (ckpt.BEST, ckpt.LATEST, ckpt.TRAINER):
        assert os.path.isfile(os.path.join(tmp_path / "port", name))


def test_odom_accumulation_matches_jax(odom_dirs, tmp_path):
    """tests/test_odom_slice.py's accumulation case: batch 4, two
    batches an update, 6 updates an epoch."""
    got, want = _both_train(odom_dirs, tmp_path, batch_size=4,
                            accumulate_steps=2, steps_per_epoch=6)
    assert got["step"] == want["step"] == 2 * 6
    _assert_histories(got, want)


def test_resume_is_bit_equal_to_straight_run(odom_dirs, tmp_path):
    """2 epochs, then resumed for 2 more, against 4 straight (loader
    orders reshuffle inside the epochs: 3 steps of 8 out of 60)."""
    _, cfg = _cfgs(odom_dirs, tmp_path, steps_per_epoch=4, num_epochs=4)
    data = build_dataset(cfg)
    straight = train(build_model(cfg, data.card, "cpu"),
                     data, dict(cfg, working_dir=str(tmp_path / "straight")))
    wd = str(tmp_path / "resumed")
    first = train(build_model(cfg, data.card, "cpu"), data,
                  dict(cfg, working_dir=wd, training=dict(cfg["training"], num_epochs=2)))
    assert first["step"] == 8
    resumed = train(build_model(cfg, data.card, "cpu"), data,
                    dict(cfg, working_dir=wd, continue_training=True))
    assert resumed["step"] == straight["step"] == 16
    assert [h["epoch"] for h in resumed["history"]] == [3, 4]
    assert resumed["history"] == straight["history"][2:]
    assert first["history"] == straight["history"][:2]
    a, b = resumed["model"].state_dict(), straight["model"].state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert (resumed["best_val_epoch"], resumed["best_val_result"]) == (
        straight["best_val_epoch"], straight["best_val_result"])


def test_profile_dir_and_verbose(odom_dirs, tmp_path, capsys):
    """``training.profile_dir`` writes a torch.profiler trace of the first
    ``profile_steps`` steps; ``verbose`` prints each batch's loss."""
    _, cfg = _cfgs(odom_dirs, tmp_path, num_epochs=1, verbose=True,
                   profile_dir=str(tmp_path / "trace"), profile_steps=2)
    data = build_dataset(cfg)
    train(build_model(cfg, data.card, "cpu"), data, cfg)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    out = capsys.readouterr().out
    assert [line.split(":")[0].strip() for line in out.splitlines()
            if "BATCH" in line] == ["BATCH 1", "BATCH 2", "BATCH 3"]


def test_jax_optimizer_state_resumes_in_the_port(odom_dirs, tmp_path):
    """JAX takes step 1; the port loads JAX's parameters and optax state
    after it and takes step 2 on the same batch JAX does."""
    jcfg, cfg = _cfgs(odom_dirs, tmp_path)
    jax_data = jax_build_dataset(jcfg)
    jax_model = jax_build_model(jcfg, jax_data.card)
    params = _jax_init(jax_model, jax_data, jcfg)
    it = iter(jax_data.loader("train", jcfg, seed=0))
    batches = [{k: v for k, v in next(it).items() if k != "meta"} for _ in range(2)]
    jopt = jax_build_optimizer(jcfg)
    state = jopt.init(params)
    grad = jax.jit(jax.grad(lambda p, b: jax_model.loss(p, {}, b)[0]))
    for b in batches[:1]:
        updates, state = jopt.update(grad(params, b), state, params)
        params = optax.apply_updates(params, updates)
    step1 = jax.tree_util.tree_map(np.asarray, params)
    updates, _ = jopt.update(grad(params, batches[1]), state, params)
    step2 = odom_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates)))

    model = build_model(cfg, build_dataset(cfg).card, "cpu")
    ckpt.load_weights(model, odom_state_dict_from_jax(step1))
    opt = build_optimizer(model, cfg)
    opt.load_state_dict(opt_state_from_jax(
        state, odom_state_dict_from_jax, [n for n, _ in model.named_parameters()],
        opt.state_dict()["param_groups"]))
    model.loss(to_device(batches[1], torch.device("cpu")))[0].backward()
    opt.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), step2[n].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


# ---- the CLI and the configs' keys ------------------------------------------

def _cli_argv(kind, root, wd):
    """cli.train's arguments: the shipped config on a fixture at ``root``,
    narrow widths, 2 steps of batch 4, 1 epoch, on the CPU."""
    argv = ["--working_dir", wd, "--config_file",
            os.path.join(REPO, "configs", kind, f"{kind}_train.yaml"),
            "--set", "platform", "cpu", "--set", "training.batch_size", "4",
            "--set", "training.steps_per_epoch", "2", "--set", "training.num_epochs", "1",
            "--set", "model.rnn_hidden", "16"]
    if kind == "odom":
        synthetic.write_odom_fixture(root, n_snippets=2)
        return argv + ["--set", "data.data_dir", root]
    synthetic.write_fg_fixture(root, n_scenes=3, max_instances=3, feat_channels=32,
                               feat_hw=7)
    for key in ("data_dir", "depth_dir", "feats_dir", "info_3d_dir"):
        argv += ["--set", f"data.{key}", root]
    return argv + ["--set", "model.mask_feat_channels", "32", "--set",
                   "model.mask_feat_hw", "7", "--set", "model.mask_head.conv_dim", "32"]


@pytest.mark.parametrize("kind", ["odom", "fg"])
def test_cli_train_writes_its_artifacts(kind, tmp_path):
    wd = str(tmp_path / "run")
    with pytest.warns(UserWarning):  # odom: lr_scheduler_type; fg: no pretrain file
        result = train_cli.main(_cli_argv(kind, str(tmp_path / "data"), wd))
    assert result["step"] == 2 and np.isfinite(result["best_val_result"])
    for name in (ckpt.BEST, ckpt.LATEST, ckpt.TRAINER, "config.yaml", "data_card.json",
                 os.path.join("logs", "metrics.jsonl")):
        assert os.path.isfile(os.path.join(wd, name)), name
    with open(os.path.join(wd, "config.yaml")) as f:
        assert yaml.safe_load(f)["training"]["steps_per_epoch"] == 2
    state = ckpt.load_trainer_state(wd)
    assert (state["epoch"], state["step"]) == (2, 2)


def test_cli_train_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _cli_argv("odom", str(tmp_path / "data"), str(tmp_path / "run"))
    i = argv.index("platform")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(argv[: i - 1] + argv[i + 2:])


class Recorder(dict):
    """A config tree that records each dotted key read from it."""

    def __init__(self, tree, seen, path=""):
        super().__init__({k: Recorder(v, seen, f"{path}{k}.") if isinstance(v, dict)
                          else v for k, v in tree.items()})
        self._seen, self._path = seen, path

    def __getitem__(self, k):
        self._seen.add(self._path + k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._seen.add(self._path + k)
        return super().get(k, default)

    def __contains__(self, k):
        self._seen.add(self._path + k)
        return super().__contains__(k)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}.")
        else:
            yield path + k


# Keys of the training configs that neither package reads.
IGNORED = {
    "odom": {"data.dataset_type", "training.lr_decay_factor", "training.lr_decay_steps"},
    "fg": {"data.cityscapes_dir", "model.mask_head.no_finetune"},
}


@pytest.mark.parametrize("kind", ["odom", "fg"])
def test_training_config_keys_are_read_as_jax_reads_them(kind, tmp_path, monkeypatch):
    """Each key the shipped training config sets is read by the port's
    set-up and trainer (datasets, model, loader, optimizer, schedule) iff
    the JAX package's read it; the keys neither reads are ``IGNORED``."""
    argv = _cli_argv(kind, str(tmp_path / "data"), str(tmp_path / "run"))
    with open(argv[3]) as f:
        keys = set(_leaves(yaml.safe_load(f)))
    from panoptic_forecasting_tpu_torch.core.config import load_config

    cfg = load_config(argv + ["--set", "training.num_epochs", "0"])
    seen = {"port": set(), "jax": set()}
    with pytest.warns(UserWarning):
        _, data, model = common.setup(Recorder(cfg, seen["port"]))
        train(model, data, Recorder(cfg, seen["port"]))
        jcfg = Recorder(dict(cfg, working_dir=str(tmp_path / "jax")), seen["jax"])
        jax_data = jax_build_dataset(jcfg)
        os.makedirs(jcfg["working_dir"], exist_ok=True)
        jax_loop.train(jax_build_model(jcfg, jax_data.card), jax_data, jcfg)
    assert {k for k in keys if k in seen["port"]} == {k for k in keys if k in seen["jax"]}
    assert keys - seen["port"] == IGNORED[kind]
