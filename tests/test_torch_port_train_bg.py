"""Port parity of background-model training: the bg fixture, the train
split of ``data/bg_data.py`` (augmentation, depth statistics, the loader
forwarding ``set_epoch``), ``BGModel.loss``, HarDNet's train-mode graph
and its flax BatchNorm (``models/hardnet.py::BatchNorm2d``), the SGD
branch of ``train/optim.py`` on the bg tree, ``train/loop.py`` and
``cli/train.py`` on ``configs/bg/bg_train.yaml``, the optax-state bridge
and the FCHarDNet pickle loader.

Sizes. The fixture is 128x256 and training crops 128 at batch 2, not
64-pixel crops: HarDNet reaches 1/64 of its input (two stride-2 convs,
four pools), so a 64-pixel crop at batch 2 leaves two values per channel
in the deepest BatchNorms, where x̂ = ±1 and the input gradient vanishes
up to rounding, so f32 gradients there are rounding noise. At 128 the
deepest BNs see 8 values.

Tolerances. Integer arrays (crops, flips, labels, batches) bit-equal;
the f32 loss to rtol 1e-6, the accuracy to the pixels whose top two
logits are within 1e-4. One step's gradients and BN statistics are
compared in float64 on both sides (the JAX package's ``BGModel.loss``
with its ``HarDNet`` built at float64 under ``jax.enable_x64``, over the
f32 init; the port's model ``.double()``): at this size JAX's own f32
gradient (XLA's CPU reductions, f32 logits) is not within 1e-4 of its
float64 gradient, so f32 against f32 cannot show 1e-4. There, gradients within 1e-4 of each
tensor's largest entry and the statistics within 1e-6; the deepest BNs'
statistics would be off by 0.1·var/7 with ``nn.BatchNorm2d``'s unbiased
variance (asserted). The comparison holds where no ReLU input is near
its kink: at batch 2 HarDNet has units within rounding of zero on some
inputs, where a gradient entry depends on which side rounding puts them
(float64 finite differences do not converge there); the test asserts its
batch's margin. ``train()`` histories over 2 epochs x 2 SGD steps in f32
(tolerances at the test); a resumed run bit-equal to a straight one; an
SGD step from a bridged optax state to rtol 1e-6 / atol 1e-8.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core import build_model as jax_build_model
from panoptic_forecasting_tpu.data.synthetic import write_bg_fixture as jax_write_bg_fixture
from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
from panoptic_forecasting_tpu.models.hardnet import HarDNet as JaxHarDNet
from panoptic_forecasting_tpu.train import loop as jax_loop
from panoptic_forecasting_tpu.train.optim import build_optimizer as jax_build_optimizer
from panoptic_forecasting_tpu_torch.cli import common, train as train_cli
from panoptic_forecasting_tpu_torch.core import build_dataset, build_model
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.data import io, synthetic
from panoptic_forecasting_tpu_torch.models.base import init_weights, seeded_init_
from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.models.convert import (
    bg_state_dict_from_jax, opt_state_from_jax,
)
from panoptic_forecasting_tpu_torch.models.hardnet import BatchNorm2d, HarDNet
from panoptic_forecasting_tpu_torch.train.loop import to_device, train
from panoptic_forecasting_tpu_torch.train.optim import build_optimizer

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIGHT, WIDTH, CROP = 128, 256, 128
CPU = torch.device("cpu")

MODEL = {"num_inputs": 3, "convert2onehot": True, "use_depth_inps": True}
TRAINING = {"batch_size": 2, "val_batch_size": 2, "num_epochs": 2,
            "steps_per_epoch": 2, "lr": 2e-3, "mom": 0.9, "wd": 1e-4,
            "clip_grad_norm": 5.0, "num_data_threads": 2}


def bg_cfg(data, wd, **training):
    """bg_train.yaml's data and optimizer settings on a fixture."""
    return {
        "task": "bg", "seed": 0, "working_dir": wd,
        "data": {"data_splits": ["train", "val"], "data_inp_size": 3,
                 "gap_len": [9], "only_background": True, "use_depths": True,
                 "min_depth": 0.1, "max_depth": 200, "crop_size": CROP,
                 "scale_min": 0.5, "scale_max": 2.0,
                 "depth_norm_params_file": os.path.join(wd, "depth_norm_params.npz"),
                 **data},
        "model": dict(MODEL),
        "training": dict(TRAINING, **training),
    }


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{"jax"/"port": one-group fixtures of each package's writer,
    "groups": the port's two-group (gaps 9 and 3) fixture}: data
    fragments."""
    out = {}
    jax_root = str(tmp_path_factory.mktemp("bg_jax"))
    out["jax"] = dict(jax_write_bg_fixture(jax_root, n_snippets=3, height=HEIGHT,
                                           width=WIDTH), gap_len=[9])
    for name, gaps in (("port", (9,)), ("groups", (9, 3))):
        root = str(tmp_path_factory.mktemp(f"bg_{name}"))
        out[name], _ = synthetic.write_bg_fixture(root, n_snippets=3, height=HEIGHT,
                                                  width=WIDTH, gap_lens=gaps)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_fixture_content_matches_jax(roots):
    import h5py

    jroot, proot = roots["jax"]["cityscapes_dir"], roots["port"]["cityscapes_dir"]
    files = _files(jroot)
    assert files == _files(proot) and len(files) == 2 * 3 * 4 + 2
    for rel in files:
        a, b = os.path.join(jroot, rel), os.path.join(proot, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(io.load_png(b), io.load_png(a), err_msg=rel)
            continue
        with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
            keys = []
            fa.visit(lambda k: keys.append(k) if isinstance(fa[k], h5py.Dataset) else None)
            assert keys and len(keys) == 3
            for k in keys:
                assert fb[k].dtype == fa[k].dtype == np.uint16
                np.testing.assert_array_equal(fb[k][()], fa[k][()], err_msg=k)


def _same_tree(a, b, what):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _same_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("fixture", ["one_group", "two_groups"])
def test_train_dataset_and_loader_match_jax(roots, tmp_path, fixture):
    """Samples and batches bit-equal over 2 epochs (the loader forwards
    set_epoch, so the crops reseed), the depth statistics equal and
    written as ``depth_norm_params.npz.npy``. One group: each package's
    own fixture; two groups (bg_train.yaml's gaps 9 and 3): both read
    the port's."""
    if fixture == "one_group":
        jdata, pdata = roots["jax"], roots["port"]
    else:
        jdata = pdata = dict(roots["groups"])
    jcfg = bg_cfg(jdata, str(tmp_path / "jax"))
    cfg = bg_cfg(pdata, str(tmp_path / "port"))
    jd, pd = jax_build_dataset(jcfg), build_dataset(cfg)
    assert pd.card.num_classes == jd.card.num_classes == 11
    assert pd.card.mean("depth")[0] == jd.card.mean("depth")[0]
    assert pd.card.std("depth")[0] == jd.card.std("depth")[0]
    for c in (jcfg, cfg):
        stats = c["data"]["depth_norm_params_file"]
        assert not os.path.exists(stats) and os.path.isfile(stats + ".npy")
    np.testing.assert_array_equal(np.load(cfg["data"]["depth_norm_params_file"] + ".npy"),
                                  np.load(jcfg["data"]["depth_norm_params_file"] + ".npy"))
    assert len(pd.datasets["train"]) == len(jd.datasets["train"]) == 3 * len(jdata["gap_len"])
    loaders = (pd.loader("train", cfg, seed=0), jd.loader("train", jcfg, seed=0))
    seen = []
    for epoch in (1, 2):
        for ld in loaders:
            ld.set_epoch(epoch)
        got, want = [list(ld) for ld in loaders]
        assert len(got) == len(want) == 2
        for i, (a, b) in enumerate(zip(got, want)):
            _same_tree(a, b, f"epoch {epoch} batch {i}")
            assert a["inputs"]["seg"].shape == (2, 3, CROP, CROP)
            assert a["inputs"]["depth"].dtype == np.uint16
        seen.append(pd.datasets["train"][0]["inputs"]["seg"])
    assert not np.array_equal(*seen)  # the epoch reseeds the crop
    val = [list(d.loader("val", c, seed=0)) for d, c in ((pd, cfg), (jd, jcfg))]
    assert sum(len(b["labels"]["seg"]) for b in val[0]) == len(pd.datasets["val"])
    for a, b in zip(*val):
        _same_tree(a, b, "val")
        assert a["inputs"]["seg"].shape[1:] == (3, HEIGHT, WIDTH)


# ---- the loss, one step, BatchNorm ------------------------------------------

def _random_batch(seed, b=2, size=CROP):
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, 12, (b, 3, size, size)).astype(np.uint8)
    seg[:, :, :6] = 255
    depth = rng.randint(0, 60000, (b, 3, size, size)).astype(np.uint16)
    labels = rng.randint(0, 11, (b, size, size)).astype(np.int32)
    labels[:, -9:] = 255
    return {"inputs": {"seg": seg, "depth": depth}, "labels": {"seg": labels}}


DEPTH_STATS = (70.0, 80.0)
CFG = {"model": MODEL, "data": {"num_classes": 11}}


@pytest.fixture(scope="module")
def step(roots):
    """The JAX BGModel's init (seeded), its jitted f32 loss gradient, and
    the port's model on the same variables."""
    jax_model = JaxBGModel(CFG)
    jax_model.depth_mean, jax_model.depth_std = DEPTH_STATS
    batch = _random_batch(0)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: jax_model.init(r, batch))(jax.random.PRNGKey(0)))

    def loss_fn(p, s, b):
        loss, metrics, new_s = jax_model.loss(p, s, b, train=True)
        return loss, (metrics, new_s)

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def port(dtype=torch.float32):
        model = BGModel(CFG, depth_stats=DEPTH_STATS, device="cpu")
        model.load_state_dict(bg_state_dict_from_jax(variables, DEPTH_STATS))
        return model.to(dtype).train()

    return jax_model, variables, grad, port, batch


def test_bg_loss_and_accuracy_match_jax(step):
    jax_model, variables, grad, port, batch = step
    (loss, (metrics, _)), _ = grad(variables["params"],
                                   {"batch_stats": variables["batch_stats"]}, batch)
    model = port()
    got, got_m = model.loss(to_device(batch, CPU))
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(got_m["loss"].detach()), float(metrics["loss"]), rtol=1e-6)
    # the accuracy counts argmax hits: it may differ by the pixels whose
    # top two logits are within 1e-4 (the logits agree to ~1e-5)
    with torch.no_grad():
        top2 = model.train()(batch["inputs"]).topk(2, dim=1).values
    valid = batch["labels"]["seg"] != 255
    ties = int(((top2[:, 0] - top2[:, 1]).numpy() < 1e-4)[valid].sum())
    gap = abs(float(got_m["accuracy"]) - float(metrics["accuracy"])) * valid.sum()
    assert gap <= ties + 1e-3 and ties < 1e-3 * valid.sum()
    assert 0 < float(got_m["accuracy"]) < 1
    ignored = dict(batch, labels={"seg": np.full_like(batch["labels"]["seg"], 255)})
    jl, jm, _ = jax.jit(lambda p, s, b: jax_model.loss(p, s, b, train=True))(
        variables["params"], {"batch_stats": variables["batch_stats"]}, ignored)
    model = port()
    pl, pm = model.loss(to_device(ignored, CPU))
    assert float(jl) == float(pl) == 0 and float(jm["accuracy"]) == float(pm["accuracy"]) == 0
    pl.backward()
    assert all(torch.count_nonzero(p.grad) == 0 for p in model.parameters())


def _bn_inputs(model):
    """({BN name: values per channel it normalised}, [smallest |output|
    of each BN: the ReLU inputs' distance to the kink]) over a forward."""
    counts, margins = {}, []

    def hook(m, i, o, name):
        counts[name] = i[0].numel() // i[0].shape[1]
        margins.append(float(o.detach().abs().min()))

    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_hook(lambda m, i, o, name=name: hook(m, i, o, name))
    return counts, margins


def test_bg_step_gradients_and_statistics_match_jax(step):
    """float64 on both sides (see the module doc)."""
    _, variables, _, port, batch = step
    with jax.enable_x64(True):
        jax_model = JaxBGModel(CFG)
        jax_model.depth_mean, jax_model.depth_std = DEPTH_STATS
        jax_model.module = JaxHarDNet(n_classes=11, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(p, s, b):
            loss, metrics, new_s = jax_model.loss(p, s, b, train=True)
            return loss, new_s

        (loss, new_s), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], {"batch_stats": v64["batch_stats"]}, batch)
        grads = jax.tree_util.tree_map(np.asarray, grads)
        new_s = jax.tree_util.tree_map(np.asarray, new_s["batch_stats"])
    model = port(torch.float64)
    counts, margins = _bn_inputs(model)
    got, _ = model.loss(to_device(batch, CPU))
    got.backward()
    assert min(margins) > 1e-6, min(margins)  # no ReLU input at its kink
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-6)
    want = bg_state_dict_from_jax({"params": grads})
    for n, p in model.named_parameters():
        w = want[n].numpy()
        err = np.abs(p.grad.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-4, (n, err)
    after = bg_state_dict_from_jax({"params": v64["params"], "batch_stats": new_s})
    before = model.state_dict()
    unbiased_gap = 0.0
    for name, n in counts.items():
        for stat in ("running_mean", "running_var"):
            key = f"{name}.{stat}"
            np.testing.assert_allclose(dict(model.named_buffers())[key].numpy(),
                                       after[key].numpy(), rtol=0, atol=1e-6, err_msg=key)
        var = (after[f"{name}.running_var"].numpy() - 0.9) / 0.1  # from var 1
        unbiased_gap = max(unbiased_gap, float(np.abs(0.1 * var / (n - 1)).max()))
        assert int(before[f"{name}.num_batches_tracked"]) == 1
    assert min(counts.values()) == 8  # the 1/64 level: 2x2 at batch 2
    assert unbiased_gap > 1e-3  # nn.BatchNorm2d's running variance would fail


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 4, 1, 1), (3, 2, 1, 1)])
def test_batchnorm_matches_flax(shape):
    """Output, input and parameter gradients and running statistics of one
    BN against flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` in
    training, f32; (1, C, 1, 1) is one value per channel (variance 0,
    where ``nn.BatchNorm2d`` raises). (Two values per channel would make
    the input gradient 0 up to rounding, which cannot be compared.)"""
    import flax.linen as fnn

    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 2 + 3).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)
    bias = rng.randn(shape[1]).astype(np.float32)
    xj = x.transpose(0, 2, 3, 1)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": rng.randn(shape[1]).astype(np.float32),
             "var": rng.uniform(0.5, 2, shape[1]).astype(np.float32)}

    def f(xj, p):
        return bn.apply({"params": p, "batch_stats": stats}, xj, mutable=["batch_stats"])

    yj, f_vjp = jax.vjp(lambda xj, p: f(xj, p)[0], xj, {"scale": scale, "bias": bias})
    dxj, dp = f_vjp(g.transpose(0, 2, 3, 1))
    new = f(xj, {"scale": scale, "bias": bias})[1]["batch_stats"]
    m = BatchNorm2d(shape[1]).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(stats["mean"]))
        m.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt)
    y.backward(torch.from_numpy(g))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj).transpose(0, 3, 1, 2), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dxj).transpose(0, 3, 1, 2), **tol)
    np.testing.assert_allclose(m.weight.grad.numpy(), np.asarray(dp["scale"]), **tol)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(dp["bias"]), **tol)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(new["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(new["var"]), rtol=1e-6, atol=1e-7)


def test_jax_sgd_state_resumes_in_the_port(step):
    """JAX takes step 1 (optax: norm clip, L2 decay over every parameter,
    SGD momentum); the port loads its parameters and optax state and
    steps on JAX's step-2 gradient."""
    _, variables, grad, port, _ = step
    cfg = {"training": dict(TRAINING, clip_grad_norm=0.5)}  # the clip acts
    opt = jax_build_optimizer(cfg)

    @jax.jit
    def sgd(g, state, params):
        updates, state = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state

    params = variables["params"]
    state = jax.jit(opt.init)(params)
    grads = []
    for seed in (1, 2):
        (_, _), g = grad(params, {"batch_stats": variables["batch_stats"]}, _random_batch(seed))
        grads.append(g)
        if seed == 1:
            params, state = sgd(g, state, params)
            step1 = jax.tree_util.tree_map(np.asarray, params)
    step2 = bg_state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, sgd(grads[1], state, params)[0])})
    norm = np.sqrt(sum(float((np.asarray(x, np.float64) ** 2).sum())
                       for x in jax.tree_util.tree_leaves(grads[1])))
    assert norm > 0.5

    model = port()
    model.load_state_dict(bg_state_dict_from_jax(
        {"params": step1, "batch_stats": variables["batch_stats"]}, DEPTH_STATS))
    popt = build_optimizer(model, cfg)
    names = [n for n, _ in model.named_parameters()]
    popt.load_state_dict(opt_state_from_jax(
        state, lambda t: bg_state_dict_from_jax({"params": t}), names,
        popt.state_dict()["param_groups"]))
    g2 = bg_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads[1])})
    for n, p in model.named_parameters():
        p.grad = g2[n].clone()
    popt.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), step2[n].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=n)


# ---- the pretrained pickle ------------------------------------------------------

@pytest.mark.parametrize("classes", [19, 11])
def test_hardnet_pickle_loads_as_jax(step, tmp_path, classes):
    """A reference FCHarDNet-70 file (``{"model_state": module.*}``, a
    3-channel stem, ``classes`` outputs): the stem mean-replicated to the
    36 inputs, the head loaded only at 11 classes, every other entry as
    the file has it; equal to JAX's ``_load_pretrained``."""
    jax_model, variables, _, _, _ = step
    ref = seeded_init_(HarDNet(3, n_classes=classes), 5)
    path = str(tmp_path / "hardnet70_cityscapes_model.pkl")
    torch.save({"model_state": {f"module.{k}": v for k, v in ref.state_dict().items()},
                "epoch": 3}, path)
    jax_model.pretrain_path = path
    try:
        want = bg_state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_model._load_pretrained(variables)), DEPTH_STATS)
    finally:
        jax_model.pretrain_path = None
    cfg = dict(CFG, model=dict(MODEL, hardnet={"pretrain_path": path}))
    model = BGModel(cfg, depth_stats=DEPTH_STATS, device="cpu")
    seeded = seeded_init_(BGModel(CFG, depth_stats=DEPTH_STATS, device="cpu"), 0).state_dict()
    got = init_weights(model, 0).state_dict()
    fresh = bg_state_dict_from_jax(variables, DEPTH_STATS)
    for k, v in ref.state_dict().items():
        key = f"model.{k}"
        if k.endswith("num_batches_tracked"):
            continue
        if k == "base.0.conv.weight":
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6)
            assert got[key].shape == (16, 36, 3, 3)
            np.testing.assert_allclose(got[key][:, 7].numpy(), v.mean(1).numpy(), rtol=1e-6)
        elif k.startswith("finalConv.") and classes != 11:
            np.testing.assert_array_equal(got[key].numpy(), seeded[key].numpy())
            np.testing.assert_array_equal(want[key].numpy(), fresh[key].numpy())
        else:
            np.testing.assert_array_equal(got[key].numpy(), v.numpy(), err_msg=k)
            np.testing.assert_array_equal(want[key].numpy(), v.numpy(), err_msg=k)


def test_missing_pretrain_warns_and_keeps_the_seeded_init():
    cfg = dict(CFG, model=dict(MODEL, hardnet={"pretrain_path": "/nonexistent/h.pkl"}))
    with pytest.warns(UserWarning, match="not found"):
        model = BGModel(cfg, device="cpu")
    want = seeded_init_(BGModel(CFG, device="cpu"), 0).state_dict()
    for k, v in init_weights(model, 0).state_dict().items():
        assert torch.equal(v, want[k]), k


# ---- train() ------------------------------------------------------------------

def _jax_init(jax_model, jax_data, jcfg):
    """JAX train()'s init: the seed's key on a batch of a fresh loader."""
    example = next(iter(jax_data.loader("train", jcfg, seed=jcfg["seed"])))
    example = {k: v for k, v in example.items() if k != "meta"}
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: jax_model.init(r, example))(jax.random.PRNGKey(jcfg["seed"])))


def test_bg_train_history_matches_jax(roots, tmp_path):
    """2 epochs x 2 steps of batch 2 with validation (eval mode on the
    running statistics) on the one-group fixture, in f32 as users train.
    The port's config says ``packed_train: true`` (a TPU layout, ignored),
    JAX runs its plain graph. Both start from the JAX init.

    The first epoch's losses to rtol 1e-3 and accuracies (shares of
    pixels) to atol 2e-3: its second step follows one SGD update made
    from JAX's f32 gradient, which is not the port's to 1e-4 on this
    fixture's batches. The second epoch's
    losses to rtol 3e-2 and its accuracies not at all: each update adds
    that difference, and HarDNet at batch 2 has ReLU inputs within
    rounding of zero, so a step can put units on the other side of their
    kinks and the two runs part. The epochs, steps and best epoch exactly.
    """
    jcfg = bg_cfg(roots["jax"], str(tmp_path / "jax"))
    cfg = bg_cfg(roots["port"], str(tmp_path / "port"))
    cfg["model"]["packed_train"] = True
    jax_data = jax_build_dataset(jcfg)
    jax_model = jax_build_model(jcfg, jax_data.card)
    variables = _jax_init(jax_model, jax_data, jcfg)
    os.makedirs(jcfg["working_dir"], exist_ok=True)
    want = jax_loop.train(jax_model, jax_data, jcfg)
    data = build_dataset(cfg)
    model = build_model(cfg, data.card, "cpu")
    ckpt.load_weights(model, bg_state_dict_from_jax(variables))
    cfg = dict(cfg, load_model=ckpt.save_model(cfg["working_dir"] + "_init", model))
    got = train(build_model(cfg, data.card, "cpu"), data, cfg)
    assert [h["epoch"] for h in got["history"]] == [h["epoch"] for h in want["history"]] == [1, 2]
    for a, b in zip(got["history"], want["history"]):
        for split in ("train", "val"):
            assert sorted(a[split]) == sorted(b[split]) == ["accuracy", "loss"]
            np.testing.assert_allclose(a[split]["loss"], b[split]["loss"],
                                       rtol=1e-3 if a["epoch"] == 1 else 3e-2,
                                       err_msg=f"epoch {a['epoch']} {split} loss")
    for split in ("train", "val"):
        np.testing.assert_allclose(got["history"][0][split]["accuracy"],
                                   want["history"][0][split]["accuracy"], rtol=0, atol=2e-3)
    assert got["step"] == want["step"] == 4
    assert got["best_val_epoch"] == want["best_val_epoch"]


def test_bg_resume_is_bit_equal_to_straight_run(roots, tmp_path):
    """2 epochs then resumed for a third against 3 straight: the SGD
    momentum, the BN statistics and the loader state carry over."""
    cfg = bg_cfg(roots["groups"], str(tmp_path / "straight"), num_epochs=3)
    data = build_dataset(cfg)
    straight = train(build_model(cfg, data.card, "cpu"), data, cfg)
    wd = str(tmp_path / "resumed")
    first = train(build_model(cfg, data.card, "cpu"), data,
                  dict(cfg, working_dir=wd, training=dict(cfg["training"], num_epochs=2)))
    state = ckpt.load_trainer_state(wd)
    assert all("momentum_buffer" in s for s in state["opt_state"]["state"].values())
    saved = torch.load(os.path.join(wd, ckpt.LATEST), weights_only=True)
    assert int(saved["model.base.0.norm.num_batches_tracked"]) == 4
    resumed = train(build_model(cfg, data.card, "cpu"), data,
                    dict(cfg, working_dir=wd, continue_training=True))
    assert first["history"] == straight["history"][:2]
    assert resumed["history"] == straight["history"][2:]
    assert resumed["step"] == straight["step"] == 6
    a, b = resumed["model"].state_dict(), straight["model"].state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---- the CLI ----------------------------------------------------------------------

def _cli_argv(data, wd, *extra):
    """cli.train on configs/bg/bg_train.yaml over a fixture, crop 128,
    batch 2, 1 epoch of 2 steps, on the CPU."""
    argv = ["--working_dir", wd, "--config_file",
            os.path.join(REPO, "configs", "bg", "bg_train.yaml"),
            "--set", "data.data_dir", "[" + ",".join(data["data_dir"]) + "]"]
    for key in ("gt_dir", "depth_h5_path", "cityscapes_dir"):
        argv += ["--set", f"data.{key}", data[key]]
    sets = {"data.depth_norm_params_file": os.path.join(wd, "depth_norm_params.npz"),
            "data.crop_size": CROP, "training.batch_size": 2,
            "training.val_batch_size": 2, "training.steps_per_epoch": 2,
            "training.num_epochs": 1, "training.num_data_threads": 2}
    for k, v in sets.items():
        argv += ["--set", k, str(v)]
    return argv + list(extra)


def test_cli_train_bg_writes_its_artifacts(roots, tmp_path):
    wd = str(tmp_path / "run")
    with pytest.warns(UserWarning, match="hardnet pretrain"):
        result = train_cli.main(_cli_argv(roots["groups"], wd, "--set", "platform", "cpu"))
    assert result["step"] == 2 and np.isfinite(result["best_val_result"])
    for name in (ckpt.BEST, ckpt.LATEST, ckpt.TRAINER, "config.yaml", "data_card.json",
                 os.path.join("logs", "metrics.jsonl"), "depth_norm_params.npz.npy"):
        assert os.path.isfile(os.path.join(wd, name)), name
    with open(os.path.join(wd, "config.yaml")) as f:
        assert yaml.safe_load(f)["model"]["packed_train"] is True
    best = torch.load(os.path.join(wd, ckpt.BEST), weights_only=True)
    assert int(best["model.base.0.norm.num_batches_tracked"]) == 2
    assert not torch.equal(best["model.base.0.norm.running_var"],
                           seeded_init_(BGModel(CFG, device="cpu"), 0).model.base[0].norm.running_var)


def test_cli_train_bg_raises_without_cuda(roots, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(_cli_argv(roots["groups"], str(tmp_path / "run")))


# Keys of bg_train.yaml that neither package reads, and that JAX reads and
# the port accepts and ignores (a TPU layout of the same graph).
IGNORED = {"data.cityscapes_dir", "data.load_depths"}
ACCEPTED = {"model.packed_train"}


def test_bg_training_config_keys_are_read_as_jax_reads_them(roots, tmp_path):
    from test_torch_port_train import Recorder, _leaves
    from panoptic_forecasting_tpu_torch.core.config import load_config

    argv = _cli_argv(roots["groups"], str(tmp_path / "run"), "--set", "platform", "cpu",
                     "--set", "training.num_epochs", "0")
    with open(argv[3]) as f:
        keys = set(_leaves(yaml.safe_load(f)))
    cfg = load_config(argv)
    seen = {"port": set(), "jax": set()}
    with pytest.warns(UserWarning):
        _, data, model = common.setup(Recorder(cfg, seen["port"]))
        train(model, data, Recorder(cfg, seen["port"]))
    jcfg = Recorder(dict(cfg, working_dir=str(tmp_path / "jax")), seen["jax"])
    jax_data = jax_build_dataset(jcfg)
    os.makedirs(jcfg["working_dir"], exist_ok=True)
    jax_loop.train(jax_build_model(jcfg, jax_data.card), jax_data, jcfg)
    port_keys = {k for k in keys if k in seen["port"]}
    jax_keys = {k for k in keys if k in seen["jax"]}
    assert port_keys | ACCEPTED == jax_keys
    assert keys - seen["port"] == IGNORED | ACCEPTED
