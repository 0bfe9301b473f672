"""Port parity of the odometry task: ``models/odom.py`` (with the MLP and
GRU layer of ``models/layers.py``), its weight bridge, ``data/odom_data.py``
and ``cli/export_odom.py``.

Weights are initialised by the JAX ``OdomModel`` from a seed (under
``jax.jit``) and carried across with ``models/convert.py``; inputs are
numpy-seeded odometry and the fixtures of both packages'
``data/synthetic.py::write_odom_fixture``. Forecasts must agree to rtol
1e-5, atol 1e-6 (f32 products summed in another order); windows, meta
and card statistics exactly; the two exports' h5 files in keys, and in
arrays to 1e-5.
"""

import os

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from panoptic_forecasting_tpu.cli import export_odom as jax_export_odom
from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.data.cards import DataCard as JaxDataCard
from panoptic_forecasting_tpu.data.synthetic import (
    make_odom_table as jax_make_odom_table,
    write_odom_fixture as jax_write_odom_fixture,
)
from panoptic_forecasting_tpu.models import reference_import
from panoptic_forecasting_tpu.models.odom import OdomModel as JaxOdomModel
from panoptic_forecasting_tpu_torch.cli import export_odom
from panoptic_forecasting_tpu_torch.core import build_dataset
from panoptic_forecasting_tpu_torch.data import io, synthetic
from panoptic_forecasting_tpu_torch.models import OdomModel
from panoptic_forecasting_tpu_torch.models.convert import odom_state_dict_from_jax

torch.set_num_threads(2)

SMALL = {"rnn_hidden": 16, "inp_emb_layers": [8, 8], "out_layers": [8]}
STATS = (np.array([8.2, 0.01], np.float32), np.array([2.5, 0.07], np.float32))
# JAX settings the JAX CLI changes for its process (cli/common.py)
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


def _cfg(**model):
    return {"task": "odom", "data": {"input_len": 9, "output_len": 9},
            "model": dict(SMALL, **model)}


def _jax_model(cfg, stats=STATS, seed=0):
    """(JAX OdomModel with ``stats`` on its card, its params)."""
    card = JaxDataCard(task="odom")
    card.set_stats("odom", *stats)
    model = JaxOdomModel(cfg, card)
    x = np.zeros((2, 9, 2), np.float32)
    variables = jax.jit(lambda r: model.init(r, {"inputs": {"odometry": x}}))(
        jax.random.PRNGKey(seed))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _odometry(rng, b=5, t=9):
    x = np.zeros((b, t, 2), np.float32)
    x[..., 0] = 8 + 2 * rng.randn(b, 1) + 0.3 * rng.randn(b, t)
    x[..., 1] = 0.05 * rng.randn(b, t)
    return x


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("predict_type", ["direct", "offset"])
def test_odom_model_matches_jax(predict_type, normalize):
    cfg = _cfg(predict_type=predict_type, normalize_input=normalize)
    jax_model, variables = _jax_model(cfg)
    model = OdomModel(cfg, stats=STATS, device="cpu")
    model.load_state_dict(odom_state_dict_from_jax(variables["params"], STATS))
    x = _odometry(np.random.RandomState(1))
    want = jax.jit(jax_model.forward)(variables, x)
    got = model(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    pred = model.predict({"inputs": {"odometry": x}})["odometry"]
    np.testing.assert_array_equal(pred.numpy(), got[0].numpy())
    assert got[0].shape == (5, 9, 2)


@pytest.mark.parametrize("model_cfg", [{}, {"inp_emb_layers": None, "out_layers": []}],
                         ids=["emb_head", "plain"])
def test_odom_state_dict_round_trip(model_cfg):
    """The port's state_dict, read by the JAX package's reference importer,
    gives back the JAX params and statistics exactly; a port model built
    from the same config takes it with no key left over."""
    cfg = _cfg(**model_cfg)
    _, variables = _jax_model(cfg, seed=3)
    sd = odom_state_dict_from_jax(variables["params"], STATS)
    assert set(sd) == set(OdomModel(cfg, device="cpu").state_dict())
    params, stats = reference_import.odom_from_reference(sd)
    want = variables["params"]
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(want)
    for got_leaf, want_leaf in zip(jax.tree_util.tree_leaves(params),
                                   jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(got_leaf, want_leaf)
    np.testing.assert_array_equal(stats["odom"][0], STATS[0])
    np.testing.assert_array_equal(stats["odom"][1], STATS[1])


def test_odom_model_rejects_unknown_predict_type():
    with pytest.raises(ValueError, match="predict_type"):
        OdomModel(_cfg(predict_type="delta"), device="cpu")


# ---- the dataset ----------------------------------------------------------------


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Each package's odometry fixture (4 snippets, train + val), and an
    ORB-SLAM table of the same rows in both."""
    root = str(tmp_path_factory.mktemp("odom"))
    dirs = {p: os.path.join(root, p) for p in ("jax", "port")}
    jax_write_odom_fixture(dirs["jax"], n_snippets=4)
    synthetic.write_odom_fixture(dirs["port"], n_snippets=4)
    for split, seed in (("train", 0), ("val", 1)):
        tbl = jax_make_odom_table(n_snippets=3, seed=seed + 5)
        tbl["speed"] = [o[:, 0] for o in tbl["odometry"]]
        tbl["yaw_rate"] = [o[:, 1] for o in tbl["odometry"]]
        for d in dirs.values():
            tbl.drop(columns="odometry").to_pickle(
                os.path.join(d, f"orbslam_odom_{split}.pkl"))
    return dirs


@pytest.mark.parametrize("variant", ["train", "test", "orbslam"])
def test_odom_dataset_matches_jax(fixtures, variant):
    data = {"data_splits": ["train", "val"], "input_len": 9, "output_len": 9,
            "use_orbslam_odom": variant == "orbslam"}
    test = variant != "train"
    want = jax_build_dataset({"task": "odom", "data": dict(
        data, data_dir=fixtures["jax"])}, test=test)
    got = build_dataset({"task": "odom", "data": dict(
        data, data_dir=fixtures["port"])}, test=test)
    np.testing.assert_array_equal(got.card.mean("odom"), want.card.mean("odom"))
    np.testing.assert_array_equal(got.card.std("odom"), want.card.std("odom"))
    n_rows = 3 if variant == "orbslam" else 4
    for split in ("train", "val"):
        ds, ref = got.datasets[split], want.datasets[split]
        assert len(ds) == len(ref) == n_rows * ((30 - (9 if test else 18) + 1) + 2)
        for i in range(len(ref)):
            a, b = ds[i], ref[i]
            np.testing.assert_array_equal(a["inputs"]["odometry"], b["inputs"]["odometry"])
            np.testing.assert_array_equal(a["labels"]["odometry"], b["labels"]["odometry"])
            assert a["meta"] == b["meta"]
    starts = {ds_i["meta"]["start_frame"] for ds_i in got.datasets["val"]}
    assert starts == (set(range(6, 30)) if test else set(range(6, 21)))


def test_odom_dataset_load_imgs_raises(fixtures, tmp_path):
    """``load_imgs`` raises only where JAX's does, without
    ``cityscapes_dir``; with it each sample carries its frames."""
    data = {"data_dir": fixtures["port"], "load_imgs": True}
    with pytest.raises(ValueError, match="cityscapes_dir"):
        build_dataset({"task": "odom", "data": data}, test=True)
    cs = str(tmp_path / "cs")
    for split in ("train", "val"):
        synthetic.write_odom_images(cs, io.read_table(os.path.join(
            fixtures["port"], f"{split}_3d_info.pkl")), split, height=8, width=12)
    cfg = {"task": "odom", "data": dict(data, cityscapes_dir=cs)}
    want = jax_build_dataset(cfg, test=True).datasets["val"][0]["inputs"]["imgs"]
    got = build_dataset(cfg, test=True).datasets["val"][0]["inputs"]["imgs"]
    assert got.shape == (9, 8, 12, 3)
    np.testing.assert_array_equal(got, want)


# ---- the export CLI -----------------------------------------------------------


def _read_h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


@pytest.fixture(scope="module")
def exports(fixtures, tmp_path_factory):
    """Both export CLIs on the JAX fixture with one reference-format .pt
    (``--load_torch_model``: weights and statistics)."""
    root = str(tmp_path_factory.mktemp("export"))
    cfg = dict(_cfg(predict_type="offset", normalize_input=True),
               data={"data_splits": ["val"], "data_dir": fixtures["jax"],
                     "input_len": 9, "output_len": 9},
               training={"batch_size": 16})
    cfg_path = os.path.join(root, "odom.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    _, variables = _jax_model(cfg, seed=4)
    pt = os.path.join(root, "odom_reference.pt")
    torch.save(odom_state_dict_from_jax(variables["params"], STATS), pt)

    def argv(side):
        return ["--working_dir", os.path.join(root, side), "--config_file", cfg_path,
                "--load_torch_model", pt, "--set", "export_name", "predicted_odometry"]

    def jitted_init(self, rng, batch, _orig=JaxOdomModel.init):
        return jax.jit(lambda r: _orig(self, r, batch))(rng)

    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxOdomModel, "init", jitted_init)
            jax_export_odom.main(argv("jax") + ["--set", "compilation_cache_dir",
                                                saved["jax_compilation_cache_dir"]])
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    export_odom.main(argv("port") + ["--set", "platform", "cpu"])
    return {side: _read_h5(os.path.join(root, side, "predicted_odometry_val.h5"))
            for side in ("jax", "port")}, argv


def test_export_odom_matches_jax(exports):
    got, want = exports[0]["port"], exports[0]["jax"]
    assert sorted(got) == sorted(want)
    assert len(got) == 4 * 24  # start frames 6..29 of each snippet
    for key, arr in want.items():
        assert got[key].shape == arr.shape == (9, 2)
        np.testing.assert_allclose(got[key], arr, rtol=0, atol=1e-5)


def test_export_odom_device_rule(exports, monkeypatch):
    """Without ``platform cpu`` the export wants CUDA and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_odom.main(exports[1]("port"))


def test_export_odom_writes_through_the_store(fixtures, tmp_path):
    """Inside ``readers_from_store`` the export's h5 goes into the store
    (the chip machine has no h5py) and the pc reader's lookup reads it
    back from there; no file is written."""
    store = synthetic.new_store()
    cfg = {"task": "odom", "platform": "cpu", "working_dir": str(tmp_path),
           "data": {"data_splits": ["val"], "data_dir": fixtures["port"]},
           "model": SMALL, "training": {"batch_size": 32}}
    data = build_dataset(cfg, test=True)
    model = OdomModel(cfg, device="cpu")
    with synthetic.readers_from_store(store, tables=False, arrays=True):
        path = export_odom.export_split(model, data, "val", cfg)
        from panoptic_forecasting_tpu_torch.data import io

        h5 = io.open_h5(path)
        assert h5["synthcity/000002/19/16"][:].shape == (9, 2)
    assert not os.path.exists(path)
    assert len(store["arrays"][path]) == 4 * 24
