"""The natural-image configs and loaders of the port against the JAX
package's: the seven discrete configs (CIFAR10, CELEBA, BEDROOM, CHURCH,
TOWER, FFHQ, NCSN_ORIGINAL) in all five data modes, load_cifar10 (the
seeded stand-in, and pickle batches the test writes), synthetic_rgb,
load_image_folder (PNGs the test writes, an empty folder, one file), the
load_data branches and the provenance they record. Arrays are held equal.
"""
import os
import pickle
import warnings

import numpy as np
import pytest
from PIL import Image

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.data import datasets as jdatasets
from inverseproblemwithdiffusionmodel_tpu_torch import data
from inverseproblemwithdiffusionmodel_tpu_torch.config import (
    DATA_MODES, load_config)
from inverseproblemwithdiffusionmodel_tpu_torch.data import datasets

NATURAL = ("CIFAR10", "CELEBA", "BEDROOM", "CHURCH", "TOWER", "FFHQ",
           "NCSN_ORIGINAL")
FOLDERS = ("CELEBA", "BEDROOM", "CHURCH", "TOWER", "FFHQ")


@pytest.fixture(autouse=True)
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        datasets.reset_provenance()
        jdatasets.reset_provenance()
        yield


def assert_same(ours, ref):
    assert ours.data.dtype == ref.data.dtype
    np.testing.assert_array_equal(ours.data, ref.data)
    if ref.labels is None:
        assert ours.labels is None
    else:
        np.testing.assert_array_equal(ours.labels, ref.labels)


@pytest.mark.parametrize("mode", DATA_MODES)
@pytest.mark.parametrize("name", NATURAL)
def test_config_equals_the_yaml(name, mode):
    assert load_config(name, mode).to_dict() == \
        jax_load_config(name, mode).to_dict()


def test_every_dataset_name_loads_a_config():
    from inverseproblemwithdiffusionmodel_tpu.config import (
        REGISTERED_CONFIG_FILENAME)
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_discrete import (
        DATASETS)
    assert sorted(DATASETS) == sorted(REGISTERED_CONFIG_FILENAME)
    over = {"model.ngf": 32, "data.image_size": 16}
    assert load_config("CELEBA", "real-imag", **over).to_dict() == \
        jax_load_config("CELEBA", "real-imag", **over).to_dict()
    with pytest.raises(KeyError, match="unknown dataset"):
        load_config("IMAGENET")


# -- CIFAR-10 -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_cifar10_stand_in_equals_jax(tmp_path, mode):
    ours = datasets.load_cifar10(str(tmp_path), mode)
    ref = jdatasets.load_cifar10(str(tmp_path), mode)
    assert_same(ours, ref)
    assert ours.data.shape == ((2048 if mode == "train" else 256), 32, 32, 3)
    assert datasets.data_provenance() == jdatasets.data_provenance()
    assert datasets.data_provenance()[f"CIFAR10/{mode}"]["source"] == \
        "synthetic"


def _write_cifar_batches(root):
    folder = root / "cifar-10-batches-py"
    folder.mkdir()
    rs = np.random.RandomState(0)
    for name, n in [(f"data_batch_{i}", 3) for i in range(1, 6)] + [
            ("test_batch", 4)]:
        batch = {b"data": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                 b"labels": list(rs.randint(0, 10, n))}
        with open(folder / name, "wb") as f:
            pickle.dump(batch, f)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar10_pickle_batches_load_as_jax_loads_them(tmp_path, mode):
    _write_cifar_batches(tmp_path)
    ours = datasets.load_data("CIFAR10", mode, root_dir=str(tmp_path))
    ref = jdatasets.load_data("CIFAR10", mode, root_dir=str(tmp_path))
    assert_same(ours, ref)
    assert ours.data.shape == ((15 if mode == "train" else 4), 32, 32, 3)
    assert 0.0 <= ours.data.min() and ours.data.max() <= 1.0
    assert datasets.data_provenance() == jdatasets.data_provenance()
    assert datasets.data_provenance()[f"CIFAR10/{mode}"]["source"] == "real"


def test_ncsn_original_loads_cifar10(tmp_path):
    """NCSN v1's recipe (data.dataset CIFAR10) loads CIFAR-10 in the port;
    the JAX package's load_data has no branch for its name."""
    _write_cifar_batches(tmp_path)
    ours = datasets.load_data("NCSN_ORIGINAL", "train",
                              root_dir=str(tmp_path))
    assert_same(ours, jdatasets.load_data("CIFAR10", "train",
                                          root_dir=str(tmp_path)))
    assert load_config("NCSN_ORIGINAL").data.dataset == "CIFAR10"
    with pytest.raises(KeyError):
        jdatasets.load_data("NCSN_ORIGINAL", "train",
                            root_dir=str(tmp_path))
    assert datasets.data_provenance()["NCSN_ORIGINAL/train"]["source"] == \
        "real"


# -- image folders ------------------------------------------------------------

@pytest.mark.parametrize("n,size,seed", [(3, 8, 0), (2, 13, 1), (1, 5, 7)])
def test_synthetic_rgb_equals_jax(n, size, seed):
    ours = datasets.synthetic_rgb(n, size, seed)
    np.testing.assert_array_equal(ours, jdatasets.synthetic_rgb(n, size,
                                                                seed))
    assert ours.shape == (n, size, size, 3) and ours.dtype == np.float32
    assert data.synthetic_rgb is datasets.synthetic_rgb


def _write_pngs(root, n):
    """n images of assorted sizes and modes (RGB, L, RGBA; png and jpg) in
    nested folders, with a stray text file."""
    rs = np.random.RandomState(3)
    for i in range(n):
        sub = root / f"part{i % 3}"
        sub.mkdir(parents=True, exist_ok=True)
        w, h = 10 + 3 * (i % 4), 9 + 2 * (i % 5)
        mode = ("RGB", "L", "RGBA")[i % 3]
        shape = (h, w) if mode == "L" else (h, w, len(mode))
        im = Image.fromarray(rs.randint(0, 256, shape).astype(np.uint8),
                             mode)
        if i % 4 == 3:
            im.convert("RGB").save(sub / f"img{i:03d}.JPG")
        else:
            im.save(sub / f"img{i:03d}.png")
    (root / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("n", [1, 3, 14])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_image_folder_splits_equal_jax(tmp_path, n, mode):
    _write_pngs(tmp_path, n)
    ours = datasets.load_image_folder(str(tmp_path), mode, size=12,
                                      name="CELEBA")
    ref = jdatasets.load_image_folder(str(tmp_path), mode, size=12,
                                      name="CELEBA")
    assert_same(ours, ref)
    assert ours.data.shape[1:] == (12, 12, 3)
    assert datasets.data_provenance() == jdatasets.data_provenance()


def test_empty_image_folder_gives_the_stand_in(tmp_path):
    for mode, count in (("train", 2048), ("val", 256)):
        ours = datasets.load_image_folder(str(tmp_path), mode, size=6)
        assert_same(ours, jdatasets.load_image_folder(str(tmp_path), mode,
                                                      size=6))
        assert ours.data.shape == (count, 6, 6, 3)
    missing = str(tmp_path / "absent")
    assert_same(datasets.load_image_folder(missing, "test", size=4),
                jdatasets.load_image_folder(missing, "test", size=4))
    assert datasets.data_provenance() == jdatasets.data_provenance()
    assert datasets.data_provenance()["images/test"]["source"] == \
        "synthetic"


@pytest.mark.parametrize("name", FOLDERS)
def test_load_data_image_branches_equal_jax(tmp_path, monkeypatch, name):
    """Each natural-image name reads its folder (PNGs here) at its
    registered size unless `size` says otherwise, and records the same
    provenance as JAX."""
    _write_pngs(tmp_path, 4)
    for mode in ("train", "val"):
        ours = datasets.load_data(name, mode, root_dir=str(tmp_path),
                                  size=10)
        ref = jdatasets.load_data(name, mode, root_dir=str(tmp_path),
                                  size=10)
        assert_same(ours, ref)
    assert datasets.data_provenance() == jdatasets.data_provenance()
    assert datasets.data_provenance()[f"{name}/train"]["source"] == "real"
    seen = {}

    def spy(module, key):
        real = module.load_image_folder

        def wrapped(root, mode="train", **kw):
            seen[key] = (root, mode, kw)
            return real(str(tmp_path), mode, size=4, name=kw.get("name"))
        monkeypatch.setattr(module, "load_image_folder", wrapped)

    spy(datasets, "ours")
    spy(jdatasets, "ref")
    datasets.load_data(name, "test")
    jdatasets.load_data(name, "test")
    root, _, kw = seen["ours"]
    assert seen["ours"][1:] == seen["ref"][1:]
    assert kw["size"] == {"CELEBA": 64, "BEDROOM": 128, "CHURCH": 64,
                          "TOWER": 128, "FFHQ": 256}[name]
    assert os.path.relpath(root, datasets.DATA_ROOT) == os.path.relpath(
        seen["ref"][0], jdatasets.DATA_ROOT)


def test_unknown_datasets_raise():
    with pytest.raises(KeyError, match="unknown dataset"):
        datasets.load_data("IMAGENET")
    assert sorted(datasets.REGISTERED_DATA_ROOT_DIR) == sorted(
        jdatasets.REGISTERED_DATA_ROOT_DIR)
