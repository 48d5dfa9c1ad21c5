"""The port's native C++ prefetching batcher (data/native_loader.py,
native/batcher.cpp) held to the JAX package's.

The JAX package's native/batcher.cpp is compiled here with g++ into
tmp_path (never next to its source) and bound with the port's ctypes
declarations; the port's library gives the same batches for a seed, over 3
epochs, shuffled or not, with and without drop_last, and both equal the
plain version (`reference_batches`). Then the JAX package's own native
loader cases against the port, `make_train_iterator`'s feed and fallback,
where the port builds, and train_ncsn's --no_native_loader.
"""
import ctypes
import os

import numpy as np
import pytest

from inverseproblemwithdiffusionmodel_tpu_torch.data import native_loader
from inverseproblemwithdiffusionmodel_tpu_torch.data.native_loader import (
    NativeBatchIterator, native_available, native_batch_iterator,
    reference_batches, reference_permutation)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SRC = os.path.join(ROOT, "inverseproblemwithdiffusionmodel_tpu",
                       "native", "batcher.cpp")

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="g++ toolchain unavailable")


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_batcher") / "libbatcher.so")
    return native_loader.bind(ctypes.CDLL(native_loader.build(JAX_SRC,
                                                              path)))


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_same_batches_as_the_jax_batcher_over_three_epochs(
        jax_lib, shuffle, drop_last):
    n, batch, seed = 11, 3, 1234
    data = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    ours = NativeBatchIterator(data, batch, shuffle=shuffle, seed=seed,
                               drop_last=drop_last)
    theirs = NativeBatchIterator(data, batch, shuffle=shuffle, seed=seed,
                                 drop_last=drop_last, lib=jax_lib)
    assert ours.batches_per_epoch == theirs.batches_per_epoch == (
        3 if drop_last else 4)
    plain = reference_batches(n, batch, shuffle=shuffle, seed=seed,
                              drop_last=drop_last)
    for _ in range(3 * ours.batches_per_epoch):
        a, b = ours.next(), theirs.next()
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, data[next(plain)])
    ours.close()
    theirs.close()


def test_reference_permutation_is_a_permutation_per_epoch():
    perms = [reference_permutation(50, 7, e) for e in range(3)]
    for p in perms:
        assert sorted(p.tolist()) == list(range(50))
    assert not np.array_equal(perms[0], perms[1])
    np.testing.assert_array_equal(reference_permutation(5, 7, 0, False),
                                  np.arange(5))


def test_builds_into_a_per_hash_directory_never_in_place():
    path = native_loader.library_path()
    build_root = os.path.join(ROOT, "inverseproblemwithdiffusionmodel_tpu_"
                              "torch", "_build")
    assert os.path.dirname(os.path.dirname(path)) == build_root
    assert len(os.path.basename(os.path.dirname(path))) == 16
    assert os.path.isfile(path)
    native_dir = os.path.dirname(native_loader._SRC)
    assert os.listdir(native_dir) == ["batcher.cpp"]


def test_epoch_covers_all_samples_without_repeats():
    data = np.arange(24, dtype=np.float32).reshape(12, 2)
    it = NativeBatchIterator(data, 4, shuffle=True, seed=3)
    assert it.batches_per_epoch == 3
    ids = []
    for _ in range(3):
        b = it.next()
        ids.extend((b[:, 0] // 2).astype(int).tolist())
    assert sorted(ids) == list(range(12))
    it.close()


def test_rows_are_intact_samples():
    rng = np.random.RandomState(0)
    data = rng.rand(16, 3, 5).astype(np.float32)
    it = NativeBatchIterator(data, 4, shuffle=True, seed=1)
    b = it.next()
    flat = data.reshape(16, -1)
    for row in b.reshape(4, -1):
        assert any(np.array_equal(row, s) for s in flat)
    it.close()


def test_shuffle_changes_order_and_seed_reproducible():
    data = np.arange(64, dtype=np.float32).reshape(32, 2)
    a = NativeBatchIterator(data, 32, shuffle=True, seed=7).next()
    b = NativeBatchIterator(data, 32, shuffle=True, seed=7).next()
    c = NativeBatchIterator(data, 32, shuffle=True, seed=8).next()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[:, 0], np.sort(a[:, 0]))


def test_drop_last_false_short_tail():
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    it = NativeBatchIterator(data, 2, shuffle=False, drop_last=False, seed=0)
    assert it.batches_per_epoch == 3
    seen = [it.next() for _ in range(3)]
    assert [s.shape for s in seen] == [(2, 2), (2, 2), (1, 2)]
    np.testing.assert_array_equal(np.concatenate(seen), data)
    assert it.next().shape == (2, 2)
    it.close()


def test_factory_epoch_api():
    data = np.random.RandomState(1).rand(9, 4).astype(np.float32)
    mk = native_batch_iterator(data, 3, seed=2)
    assert sum(1 for _ in mk()) == 3
    assert sum(1 for _ in mk()) == 3
    mk.iterator.close()


def test_create_refuses_a_batch_larger_than_the_data_with_drop_last():
    with pytest.raises(RuntimeError, match="batcher_create failed"):
        NativeBatchIterator(np.zeros((3, 2), np.float32), 4)


def test_make_train_iterator_prefers_native_and_falls_back(monkeypatch):
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        make_train_iterator)
    data = np.random.RandomState(0).rand(20, 3, 3).astype(np.float32)
    make = make_train_iterator(data, 4, seed=5)
    assert make.feed == "native" and hasattr(make, "iterator")
    batches = list(make())
    assert len(batches) == 5 and all(b.shape == (4, 3, 3) for b in batches)
    order = np.concatenate([b.reshape(4, -1) for b in batches])
    np.testing.assert_array_equal(
        order, data[reference_permutation(20, 5, 0)].reshape(20, -1))
    make.iterator.close()
    make_np = make_train_iterator(data, 4, seed=5, prefer_native=False)
    assert make_np.feed == "numpy" and len(list(make_np())) == 5
    # no g++: the build fails once and the numpy feed is taken
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_error", None)
    monkeypatch.setattr(native_loader, "build", lambda *a, **k: (
        _ for _ in ()).throw(OSError("g++ not found on PATH")))
    assert not native_available()
    fallback = make_train_iterator(data, 4, seed=5)
    assert fallback.feed == "numpy" and len(list(fallback())) == 5
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        NativeBatchIterator(data, 4)


@pytest.mark.parametrize("flag,feed", [([], "native"),
                                       (["--no_native_loader"], "numpy")])
def test_train_ncsn_no_native_loader_changes_the_feed(monkeypatch, tmp_path,
                                                      flag, feed):
    """train_ncsn's feed, read off the factory fit receives (fit itself is
    replaced by one epoch of the feed)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import train_ncsn
    seen = {}

    def fake_fit(state, step, train_iter_fn, cfg, **kw):
        seen["feed"] = train_iter_fn.feed
        seen["batches"] = [b.shape for b in train_iter_fn()]
        return state

    monkeypatch.setattr(train_ncsn, "fit", fake_fit)
    train_ncsn.main(["--ds_name", "ACDC", "--mode", "real-imag", "--device",
                     "cpu", "--batch_size", "8", "--override",
                     "data.image_size=32", "--override", "model.ngf=8",
                     "--log_dir", str(tmp_path)] + flag)
    assert seen["feed"] == feed
    assert seen["batches"] == [(8, 256, 256, 1)] * 3
