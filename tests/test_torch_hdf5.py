"""The port's HDF5 reader (`utils/hdf5.read_dataset`) against h5py, bit
for bit, on files h5py writes with its default `libver="earliest"`: the
contiguous layout, gzip chunks (the renderer's `compression="gzip"`),
gzip with shuffle, edge chunks, float64, deep chunk B-trees, nested
groups, bytes in memory, the committed MegaDepth fixture's maps and
the committed 608x800 map.
What it does not read raises ValueError naming it."""

from pathlib import Path

import h5py
import numpy as np
import pytest

from accelerated_features_tpu_torch.utils.hdf5 import read_dataset

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "megadepth_mini"
FULL_SIZE = FIXTURE.parent / "megadepth_depth_608x800" / "depth.h5"


def _write(path, data, name="depth", **kw):
    with h5py.File(path, "w") as f:
        f.create_dataset(name, data=data, **kw)


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("kw", [
    {}, {"compression": "gzip"}, {"compression": "gzip", "shuffle": True},
    {"chunks": (38, 60), "compression": "gzip"},
    {"chunks": (7, 9), "compression": "gzip", "compression_opts": 9},
    {"chunks": (5, 5)}, {"chunks": (16, 16), "shuffle": True}],
    ids=["contiguous", "gzip", "gzip+shuffle", "gzip-edge-chunks",
         "gzip9-small-chunks", "chunked-unfiltered", "shuffle-only"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_equals_h5py(tmp_path, kw, dtype):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 80, (61, 83)).astype(dtype)
    depth[rng.uniform(size=depth.shape) < 0.3] = 0   # no-depth holes
    path = tmp_path / "d.h5"
    _write(path, depth, **kw)
    with h5py.File(path, "r") as f:
        ref = f["depth"][()]
    _same(read_dataset(path), ref)
    _same(read_dataset(path.read_bytes()), ref)


def test_full_size_depth_map_as_the_renderer_writes_it(tmp_path):
    """608x800 float32 with compression="gzip": h5py picks (38, 100)
    chunks, layout class 2."""
    depth = np.random.default_rng(0).uniform(1, 9, (608, 800)).astype(
        np.float32)
    path = tmp_path / "d.h5"
    _write(path, depth, compression="gzip")
    with h5py.File(path, "r") as f:
        assert f["depth"].chunks == (38, 100)
    _same(read_dataset(path), depth)


def test_deep_chunk_tree_and_many_groups(tmp_path):
    """Thousands of chunks need a B-tree of more than one level; forty
    groups need several symbol nodes; paths walk nested groups."""
    rng = np.random.default_rng(1)
    d = rng.standard_normal((300, 410)).astype(np.float32)
    path = tmp_path / "d.h5"
    with h5py.File(path, "w") as f:
        for i in range(40):
            f.create_dataset(f"g{i}/depth", data=d * i)
        f.create_dataset("a/b/c/depth", data=d, chunks=(4, 8),
                         compression="gzip", shuffle=True)
    _same(read_dataset(path, "a/b/c/depth"), d)
    _same(read_dataset(path, "g37/depth"), d * np.float32(37))
    with pytest.raises(KeyError):
        read_dataset(path, "nope")


def test_three_dimensions(tmp_path):
    d = np.random.default_rng(2).standard_normal((5, 7, 3))
    path = tmp_path / "d.h5"
    _write(path, d, chunks=(2, 3, 2), compression="gzip")
    _same(read_dataset(path), d)


@pytest.mark.parametrize("case", ["lzf", "fletcher32", "int32", "latest",
                                  "big-endian", "not-hdf5"])
def test_refuses_what_it_does_not_read(tmp_path, case):
    path = tmp_path / "d.h5"
    d = np.ones((10, 10), np.float32)
    if case == "lzf":
        _write(path, d, chunks=(5, 5), compression="lzf")
    elif case == "fletcher32":
        _write(path, d, chunks=(5, 5), fletcher32=True)
    elif case == "int32":
        _write(path, d.astype(np.int32))
    elif case == "big-endian":
        _write(path, d.astype(">f4"))
    elif case == "latest":
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("depth", data=d)
    else:
        path.write_bytes(b"not an hdf5 file" * 8)
    match = {"lzf": "filter", "fletcher32": "fletcher32", "int32":
             "datatype class 0", "latest": "superblock version",
             "big-endian": "big-endian", "not-hdf5": "not an HDF5"}[case]
    with pytest.raises(ValueError, match=match):
        read_dataset(path)


@pytest.mark.parametrize("h5", sorted(FIXTURE.rglob("*.h5")),
                         ids=lambda p: str(p.relative_to(FIXTURE)))
def test_fixture_depths_equal_h5py_and_their_twins(h5):
    with h5py.File(h5, "r") as f:
        ref = f["depth"][()]
    got = read_dataset(h5)
    _same(got, ref)
    _same(got, np.load(h5.with_suffix(".npy")))


def test_committed_full_size_map_equals_h5py_and_its_twin():
    """The committed 608x800 map, gzip-chunked by h5py in (38, 100)
    chunks: bit for bit h5py's read and its `.npy` twin."""
    with h5py.File(FULL_SIZE, "r") as f:
        assert f["depth"].chunks == (38, 100)
        assert f["depth"].compression == "gzip"
        ref = f["depth"][()]
    assert ref.shape == (608, 800) and ref.dtype == np.float32
    got = read_dataset(FULL_SIZE.read_bytes())
    _same(got, ref)
    _same(got, np.load(FULL_SIZE.with_suffix(".npy")))
