"""The port's numpy-only HDF5 subset (``data/hdf5.py``) against h5py, the
yardstick: label files that h5py writes at superblock versions 0 and 3 read
back equal, with the data where h5py puts it; chunked, filtered, missing
and other unreadable datasets refused by name; the writer's files read back
by h5py and by the reader; ``CocoData`` on files of either package equal
to the JAX package's; and the per-image feature files read and written
with one call each, as np.load and np.save."""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from nes_img_captioning_tpu_torch.data import hdf5

from torch_pin import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LIBVERS = ("earliest", "latest")  # superblock versions 0 and 3


def _reference_arrays(n_images=7, seq_length=16, seed=0):
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, 6, size=n_images)
    end = np.cumsum(caps)
    start = end - caps + 1
    return {
        "labels": rng.integers(0, 9488, size=(int(end[-1]), seq_length)
                               ).astype(np.uint32),
        "label_start_ix": start.astype(np.uint32),
        "label_end_ix": end.astype(np.uint32),
        "label_length": rng.integers(1, seq_length + 1,
                                     size=int(end[-1])).astype(np.uint32),
    }


def _other_arrays(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "i32": rng.integers(-2**31, 2**31, size=(5, 3), dtype=np.int32),
        "i64": rng.integers(-2**62, 2**62, size=11, dtype=np.int64),
        "u4be": rng.integers(0, 2**32, size=(4, 2), dtype=np.uint32
                             ).astype(">u4"),
        "f32": rng.normal(size=6).astype(np.float32),
        "f8be": rng.normal(size=(2, 2)).astype(">f8"),
    }


def _h5py_file(path, arrays, libver, compact=None):
    with h5py.File(path, "w", libver=libver) as f:
        for name, a in arrays.items():
            f.create_dataset(name, data=a)
        if compact is not None:
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            space = h5py.h5s.create_simple(compact.shape)
            tid = h5py.h5t.py_create(compact.dtype)
            ds = h5py.h5d.create(f.id, b"compact", tid, space, dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, compact)


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("kind", ["reference", "other"])
def test_reader_equals_h5py(tmp_path, libver, kind):
    """Every dataset equals h5py's read (dtype, byte order, shape and
    values) and its data lies where h5py says (``get_offset``); a compact
    dataset's bytes come from its header."""
    arrays = _reference_arrays() if kind == "reference" else _other_arrays()
    compact = np.arange(12, dtype=np.int16).reshape(3, 4) - 5
    path = str(tmp_path / "f.h5")
    _h5py_file(path, arrays, libver, compact=compact)
    with open(path, "rb") as f:
        assert f.read(9)[8] == (0 if libver == "earliest" else 3)
    names = [*arrays, "compact"]
    got = hdf5.read_datasets(path, names)
    info = hdf5.dataset_info(path, names)
    with h5py.File(path, "r") as f:
        for name in names:
            want = f[name][()]
            assert got[name].dtype == want.dtype, name
            assert got[name].shape == want.shape, name
            assert np.array_equal(got[name], want), name
            assert info[name]["offset"] == f[name].id.get_offset(), name
    assert info["compact"]["layout"] == "compact"
    assert all(info[n]["layout"] == "contiguous" for n in arrays)


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("case", ["chunked", "gzip", "missing",
                                  "string", "soft_link"])
def test_reader_refuses(tmp_path, libver, case):
    """What the subset does not cover raises ValueError naming the dataset
    and what was found, never an array."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("labels", data=np.arange(64, dtype=np.uint32))
        if case == "chunked":
            f.create_dataset("bad", data=np.arange(64), chunks=(16,))
        elif case == "gzip":
            f.create_dataset("bad", data=np.arange(64), compression="gzip")
        elif case == "string":
            f.create_dataset("bad", data=np.array([b"a", b"bc"]))
        elif case == "soft_link":
            f["bad"] = h5py.SoftLink("/labels")
    what = {"chunked": "chunked storage", "gzip": "filter pipeline",
            "missing": "no such dataset", "string": "string",
            "soft_link": "soft link"}[case]
    with pytest.raises(ValueError, match=f"'bad'.*{what}"):
        hdf5.read_datasets(path, ["labels", "bad"])
    assert np.array_equal(hdf5.read_datasets(path, ["labels"])["labels"],
                          np.arange(64, dtype=np.uint32))


def test_reader_refuses_dense_links(tmp_path):
    """A group past h5py's compact-link limit keeps its links in a fractal
    heap, which the reader does not walk: refused, not misread."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(12):
            f.create_dataset(f"d{i}", data=np.arange(i + 1))
    with pytest.raises(ValueError, match="'d3'.*dense link storage"):
        hdf5.read_datasets(path, ["d3"])


@pytest.mark.parametrize("kind", ["reference", "other", "edge"])
def test_writer_read_by_h5py_and_reader(tmp_path, kind):
    """write_datasets' files (superblock 0, one symbol-table node) open in
    h5py with every array equal, and the reader returns the same."""
    if kind == "reference":
        arrays = _reference_arrays(n_images=40)
    elif kind == "other":
        arrays = _other_arrays()
    else:
        arrays = {"scalar": np.float32(2.5), "empty": np.zeros((0, 3),
                                                                np.int64),
                  "u1": np.arange(7, dtype=np.uint8),
                  "i2be": np.array([-3, 300], ">i2")}
    path = str(tmp_path / "w.h5")
    hdf5.write_datasets(path, arrays)
    got = hdf5.read_datasets(path, list(arrays))
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(arrays)
        for name, a in arrays.items():
            a = np.asarray(a)
            for b in (f[name][()], got[name]):
                assert b.dtype == a.dtype and b.shape == a.shape, name
                assert np.array_equal(b, a), name


def test_writer_refuses(tmp_path):
    path = str(tmp_path / "w.h5")
    with pytest.raises(ValueError, match="symbol-table node"):
        hdf5.write_datasets(path, {f"d{i}": np.arange(3) for i in range(9)})
    with pytest.raises(ValueError, match="'s'"):
        hdf5.write_datasets(path, {"s": np.array(["a"])})
    assert not os.path.exists(path)


def _coco_equal(a, b):
    assert a.vocab_size == b.vocab_size and a.seq_length == b.seq_length
    assert a.labels.dtype == b.labels.dtype == np.int32
    assert np.array_equal(a.labels, b.labels)
    for k in ("label_start_ix", "label_end_ix"):
        assert getattr(a, k).dtype == getattr(b, k).dtype == np.int64
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert a.split_ix == b.split_ix
    for split in ("train", "val", "test"):
        ga, gb = a.split_gts(split), b.split_gts(split)
        assert len(ga) == len(gb)
        assert all(np.array_equal(x, y) for x, y in zip(ga, gb))
        fa, fb = a.split_feats(split), b.split_feats(split)
        assert fa.dtype == fb.dtype == np.float32
        assert np.array_equal(fa, fb)


def test_coco_data_equals_jax_on_h5py_files(tmp_path):
    """The JAX fixture (its label file written by h5py): the port's
    CocoData reads what JAX's CocoData reads."""
    from nes_img_captioning_tpu.data.mscoco import CocoData as JCocoData
    from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData

    copts = make_synthetic_coco(str(tmp_path / "jax"), n_train=24, n_val=6,
                                n_test=5, vocab_size=25, fc_feat_size=8)
    _coco_equal(CocoData(copts), JCocoData(copts))


def test_jax_reads_the_ports_files(tmp_path):
    """The port's write_synthetic_coco (its own HDF5 writer): JAX's
    CocoData (through h5py) and the port's read the same, and both equal
    the arrays they were written from; the JAX package's fixture writer
    draws the same files' contents."""
    from nes_img_captioning_tpu.data.mscoco import CocoData as JCocoData
    from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
        write_synthetic_coco,
    )

    kw = dict(n_train=24, n_val=6, n_test=5, vocab_size=25, fc_feat_size=8)
    arrays = synthetic_coco_arrays(**kw)
    copts = write_synthetic_coco(str(tmp_path / "port"), arrays)
    port = CocoData(copts)
    _coco_equal(port, JCocoData(copts))
    _coco_equal(port, CocoData.from_arrays(arrays))
    _coco_equal(port, JCocoData(make_synthetic_coco(str(tmp_path / "jax"),
                                                    **kw)))


def test_feature_files_read_as_np_load(tmp_path):
    """CocoData's first load (``read_feature_files``) gives np.load's arrays
    cast to f32 for files whose headers differ from the first's (f64,
    Fortran order, big-endian, f16) and refuses a file of another shape;
    ``write_synthetic_coco`` writes np.save's bytes."""
    from nes_img_captioning_tpu_torch.data.mscoco import read_feature_files
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
        write_synthetic_coco,
    )

    rng = np.random.default_rng(0)
    rows = [rng.random((2, 4)).astype(np.float32), rng.random((2, 4)),
            rng.random((2, 4)).astype(np.float32),
            np.asfortranarray(rng.random((2, 4)).astype(np.float32)),
            rng.random((2, 4)).astype(">f4"),
            rng.random((2, 4)).astype(np.float16)]
    paths = []
    for i, row in enumerate(rows):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], row)
    got = read_feature_files(paths)
    want = np.stack([np.load(p).astype(np.float32) for p in paths])
    assert got.dtype == np.float32 and np.array_equal(got, want)
    np.save(tmp_path / "other.npy", np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="other.npy"):
        read_feature_files(paths + [str(tmp_path / "other.npy")])

    arrays = synthetic_coco_arrays(n_train=4, n_val=1, n_test=1,
                                   fc_feat_size=8)
    copts = write_synthetic_coco(str(tmp_path / "coco"), arrays)
    for img_id, feat in zip(arrays["ids"], arrays["feats"]):
        np.save(tmp_path / "ref.npy", feat)
        with open(os.path.join(copts["input_fc_dir"], f"{img_id}.npy"),
                  "rb") as f, open(tmp_path / "ref.npy", "rb") as g:
            assert f.read() == g.read()


def test_no_h5py_in_the_port(tmp_path):
    """The port reads and writes its label files with h5py blocked."""
    code = (
        "import sys, tempfile, os\n"
        "sys.modules['h5py'] = None\n"
        "from nes_img_captioning_tpu_torch.data.mscoco import CocoData\n"
        "from nes_img_captioning_tpu_torch.data.synthetic import (\n"
        "    synthetic_coco_arrays, write_synthetic_coco)\n"
        "arrays = synthetic_coco_arrays(n_train=8, n_val=2, n_test=2)\n"
        "d = tempfile.mkdtemp(dir=sys.argv[1])\n"
        "data = CocoData(write_synthetic_coco(d, arrays))\n"
        "assert (data.labels == arrays['labels']).all()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
