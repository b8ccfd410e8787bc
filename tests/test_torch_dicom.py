"""The port's DICOM front on the CPU against the JAX package's: the native
reader, the header helpers, record selection, ``BagLoader`` on DICOM
records with its pool of reads, and ``load_records`` on a metadata pickle.

The reader is held against JAX's ``read_dicom_native`` by running every
test of ``tests/test_dicom_native.py`` with its reader replaced by one that
reads each file through both packages: every transfer syntax those tests
write (explicit and implicit VR, RLE, deflate, JPEG lossless with all
predictors, point transform and restarts, JPEG baseline/extended, JPEG-LS
lossless and near-lossless, JPEG 2000) and every error path and mutation
fuzz case.  Pixels and metadata must be equal, and a file either package
refuses must raise the same message in the other.

Tolerances: everything here is compared exactly, except the bags of the
two packages' loaders, whose patches agree within 1e-5 (the JAX gather and
normalization against the port's plain versions); the port's bags with 3
read workers equal those with 1 bit for bit.
"""

import dataclasses
import inspect
import itertools
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import test_dicom_native as jt
from montecarlo_gated_mil_tpu import experiment as jexp
from montecarlo_gated_mil_tpu.core.config import config_from_dict as jax_config
from montecarlo_gated_mil_tpu.data import dicom as jdicom
from montecarlo_gated_mil_tpu.data import dicom_native as jdn
from montecarlo_gated_mil_tpu.data import pipeline as jpipe
from montecarlo_gated_mil_tpu.data import records as jrecords
from montecarlo_gated_mil_tpu_torch import experiment as texp
from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
from montecarlo_gated_mil_tpu_torch.data import dicom as tdicom
from montecarlo_gated_mil_tpu_torch.data import dicom_native as tdn
from montecarlo_gated_mil_tpu_torch.data import pipeline as tpipe
from montecarlo_gated_mil_tpu_torch.data import records as trecords

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
# What the JAX package's own loader writes into native/ when it finds no
# library there: the JAX tests may build it in another worker at any time.
JAX_LIBRARY = "libmcgmil_dicom.so"


@pytest.fixture(scope="module", autouse=True)
def _jax_library_outside_native(tmp_path_factory):
    """JAX's reader builds its library next to its source when it has none
    loaded; here it builds from a copy of that source in a temporary
    directory, so these tests write nothing into native/."""
    if jdn._lib is None:
        d = tmp_path_factory.mktemp("jax_native")
        shutil.copy2(os.path.join(NATIVE_DIR, "dicom.cc"), d / "dicom.cc")
        saved, jdn._NATIVE_DIR = jdn._NATIVE_DIR, str(d)
        try:
            jdn.load_library()
        finally:
            jdn._NATIVE_DIR = saved
    yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(m) -> tuple:
    return (m.patient_id, m.age, m.laterality)


def read_both(path):
    """JAX's ``read_dicom_native`` result, after checking that the port's
    reader gives the same pixels and metadata, or the same error."""
    try:
        want = jdn.read_dicom_native(path)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tdn.read_dicom_native(path)
        assert str(got.value) == str(e)
        raise
    img, meta = tdn.read_dicom_native(path)
    assert img.dtype == want[0].dtype and img.shape == want[0].shape
    assert np.array_equal(img, want[0])
    assert _meta(meta) == _meta(want[1])
    return want


def reader_both(root: str = ""):
    """JAX's native ``BagLoader`` reader, checked against the port's on
    every record it reads."""
    want_read = jdn.make_native_dicom_reader(root)
    got_read = tdn.make_native_dicom_reader(root)

    def read(rec):
        want = want_read(rec)
        got = got_read(rec)
        assert len(got.images) == len(want.images)
        for a, b in zip(got.images, want.images):
            assert np.array_equal(a, b)
        assert _meta(got.meta) == _meta(want.meta)
        return want

    return read


def _jax_dicom_cases():
    """``(name, function, params)`` for each case of the JAX DICOM tests."""
    for name, fn in vars(jt).items():
        if not (name.startswith("test_") and callable(fn)):
            continue
        grids = [[{}]]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name == "parametrize":
                argname, values = mark.args[0], mark.args[1]
                grids.append([{argname: v} for v in values])
        for combo in itertools.product(*grids):
            params = {k: v for d in combo for k, v in d.items()}
            label = "-".join(str(v) for v in params.values())
            yield pytest.param(fn, params, id=f"{name}[{label}]" if label else name)


@pytest.mark.parametrize("fn, params", list(_jax_dicom_cases()))
def test_reader_equals_jax_on_every_dicom_test(fn, params, tmp_path, monkeypatch):
    """Each test of ``tests/test_dicom_native.py`` passes with every file it
    reads, and every pair its loader reads, read by both packages and found
    equal (errors by their message)."""
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "skipif" and mark.args[0]:
            pytest.skip(mark.kwargs.get("reason", "skipped by the JAX test"))
    monkeypatch.setattr(jt, "read_dicom_native", read_both)
    monkeypatch.setattr(jt, "make_native_dicom_reader", reader_both)
    kwargs = {"tmp_path": tmp_path, **params}
    fn(**{k: kwargs[k] for k in inspect.signature(fn).parameters})


def _native_listing() -> dict:
    return {e.name: (e.stat().st_size, e.stat().st_mtime_ns)
            for e in os.scandir(NATIVE_DIR) if e.name != JAX_LIBRARY}


def test_library_builds_in_csrc_build_and_never_in_native(tmp_path, monkeypatch):
    """The port's library lives in its own ``csrc/build/``; a fresh build
    (g++ -O2 -shared -fPIC -lz) and reads through it write nothing in
    ``native/``, whose listing and mtimes stay as they were (but for the
    JAX package's own library, which its tests may be building meanwhile)."""
    before = _native_listing()
    pkg = os.path.dirname(os.path.dirname(tdn.__file__))
    assert tdn.library_path().parent == tdn.BUILD_DIR
    assert str(tdn.BUILD_DIR) == os.path.join(pkg, "csrc", "build")
    assert tdn.SOURCE.read_bytes() == open(os.path.join(NATIVE_DIR, "dicom.cc"), "rb").read()
    tdn.load_library()
    assert tdn.library_path().is_file()

    monkeypatch.setattr(tdn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tdn, "_lib", None)
    px = np.arange(12, dtype=np.uint16).reshape(3, 4) * 300
    jt._write_dicom(tmp_path / "a.dcm", 3, 4, 12, px)
    img, meta = tdn.read_dicom_native(tmp_path / "a.dcm")
    assert np.array_equal(img, px.astype(np.float32) / np.float32(4095))
    assert [p.name for p in (tmp_path / "build").iterdir()] == [tdn.library_path().name]
    assert _native_listing() == before


def test_missing_compiler_fails_loudly(tmp_path, monkeypatch):
    """Without g++ the build raises naming it; nothing stands in."""
    monkeypatch.setattr(tdn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tdn, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tdn.load_library()


def test_read_dicom_names_pydicom_where_absent():
    """The pydicom reader raises ``ImportError`` naming pydicom when it is
    absent, as JAX's does; ``HAVE_PYDICOM`` agrees with the JAX package."""
    assert tdicom.HAVE_PYDICOM == jdicom.HAVE_PYDICOM
    if tdicom.HAVE_PYDICOM:
        pytest.skip("pydicom is installed")
    for call in (lambda: tdicom.read_dicom("x.dcm"), tdicom.make_dicom_reader):
        with pytest.raises(ImportError, match="pydicom"):
            call()


@pytest.mark.parametrize("age", ["042Y", "42Y", "7Y", "1042Y", "Y", "006M", ""])
def test_parse_age_equals_jax(age):
    try:
        want = jdicom.parse_age(age)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tdicom.parse_age(age)
        assert str(got.value) == str(e)
        return
    assert tdicom.parse_age(age) == want


@pytest.mark.parametrize("bits", [8, 10, 12, 14, 16])
def test_normalize_dicom_pixels_equals_jax(bits):
    px = np.random.default_rng(bits).integers(0, 2**bits, (9, 7)).astype(
        np.uint8 if bits == 8 else np.uint16)
    got, want = tdicom.normalize_dicom_pixels(px, bits), jdicom.normalize_dicom_pixels(px, bits)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert got.max() <= 1.0


@pytest.mark.parametrize("paths", [
    ("/d/p_L_CC.dcm", "/d/p_L_MLO.dcm"),
    ("/d/p_R_MLO.dcm", "/d/p_R_CC.dcm"),
    ("p_L_CC.dcm", "p_L_MO.dcm"),
    ("/d/p_L_CC.dcm", "/d/p_L_CC2.dcm"),
    ("/ML/p_L_CC.dcm", "/x/p_L_XX.dcm"),
])
def test_split_cc_mlo_equals_jax(paths):
    try:
        want = jdicom.split_cc_mlo(paths)
    except ValueError:
        with pytest.raises(ValueError, match="CC or MLO not found"):
            tdicom.split_cc_mlo(paths)
        return
    assert tdicom.split_cc_mlo(paths) == want


# Patient table: complete pairs, a side with one view, a side whose file
# tags do not pair, and views that match several requested strings.
PATIENTS = [
    {"view": ["LCC", "LMLO", "RCC", "RMLO"], "class": ["Benign", "Benign", "Normal", "Normal"],
     "filename": ["a_L_CC.dcm", "a_L_MLO.dcm", "a_R_CC.dcm", "a_R_MLO.dcm"]},
    {"view": ["LCC", "RCC", "RMLO"], "class": ["Malignant", "Malignant", "Lymph_nodes"],
     "filename": ["b_L_CC.dcm", "b_R_CC.dcm", "b_R_MLO.dcm"]},
    {"view": ["LCC", "LMLO"], "class": ["Normal", "Normal"],
     "filename": ["c_L_CC.dcm", "c_X_MLO.dcm"]},
    {"view": ["RMLO", "LCC", "LMLO", "RCC"], "class": ["Lymph_nodes", "Benign", "Benign",
                                                       "Malignant"],
     "filename": ["d_R_MLO.dcm", "d_L_CC.dcm", "d_L_MLO.dcm", "d_R_CC.dcm"]},
]


@pytest.mark.parametrize("multimodal, view", [
    (True, ("CC", "MLO")), (False, ("CC", "MLO")), (False, ("MLO",)), (False, ("CC",)),
    (False, ("L",)),
])
def test_select_records_equals_jax(multimodal, view):
    """Multimodal pairs per side, incomplete pairs skipped; unimodal view
    matching: the port's records equal JAX's, field for field."""
    got = trecords.select_records(PATIENTS, view, multimodal)
    want = jrecords.select_records(PATIENTS, view, multimodal)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert [r.label for r in got] == [r.label for r in want]
    if multimodal:
        assert len(got) == 5  # c's left files do not pair; b has only its right pair


def _write_views(root, class_name, stem, views, rng, *, rows, cols, bits=12,
                 laterality=b"L", age=b"061Y", pid=b"PAT"):
    """One DICOM file per view under ``root/class_name/``, with a lobe of
    tissue against black so tiles pass the fill threshold."""
    d = root / class_name
    d.mkdir(parents=True, exist_ok=True)
    names = []
    yy, xx = np.mgrid[0:rows, 0:cols]
    for view in views:
        lobe = ((yy - rows / 2) / (rows * 0.45)) ** 2 + (xx / (cols * 0.8)) ** 2 < 1
        px = np.where(lobe, rng.integers(300, 2**bits, (rows, cols)), 0).astype(np.uint16)
        name = f"{stem}_{view}.dcm"
        jt._write_dicom(d / name, rows, cols, bits, px, patient_id=pid, age=age,
                        laterality=laterality)
        names.append(name)
    return tuple(names)


@pytest.fixture(scope="module")
def dicom_tree(tmp_path_factory):
    """DICOM files in the reference's layout: unimodal 64x64 views and
    48x96 CC+MLO pairs (a 96x96 composite), some headers' ImageLaterality
    differing from the table's."""
    root = tmp_path_factory.mktemp("dicom")
    rng = np.random.default_rng(5)
    uni, multi = [], []
    for k, (cls, table_lat, tag) in enumerate(
            [("Benign", "L", b"L"), ("Malignant", "R", b"L"), ("Normal", "L", b"R"),
             ("Lymph_nodes", "R", b"R")]):
        (name,) = _write_views(root, cls, f"u{k}_{table_lat}", ["CC"], rng, rows=64, cols=64,
                               laterality=tag, age=f"0{50 + k}Y".encode(), pid=f"U{k}".encode())
        uni.append(trecords.BagRecord(paths=(name,), class_name=cls, view=f"{table_lat}CC",
                                      laterality=table_lat))
        pair = _write_views(root, cls, f"m{k}_{table_lat}", ["CC", "MLO"], rng, rows=48, cols=96,
                            laterality=tag, pid=f"M{k}".encode())
        multi.append(trecords.BagRecord(paths=pair, class_name=cls, view="Left",
                                        laterality=table_lat))
    return root, uni, multi


def _jax_records(recs):
    return [jrecords.BagRecord(**dataclasses.asdict(r)) for r in recs]


def _bags(loader) -> list:
    return list(loader.epoch(0))


@pytest.mark.parametrize("multimodal", [False, True])
def test_bag_loader_on_dicom_equals_jax(dicom_tree, multimodal):
    """``BagLoader`` over DICOM records, one view or a CC+MLO pair, with 1
    and 3 read workers: patches within 1e-5 of JAX's, masks, tile indices
    and labels equal; the yielded records equal JAX's, the header's
    laterality, patient id and age in place; 3 workers give the bags of 1
    bit for bit."""
    root, uni, multi = dicom_tree
    recs = multi if multimodal else uni
    h, w = (96, 96) if multimodal else (64, 64)
    kw = dict(height=h, width=w, patch_size=32, overlap=0.0, empty_threshold=0.05, bucket=16)
    want = _bags(jpipe.BagLoader(_jax_records(recs), jdn.make_native_dicom_reader(str(root)),
                                 jpipe.PipelineConfig(**kw), multimodal=multimodal,
                                 io_workers=3))
    runs = {n: _bags(tpipe.BagLoader(recs, tdn.make_native_dicom_reader(str(root)),
                                     tpipe.PipelineConfig(**kw), multimodal=multimodal,
                                     io_workers=n, device="cpu"))
            for n in (1, 3)}
    for (bag, rec), (jbag, jrec), (bag3, rec3) in zip(runs[1], want, runs[3], strict=True):
        np.testing.assert_allclose(bag.patches.numpy(), np.asarray(jbag.patches), rtol=0,
                                   atol=1e-5)
        assert np.array_equal(bag.mask.numpy(), np.asarray(jbag.mask))
        assert np.array_equal(bag.tile_indices.numpy(), np.asarray(jbag.tile_indices))
        assert int(bag.label) == int(jbag.label)
        assert dataclasses.astuple(rec) == dataclasses.astuple(jrec) == dataclasses.astuple(rec3)
        for a, b in zip(dataclasses.astuple(bag), dataclasses.astuple(bag3)):
            assert torch.equal(a, b)
    lat = [r.laterality for _, r in runs[1]]
    assert lat == ["L", "L", "R", "R"]  # the header's, over the table's L, R, L, R
    assert [r.patient_id for _, r in runs[1]] == [
        f"{'M' if multimodal else 'U'}{k}" for k in range(4)]


def test_io_workers_bit_equal_on_arrays_and_refuses_zero():
    """Bags from numpy readers are the same with any ``io_workers``, the
    order kept even when reads finish out of order; ``io_workers=0``
    raises as in JAX."""
    import time

    rng = np.random.default_rng(2)
    images = [np.where(rng.random((64, 64)) < 0.8, rng.random((64, 64)), 0).astype(np.float32)
              for _ in range(7)]
    recs = [trecords.BagRecord(paths=(str(k),), class_name="Benign", view="LCC",
                               laterality="LR"[k % 2]) for k in range(7)]

    def reader(rec):
        k = int(rec.paths[0])
        time.sleep(0.002 * (7 - k))  # later records finish first
        return images[k]

    cfg = tpipe.PipelineConfig(height=64, width=64, patch_size=32, overlap=0.0,
                               empty_threshold=0.05, bucket=8, augment=True)
    runs = [_bags(tpipe.BagLoader(recs, reader, cfg, io_workers=n, shuffle=True, device="cpu"))
            for n in (1, 2, 4)]
    for bags in runs[1:]:
        for (a, ra), (b, rb) in zip(runs[0], bags, strict=True):
            assert ra == rb and all(torch.equal(x, y) for x, y in
                                    zip(dataclasses.astuple(a), dataclasses.astuple(b)))
    for mod, kw in ((tpipe, {"device": "cpu"}), (jpipe, {})):
        with pytest.raises(ValueError, match="io_workers must be >= 1"):
            mod.BagLoader(recs, reader, cfg, io_workers=0, **kw)


def test_stack_multimodal_equals_jax():
    """MLO over CC."""
    rng = np.random.default_rng(4)
    cc, mlo = rng.random((5, 3)).astype(np.float32), rng.random((4, 3)).astype(np.float32)
    got = tpipe.stack_multimodal(cc, mlo)
    assert got.shape == (9, 3) and np.array_equal(got, np.asarray(jpipe.stack_multimodal(cc, mlo)))


def _pickle_config(tmp_path, root, multimodal, view):
    import pandas as pd

    table = tmp_path / "meta.pkl"
    pd.DataFrame(PATIENTS).to_pickle(table)
    raw = {"data": {"synthetic_count": 0, "metadata_path": str(table), "root_path": str(root),
                    "multimodal": multimodal, "view": list(view)}}
    return raw


@pytest.mark.parametrize("multimodal", [True, False])
def test_load_records_from_pickle_equals_jax(tmp_path, multimodal):
    """The DICOM branch of ``load_records``: a pandas pickle of the patient
    table gives JAX's records, and a native reader that reads the files
    under ``root/<class>/`` as JAX's does."""
    pytest.importorskip("pandas")
    root = tmp_path / "root"
    rng = np.random.default_rng(6)
    for p in PATIENTS:  # a pair's record takes one file's class: each file under each
        for f in p["filename"]:
            px = rng.integers(0, 4096, (8, 6), dtype=np.uint16)
            for cls in set(p["class"]):
                (root / cls).mkdir(parents=True, exist_ok=True)
                jt._write_dicom(root / cls / f, 8, 6, 12, px)
    raw = _pickle_config(tmp_path, root, multimodal, ("CC", "MLO"))
    got, read = texp.load_records(config_from_dict(raw))
    want, jread = jexp.load_records(jax_config(raw))
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert len(got) == (5 if multimodal else 13)
    for rec, jrec in zip(got, want):
        a, b = read(rec), jread(jrec)
        assert isinstance(a, trecords.PixelData)
        assert all(np.array_equal(x, y) for x, y in zip(a.images, b.images, strict=True))
        assert _meta(a.meta) == _meta(b.meta)


def test_load_records_without_pandas_raises(tmp_path, monkeypatch):
    """Without pandas the DICOM branch raises ``ImportError``; it never
    falls back to synthetic records."""
    raw = {"data": {"synthetic_count": 0, "metadata_path": str(tmp_path / "meta.pkl")}}
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        texp.load_records(config_from_dict(raw))


def test_full_width_rle_header_fields(tmp_path):
    """A 16-bit RLE file with 14 stored bits and a partial header (no
    age): pixels divided by 2^14 - 1 exactly, age -1, as JAX reads it."""
    rng = np.random.default_rng(8)
    px = rng.integers(0, 2**14, (40, 33), dtype=np.uint16)
    p = tmp_path / "r.dcm"
    jt._write_encapsulated(p, 40, 33, 14, b"1.2.840.10008.1.2.5", jt._rle_frame(px))
    raw = p.read_bytes()
    age = jt._el_explicit(0x0010, 0x1010, b"AS", b"042Y")
    p.write_bytes(raw.replace(age, b""))
    img, meta = read_both(p)
    assert np.array_equal(img, px.astype(np.float32) / np.float32(2**14 - 1))
    assert meta.age == -1 and meta.patient_id == "PATRLE"
