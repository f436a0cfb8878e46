"""The port's data plane against grl_tpu's, on the CPU: JPEG decode, the
real catalogs (MARS, DukeMTMC-VideoReID, iLIDS-VID, PRID-2011) and
``get_data``.

Layouts come from ``tools/make_fake_mars.py``, ``tools/make_fake_duke.py``
and ``tests/test_sequence_catalogs.py``; each package gets its own copy
of a layout (same seed, same bytes), so their split caches never mix until
a test crosses them on purpose. Every comparison is exact: decoded pixels
bit for bit, catalogs entry for entry, batches uint8 for uint8.
"""

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest

from grl_tpu.data import get_data as j_get_data
from grl_tpu.data import jpeg as jjpeg
from grl_tpu.data import catalogs as jcatalogs
from grl_tpu_torch.data import get_data
from grl_tpu_torch.data import jpeg
from grl_tpu_torch.data import catalogs
from test_sequence_catalogs import make_layout, make_raw_ilids, make_raw_prid

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..", "tools"))
from make_fake_duke import make_fake_duke  # noqa: E402
from make_fake_mars import make_fake_mars  # noqa: E402


# ---- JPEG decode ----

@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(0)
    out = {}
    for name, (h, w) in {"small": (40, 20), "large": (150, 70), "exact": (64, 32)}.items():
        x = np.clip(rng.rand(h, w, 3) * 64 + np.linspace(0, 180, w)[None, :, None], 0, 255)
        Image.fromarray(x.astype(np.uint8)).save(d / f"{name}.jpg", quality=90)
        out[name] = str(d / f"{name}.jpg")
    Image.fromarray(rng.randint(0, 256, (30, 20, 3)).astype(np.uint8)).save(d / "frame.png")
    out["png"] = str(d / "frame.png")
    return out


@pytest.mark.parametrize("route", ["native", "pil"])
@pytest.mark.parametrize("image", ["small", "large", "exact"], ids=["upscale", "downscale", "same-size"])
def test_decode_resize_equals_grl_tpu(images, route, image, monkeypatch):
    """Bit-equal to grl_tpu's decode_resize through the native routine (built
    from the port's own source) and through PIL."""
    if route == "pil":
        monkeypatch.setattr(jpeg, "_load", lambda: False)
        monkeypatch.setattr(jjpeg, "_load", lambda: False)
    else:
        assert jpeg.native_available(), jpeg.NATIVE_INFO
        assert jjpeg.native_available()
        assert jpeg.BUILD_DIR.name == "host" and jpeg.BUILD_DIR.parent.name == "build"
    got = jpeg.decode_resize(images[image], 64, 32)
    assert got.shape == (64, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jjpeg.decode_resize(images[image], 64, 32))


def test_non_jpeg_falls_back_to_pil(images):
    got = jpeg.decode_resize(images["png"], 48, 24)
    np.testing.assert_array_equal(got, jjpeg.decode_resize(images["png"], 48, 24))
    np.testing.assert_array_equal(got, jpeg.decode_pil(images["png"], 48, 24))


# ---- catalogs ----

def rel(tracklets, root):
    return [(tuple(osp.relpath(p, root) for p in paths), pid, cam) for paths, pid, cam in tracklets]


def assert_same_catalog(ours, theirs, root_ours, root_theirs, splits):
    for split in splits:
        assert rel(getattr(ours, split), root_ours) == rel(getattr(theirs, split), root_theirs), split
    for attr in ("num_train_pids", "num_query_pids", "num_gallery_pids", "num_trainval_ids"):
        if hasattr(theirs, attr):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
    for info in ("queryinfo", "galleryinfo"):
        if hasattr(theirs, info):
            assert vars(getattr(ours, info)) == vars(getattr(theirs, info)), info


def two_roots(tmp_path, make, **kw):
    """The same layout twice: (the port's root, grl_tpu's root)."""
    return make(str(tmp_path / "port"), **kw), make(str(tmp_path / "jax"), **kw)


def caches(root):
    return {n: os.stat(osp.join(root, n)).st_mtime_ns for n in os.listdir(root) if n.endswith(".json")}


@pytest.mark.parametrize("name", ["mars", "duke"])
def test_catalog_and_cache_equal_grl_tpu(tmp_path, name):
    make = make_fake_mars if name == "mars" else make_fake_duke
    ours_root, theirs_root = two_roots(tmp_path, make, train_ids=3, test_ids=2, frames_range=(3, 7),
                                       height=32, width=16)
    cls, jcls = {"mars": (catalogs.Mars, jcatalogs.Mars),
                 "duke": (catalogs.DukeMTMCVidReID, jcatalogs.DukeMTMCVidReID)}[name]
    splits = ("train", "query", "gallery") + (("train_dense",) if name == "duke" else ())
    ours, theirs = cls(ours_root), jcls(theirs_root)
    assert len(ours.train) and len(ours.query) and len(ours.gallery)
    assert_same_catalog(ours, theirs, ours_root, theirs_root, splits)
    assert sorted(caches(ours_root)) == sorted(caches(theirs_root))
    for n in caches(ours_root):  # byte for byte, but for the roots in the paths
        a = open(osp.join(ours_root, n)).read().replace(ours_root, "ROOT")
        assert a == open(osp.join(theirs_root, n)).read().replace(theirs_root, "ROOT"), n

    # each reads the other's cache (unchanged: not parsed and rewritten)
    before = caches(theirs_root), caches(ours_root)
    assert_same_catalog(cls(theirs_root), theirs, theirs_root, theirs_root, splits)
    assert_same_catalog(jcls(ours_root), ours, ours_root, ours_root, splits)
    assert (caches(theirs_root), caches(ours_root)) == before


def test_sequence_catalogs_equal_grl_tpu(tmp_path):
    root = make_layout(tmp_path, num_ids=6, frames_per_cam=12)
    for cls, jcls in ((catalogs.iLIDSVIDSequence, jcatalogs.iLIDSVIDSequence),
                      (catalogs.PRID2011Sequence, jcatalogs.PRID2011Sequence)):
        for kw in (dict(split_id=0, seq_len=8, seq_srd=4, num_val=0.3), dict(seq_len=4, seq_srd=2, seed=3)):
            assert_same_catalog(cls(root, **kw), jcls(root, **kw), root, root,
                                ("train", "val", "trainval", "query", "gallery"))
    with pytest.raises(RuntimeError):
        catalogs.iLIDSVIDSequence(str(tmp_path / "nope"))
    with pytest.raises(ValueError):
        catalogs.iLIDSVIDSequence(root, split_id=99)


@pytest.mark.parametrize("name", ["ilids", "prid"])
def test_prepare_equals_grl_tpu_and_crosses(tmp_path, name):
    """Raw tarball (iLIDS) or extracted tree (PRID) -> the canonical layout:
    the same images, meta.json and splits.json from both packages, and each
    package's catalog reads the other's layout alike."""
    import shutil
    import tarfile

    if name == "ilids":
        staged = make_raw_ilids(tmp_path, num_ids=4, frames=10)
        roots = []
        for who in ("port", "jax"):
            root = tmp_path / who
            (root / "raw").mkdir(parents=True)
            with tarfile.open(root / "raw" / "iLIDS-VID.tar", "w") as tar:
                tar.add(osp.join(staged, "raw", "iLIDS-VID", "i-LIDS-VID"), arcname="i-LIDS-VID")
            roots.append(str(root))
        prep, jprep = catalogs.prepare_ilidsvid, jcatalogs.prepare_ilidsvid
        cls, jcls, kw = catalogs.iLIDSVIDSequence, jcatalogs.iLIDSVIDSequence, dict(split_id=1)
    else:
        staged = make_raw_prid(tmp_path, num_ids=5, frames=8)
        roots = [shutil.copytree(staged, str(tmp_path / who)) for who in ("port", "jax")]
        prep, jprep = (lambda r: catalogs.prepare_prid2011(r, num_splits=3, seed=2),
                       lambda r: jcatalogs.prepare_prid2011(r, num_splits=3, seed=2))
        cls, jcls, kw = catalogs.PRID2011Sequence, jcatalogs.PRID2011Sequence, dict(split_id=2)
    ours_root, theirs_root = roots
    assert prep(ours_root) == jprep(theirs_root)
    for n in ("meta.json", "splits.json"):
        assert json.load(open(osp.join(ours_root, n))) == json.load(open(osp.join(theirs_root, n)))
    assert sorted(os.listdir(osp.join(ours_root, "images"))) == sorted(os.listdir(osp.join(theirs_root, "images")))
    kw.update(seq_len=4, seq_srd=2, num_val=0.0)
    splits = ("trainval", "query", "gallery")
    assert_same_catalog(cls(ours_root, **kw), jcls(theirs_root, **kw), ours_root, theirs_root, splits)
    assert_same_catalog(cls(theirs_root, **kw), jcls(ours_root, **kw), theirs_root, ours_root, splits)


# ---- get_data ----

def assert_same_batches(ours, theirs, n=None):
    assert len(ours) == len(theirs)
    pairs = list(zip(ours, theirs))
    assert len(pairs) == len(theirs)
    for got, want in pairs[:n]:
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("only_eval", [False, True], ids=["train", "eval"])
def test_get_data_batches_equal_grl_tpu(tmp_path, only_eval):
    """MARS layout with 32x16 JPEGs, loaded at 48x24 (the resize runs):
    the same uint8 batches from both packages for the same seed."""
    root = make_fake_mars(str(tmp_path / "mars"), train_ids=3, test_ids=2, frames_range=(4, 8),
                          height=32, width=16)
    kw = dict(batch_size=4, seq_len=2, workers=2, only_eval=only_eval, height=48, width=24, seed=3)
    ours, theirs = get_data("mars", root, **kw), j_get_data("mars", root, **kw)
    assert ours[1] == theirs[1]
    if not only_eval:
        for _ in range(2):  # two epochs: the sampler and the frame draws move on alike
            assert_same_batches(ours[2], theirs[2])
    else:
        assert ours[2] is None and theirs[2] is None
    assert_same_batches(ours[3], theirs[3])
    assert_same_batches(ours[4], theirs[4], n=3)
    clips = next(iter(ours[3]))[0]
    assert clips.dtype == np.uint8 and clips.shape[-3:] == (48, 24, 3)


def test_get_data_synthetic_and_sequence_equal_grl_tpu(tmp_path):
    kw = dict(batch_size=4, seq_len=2, workers=2, dataset_kwargs=dict(seed=1))
    ours, theirs = get_data("synthetic", **kw), j_get_data("synthetic", **kw)
    assert ours[1] == theirs[1]
    assert_same_batches(ours[2], theirs[2])
    root = make_layout(tmp_path, num_ids=4, frames_per_cam=8)
    kw = dict(batch_size=4, seq_len=2, seq_srd=2, workers=2, height=32, width=16)
    ours, theirs = get_data("ilidsvidsequence", root, **kw), j_get_data("ilidsvidsequence", root, **kw)
    assert ours[1] == theirs[1]
    assert_same_batches(ours[2], theirs[2])
    assert_same_batches(ours[3], theirs[3], n=2)


@pytest.mark.parametrize("option,item", [("process_shard", 7), ("eval_stripe", 7), ("use_flow", None)],
                         ids=["process_shard-7", "eval_stripe-7", "use_flow-8"])
def test_get_data_unported_options_name_their_roadmap_item(option, item):
    """Multi-host sharding raises naming its ROADMAP item; ``use_flow`` off a
    sequence dataset raises ``ValueError``, as grl_tpu's does."""
    if item is None:
        for fn in (get_data, j_get_data):
            with pytest.raises(ValueError, match="no optical-flow companions"):
                fn("synthetic", **{option: True})
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        get_data("synthetic", **{option: True})
