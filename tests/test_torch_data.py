"""The port's copies of grl_tpu's data modules give the same arrays.

normalize (including the 3k-channel tiling), the sampling grids and
samplers, the synthetic catalog and ``ClipDataset``/``ClipLoader`` are
copies, since the port imports nothing of the JAX package; the same seeds
must give the same frames, indices and batches in both packages.
"""

import numpy as np
import pytest
import torch

from grl_tpu.data import sampling as jsampling
from grl_tpu.data.catalogs.synthetic import SyntheticVideoReID as JSynthetic
from grl_tpu.data.loader import ClipDataset as JClipDataset
from grl_tpu.data.loader import ClipLoader as JClipLoader
from grl_tpu.data.transforms import normalize as j_normalize
from grl_tpu_torch.data import ClipDataset, ClipLoader, SyntheticVideoReID, normalize
from grl_tpu_torch.data import sampling

T, H, W = 3, 32, 16
CATALOG = dict(num_train_ids=3, num_test_ids=6, tracklets_per_id=2, num_cams=2,
               frames_range=(2, 12), height=H, width=W, seed=0)


@pytest.mark.parametrize("channels", [3, 6])
def test_normalize_matches_grl_tpu(channels):
    clips = np.random.RandomState(channels).randint(0, 256, (2, T, H, W, channels)).astype(np.uint8)
    got = normalize(torch.from_numpy(clips))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_normalize(clips)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_frames", [1, 3, 8, 9, 17, 40])
def test_sampling_grids_match_grl_tpu(num_frames):
    for seq_len in (4, 8):
        np.testing.assert_array_equal(sampling.dense_indices(num_frames, seq_len),
                                      jsampling.dense_indices(num_frames, seq_len))
        np.testing.assert_array_equal(sampling.rrs_test_indices(num_frames, seq_len),
                                      jsampling.rrs_test_indices(num_frames, seq_len))
        for draw in ("rrs_train_indices", "random_window_indices"):
            got = getattr(sampling, draw)(num_frames, seq_len, np.random.RandomState(seq_len))
            want = getattr(jsampling, draw)(num_frames, seq_len, np.random.RandomState(seq_len))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampler", ["RandomPairSampler", "RandomIdentitySampler"])
def test_samplers_match_grl_tpu(sampler):
    train = SyntheticVideoReID(**CATALOG).train
    got = getattr(sampling, sampler)(train, seed=4)
    want = getattr(jsampling, sampler)(JSynthetic(**CATALOG).train, seed=4)
    assert len(got) == len(want)
    for _ in range(2):  # two epochs: the generator state carries over
        assert list(got) == list(want)


@pytest.mark.parametrize("size", [(H, W), (16, 8)], ids=["stored_size", "resized"])
@pytest.mark.parametrize("sample", ["dense", "rrs_test", "rrs_train", "random"])
def test_clip_dataset_copy_samples_as_grl_tpu(sample, size):
    jds, ds = JSynthetic(**CATALOG), SyntheticVideoReID(**CATALOG)
    assert ds.queryinfo.pid == jds.queryinfo.pid and ds.galleryinfo.camid == jds.galleryinfo.camid
    want = JClipDataset(jds.gallery, T, sample, *size, seed=3)
    got = ClipDataset(ds.gallery, T, sample, *size, seed=3)
    for i in range(len(got)):
        for epoch in (0, 1):
            (gc, gp, gk), (wc, wp, wk) = got.get(i, epoch), want.get(i, epoch)
            np.testing.assert_array_equal(gc, wc)
            assert (gp, gk) == (wp, wk)


@pytest.mark.parametrize("sample, batch_size", [("rrs_test", 4), ("dense", 1)])
def test_clip_loader_batches_as_grl_tpu(sample, batch_size):
    jds, ds = JSynthetic(**CATALOG), SyntheticVideoReID(**CATALOG)
    want = JClipLoader(JClipDataset(jds.query, T, sample, H, W), batch_size=batch_size, workers=2)
    got = ClipLoader(ClipDataset(ds.query, T, sample, H, W), batch_size=batch_size, workers=2)
    assert len(got) == len(want)
    pairs = list(zip(got, want, strict=True))
    assert len(pairs) == len(want)
    for g, w in pairs:
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a, b)


def test_clip_loader_rejects_batched_dense():
    with pytest.raises(ValueError):
        ClipLoader(ClipDataset([], T, "dense", H, W), batch_size=2)
