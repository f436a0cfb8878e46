"""The port's data tools against grl_tpu's on the CPU: the fake MARS and
DukeMTMC-VideoReID writers and ``prepare_real_data``.

Each tool runs in its own process session under a timeout, past which it
is killed and the test fails: the port's as ``python -m
grl_tpu_torch.tools.<name>`` (or its function through ``python -c``),
grl_tpu's as ``python tools/<name>.py`` (or its function). The same
arguments must write the same trees: the same relative file list, JPEG
and ``.txt`` bytes equal, ``.mat`` files equal under ``scipy.io.loadmat``
(``savemat`` stamps its creation time into the header). The split caches
that ``prepare_real_data`` writes must be grl_tpu's after ``json.load``.
"""

import json
import os
import os.path as osp
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import loadmat

from test_sequence_catalogs import make_raw_ilids, make_raw_prid

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TIMEOUT = 180


def run(argv, expect_ok=True):
    """``argv`` from the repo's root in its own session; returns (rc, out, err)."""
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{argv[:4]} did not finish in {TIMEOUT} s:\n{out[-3000:]}\n{err[-3000:]}")
    if expect_ok:
        assert proc.returncode == 0, f"{argv[:4]}\n{out[-3000:]}\n{err[-3000:]}"
    return proc.returncode, out, err


def port_tool(name, *argv, **kw):
    return run([sys.executable, "-m", f"grl_tpu_torch.tools.{name}", *argv], **kw)


def grl_tool(name, *argv, **kw):
    return run([sys.executable, osp.join("tools", f"{name}.py"), *argv], **kw)


def call(module, fn, out, kwargs):
    """``module.fn(out, **kwargs)`` in a fresh process; ``module`` is the
    port's tool, or a file of grl_tpu's ``tools/`` when it starts with
    ``tools.``."""
    head = (f"import sys; sys.path.insert(0, 'tools'); from {module[6:]} import {fn}"
            if module.startswith("tools.") else f"from {module} import {fn}")
    return run([sys.executable, "-c", f"{head}; {fn}({out!r}, **{kwargs!r})"])


def files(root):
    return sorted(osp.relpath(osp.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def assert_same_tree(ours, theirs):
    names = files(ours)
    assert names == files(theirs) and names
    for name in names:
        a, b = osp.join(ours, name), osp.join(theirs, name)
        if name.endswith(".mat"):
            ma, mb = loadmat(a), loadmat(b)
            keys = sorted(k for k in ma if not k.startswith("__"))
            assert keys == sorted(k for k in mb if not k.startswith("__"))
            for k in keys:
                np.testing.assert_array_equal(ma[k], mb[k], err_msg=name)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


MARS_ARGS = {
    "defaults": None,
    "junk0-query2-test2": dict(junk_tracklets=0, query_cams=2, test_tracklets_per_id_cam=2, cams=3,
                               frames_range=(3, 6), height=32, width=16, seed=3),
}


@pytest.mark.parametrize("case", list(MARS_ARGS))
def test_fake_mars_writes_grl_tpu_s_tree(tmp_path, case):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    kwargs = MARS_ARGS[case]
    if kwargs is None:  # the command lines, defaults throughout
        out = port_tool("make_fake_mars", ours)[1]
        grl_tool("make_fake_mars", theirs)
        assert f"wrote fake MARS ({len(files(ours))} files)" in out and "grl_tpu_torch.cli.train" in out
    else:
        call("grl_tpu_torch.tools.make_fake_mars", "make_fake_mars", ours, kwargs)
        call("tools.make_fake_mars", "make_fake_mars", theirs, kwargs)
    assert_same_tree(ours, theirs)
    assert any(n.endswith(".jpg") for n in files(ours))
    junk = osp.join(ours, "bbox_test", "0000")
    assert osp.isdir(junk) == (kwargs is None)  # the junk tracklet's directory


DUKE_ARGS = {
    "defaults": None,
    "cams3": dict(cams=3, train_ids=3, test_ids=2, frames_range=(3, 6), height=32, width=16, seed=5),
}


@pytest.mark.parametrize("case", list(DUKE_ARGS))
def test_fake_duke_writes_grl_tpu_s_tree(tmp_path, case):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    kwargs = DUKE_ARGS[case]
    if kwargs is None:
        out = port_tool("make_fake_duke", ours)[1]
        grl_tool("make_fake_duke", theirs)
        assert f"wrote fake DukeMTMC-VideoReID ({len(files(ours))} files)" in out
    else:
        call("grl_tpu_torch.tools.make_fake_duke", "make_fake_duke", ours, kwargs)
        call("tools.make_fake_duke", "make_fake_duke", theirs, kwargs)
    assert_same_tree(ours, theirs)
    names = [osp.basename(n) for n in files(ours)]
    assert any("_C" in n for n in names) and any("_" not in n for n in names)  # both filename formats


def _tree(name, tmp_path):
    """One source tree of ``name``: the port's fake writers for MARS and
    Duke, the raw downloads of ``tests/test_sequence_catalogs.py`` for the
    sequence datasets."""
    src = tmp_path / "src"
    src.mkdir()
    if name == "mars":
        call("grl_tpu_torch.tools.make_fake_mars", "make_fake_mars", str(src / name),
             dict(frames_range=(3, 6), height=32, width=16))
        return str(src / name)
    if name == "duke":
        call("grl_tpu_torch.tools.make_fake_duke", "make_fake_duke", str(src / name),
             dict(frames_range=(3, 6), height=32, width=16))
        return str(src / name)
    return make_raw_ilids(src) if name == "ilidsvidsequence" else make_raw_prid(src)


def _json_files(root):
    return sorted(n for n in os.listdir(root) if n.endswith(".json"))


def _stats(out):
    return [ln for ln in out.splitlines() if " | " in ln or ln.startswith("  number of images")]


@pytest.mark.parametrize("dataset", ["mars", "duke", "ilidsvidsequence", "prid2011sequence"])
def test_prepare_real_data_writes_grl_tpu_s_split_caches(tmp_path, dataset):
    """Both tools on copies of one tree. The sequence datasets start from
    their raw downloads: the port's tool builds ``meta.json``, ``splits.json``
    and ``images/`` itself, grl_tpu's needs its ``prepare_*`` run first."""
    src = _tree(dataset, tmp_path)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    shutil.copytree(src, ours)
    shutil.copytree(src, theirs)
    sequence = dataset.endswith("sequence")
    if sequence:
        from grl_tpu.data.catalogs import prepare_ilidsvid, prepare_prid2011

        (prepare_ilidsvid if dataset == "ilidsvidsequence" else prepare_prid2011)(theirs)
    out = port_tool("prepare_real_data", dataset, "--data-dir", ours)[1]
    want = grl_tool("prepare_real_data", dataset, "--data-dir", theirs)[1]

    names = _json_files(ours)
    assert names == _json_files(theirs)
    assert ("splits.json" in names) if sequence else ("split_train.json" in names)
    for name in names:
        with open(osp.join(ours, name)) as f:
            got = json.loads(f.read().replace(ours, theirs))
        with open(osp.join(theirs, name)) as f:
            assert got == json.load(f), name
    if sequence:
        assert files(osp.join(ours, "images")) == files(osp.join(theirs, "images"))
        assert f"prepared {dataset} from " in out
    assert _stats(out) == _stats(want) and _stats(out)
    assert "catalog ok" in out and "python -m grl_tpu_torch.cli.train" in out
    assert "python -m grl_tpu_torch.utils.convert_torch --src" in out and "--devices N" in out
    assert "grl_tpu.cli" not in out
    decoded = [ln for ln in out.splitlines() if "decoded" in ln]
    assert len(decoded) == 3 and all(" frames through the " in ln for ln in decoded)


@pytest.mark.parametrize("dataset", ["mars", "duke"])
def test_prepare_real_data_names_what_is_missing_as_grl_tpu_does(tmp_path, dataset):
    (tmp_path / "empty").mkdir()
    errs = {}
    for label in ("empty", "absent"):
        root = str(tmp_path / label)
        rc, _, err = port_tool("prepare_real_data", dataset, "--data-dir", root, expect_ok=False)
        rc_j, _, err_j = grl_tool("prepare_real_data", dataset, "--data-dir", root, expect_ok=False)
        assert rc == rc_j == 1
        assert err.strip().splitlines() == err_j.strip().replace("grl_tpu/data", "grl_tpu_torch/data").splitlines()
        errs[label] = err
    assert f"{dataset} layout incomplete" in errs["empty"] and "grl_tpu_torch/data/catalogs/" in errs["empty"]
    assert "does not exist" in errs["absent"]
