"""Qualitative visualization: ranked retrieval results and GCE attention
maps (counterpart of ``grl_tpu/engine/visualize.py:33-164``).

- ``visualize_ranked_results``: per query, the first frames of the top-k
  ranked gallery tracklets copied into a directory tree (PIL only);
- ``visualize_in_pic``: one matplotlib strip per query, titles green for
  a match and red otherwise;
- ``attention_overlay`` / ``visualize_attention``: the GCE correlation mask
  over each frame with a jet colormap; ``attention_masks`` computes the
  masks alone.

Tracklet items are ``(frames, pid, camid)``, frames a path tuple or a
uint8 array, as the loaders take them. Rendering happens on the host;
only ``attention_masks`` runs the model, on the device it is given.
matplotlib is imported inside the functions that draw with it.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from ..data.transforms import IMAGENET_MEAN as _MEAN, IMAGENET_STD as _STD
from ..data.transforms import normalize
from ..utils.serialization import mkdir_if_missing

# the statistics ``normalize`` applies, which ``reverse_normalize`` undoes
IMAGENET_MEAN = np.asarray(_MEAN, np.float32)
IMAGENET_STD = np.asarray(_STD, np.float32)


def _first_frame(item):
    frames = item[0]
    if isinstance(frames, np.ndarray):
        return frames[0]
    from PIL import Image

    with Image.open(frames[0]) as img:
        return np.asarray(img.convert("RGB"))


def _save_frame(frame_u8, path):
    from PIL import Image

    Image.fromarray(np.asarray(frame_u8)).save(path)


def reverse_normalize(x):
    """Undo the ImageNet normalization of an (h, w, 3) image -> uint8."""
    img = np.asarray(x, np.float32) * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _ranked(order, item, gallery, topk):
    """(rank, gallery index, pid) of the top-k in ``order`` (one row of
    the distance argsort) for query ``item``, junk (same pid and camera)
    skipped."""
    _, qpid, qcam = item
    rank = 0
    for gi in order:
        _, gpid, gcam = gallery[gi]
        if gpid == qpid and gcam == qcam:
            continue
        rank += 1
        yield rank, gi, gpid
        if rank >= topk:
            return


def visualize_ranked_results(distmat, query, gallery, save_dir, topk=10):
    """Write ``save_dir/query<qi>_pid<p>/query.png`` and
    ``rank<r>_{good,bad}_pid<p>.png`` for each query's top-k."""
    indices = np.argsort(np.asarray(distmat), axis=1)
    mkdir_if_missing(save_dir)
    for qi, item in enumerate(query):
        qpid = item[1]
        qdir = osp.join(save_dir, f"query{qi:04d}_pid{qpid}")
        mkdir_if_missing(qdir)
        _save_frame(_first_frame(item), osp.join(qdir, "query.png"))
        for rank, gi, gpid in _ranked(indices[qi], item, gallery, topk):
            flag = "good" if gpid == qpid else "bad"
            _save_frame(_first_frame(gallery[gi]), osp.join(qdir, f"rank{rank:02d}_{flag}_pid{gpid}.png"))
    print(f"ranked results written to {save_dir}")


def visualize_in_pic(distmat, query, gallery, save_dir, topk=10, query_ids=None):
    """One strip per query (``query_ids``, default all): query frame and
    top-k gallery frames, titles green for matches and red otherwise."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    indices = np.argsort(np.asarray(distmat), axis=1)
    mkdir_if_missing(save_dir)
    q_iter = range(len(query)) if query_ids is None else np.atleast_1d(query_ids)
    for qi in q_iter:
        item = query[qi]
        qpid = item[1]
        fig, axes = plt.subplots(1, topk + 1, figsize=(2 * (topk + 1), 4))
        axes[0].imshow(_first_frame(item))
        axes[0].set_title(f"query\npid {qpid}", color="blue")
        axes[0].axis("off")
        for rank, gi, gpid in _ranked(indices[qi], item, gallery, topk):
            ax = axes[rank]
            ax.imshow(_first_frame(gallery[gi]))
            ax.set_title(f"r{rank}\npid {gpid}", color="green" if gpid == qpid else "red")
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(osp.join(save_dir, f"query{qi:04d}.png"))
        plt.close(fig)
    print(f"ranked strips written to {save_dir}")


def attention_overlay(frame_u8, mask, alpha=0.5):
    """Overlay an (h', w') attention map on an (h, w, 3) frame with a jet colormap."""
    import matplotlib.cm as cm
    from PIL import Image

    h, w = frame_u8.shape[:2]
    m = np.asarray(mask, np.float32)
    m = (m - m.min()) / max(m.max() - m.min(), 1e-6)
    m_img = np.asarray(Image.fromarray((m * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR))
    heat = (cm.jet(m_img / 255.0)[..., :3] * 255).astype(np.uint8)
    return ((1 - alpha) * frame_u8 + alpha * heat).astype(np.uint8)


@torch.inference_mode()
def attention_masks(cnn, clips_u8, device=None):
    """The GCE correlation masks of ``cnn`` (a ``GRLModel``) over uint8
    clips (b, t, h, w, c), a numpy array or a tensor, computed on
    ``device`` (default: the model's) -> float32 numpy (b, t, h', w')."""
    device = next(cnn.parameters()).device if device is None else torch.device(device)
    if not isinstance(clips_u8, torch.Tensor):
        clips_u8 = torch.from_numpy(np.ascontiguousarray(clips_u8))
    clips = clips_u8.to(device)
    _, _, corr_map = cnn.backbone(normalize(clips))  # (b, t, 1, h', w')
    return corr_map[:, :, 0].float().cpu().numpy()


def visualize_attention(cnn, clips_u8, save_dir, device=None, prefix="cam"):
    """One grid per clip (frames above, frames under their GCE mask below)
    written to ``save_dir/<prefix>_<bi>.png``; returns the masks of
    ``attention_masks``. The overlay shows the RGB channels of a
    6-channel clip."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    masks = attention_masks(cnn, clips_u8, device)
    frames = np.asarray(clips_u8)[..., :3]
    mkdir_if_missing(save_dir)
    b, t = frames.shape[:2]
    for bi in range(b):
        fig, axes = plt.subplots(2, t, figsize=(2 * t, 5), squeeze=False)
        for ti in range(t):
            axes[0][ti].imshow(frames[bi, ti])
            axes[1][ti].imshow(attention_overlay(frames[bi, ti], masks[bi, ti]))
            for row in (0, 1):
                axes[row][ti].axis("off")
        fig.tight_layout()
        fig.savefig(osp.join(save_dir, f"{prefix}_{bi:03d}.png"))
        plt.close(fig)
    print(f"attention grids written to {save_dir}")
    return masks
