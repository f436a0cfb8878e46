"""PyTorch state_dict -> grl_tpu pytree conversion (counterpart of
``grl_tpu/utils/convert_torch.py``, written again here because the port
imports nothing of the JAX package).

Imports torchvision ImageNet ResNet-50 weights into the trunk and full
reference GRL/Siamese checkpoints. The functions take numpy arrays in and
give numpy arrays out, with grl_tpu's names and signatures; callers do
``{k: v.numpy() for k, v in torch.load(p)["state_dict"].items()}`` first,
or run ``python -m grl_tpu_torch.utils.convert_torch --src X.pth --out
X.npz``.

Layout rules:
- 4-D conv weights OIHW -> HWIO;
- 2-D linear weights (out, in) -> (in, out);
- 1-D ``weight``/``bias`` on norm layers -> ``scale``/``bias`` params;
- ``running_mean``/``running_var`` -> state ``mean``/``var``;
- ``num_batches_tracked`` dropped.

A reference GRL checkpoint reaches the port's modules in two steps:

    params, state = load_grl_checkpoint(params, state, flat)   # grl_tpu's trees
    cnn.load_state_dict(state_dict_from_jax(params, state, cnn), strict=True)

where ``params``/``state`` are the ``GRLModel``'s own trees (for example
``torch_to_pytree`` of its state_dict, or grl_tpu's init) and
``state_dict_from_jax`` is ``utils/convert.py``'s.
"""

from __future__ import annotations

import numpy as np

# The reference ResNet50_GRL_Model wraps the trunk in an anonymous
# nn.Sequential and names the TRL submodules differently; these map those
# prefixes onto grl_tpu's (and the port's) structured names.
GRL_ALIASES = {
    "backbone.base.0": "backbone.base.conv1",
    "backbone.base.1": "backbone.base.bn1",
    "backbone.base.4": "backbone.base.layer1",
    "backbone.base.5": "backbone.base.layer2",
    "backbone.base.6": "backbone.base.layer3",
    "backbone.base.7": "backbone.base.layer4",
    "temporal_learning_block.forward_f1.0": "temporal_learning_block.fwd.f1",
    "temporal_learning_block.forward_f2.0": "temporal_learning_block.fwd.f2",
    "temporal_learning_block.channel_atte_foreward_corr": "temporal_learning_block.fwd.atte",
    "temporal_learning_block.uncorr_memo_forward": "temporal_learning_block.fwd.memo",
    "temporal_learning_block.backward_f1.0": "temporal_learning_block.bwd.f1",
    "temporal_learning_block.backward_f2.0": "temporal_learning_block.bwd.f2",
    "temporal_learning_block.channel_atte_backward_corr": "temporal_learning_block.bwd.atte",
    "temporal_learning_block.uncorr_memo_backward": "temporal_learning_block.bwd.memo",
}


def _apply_aliases(key, aliases):
    if not aliases:
        return key
    for src in sorted(aliases, key=len, reverse=True):
        if key == src or key.startswith(src + "."):
            return aliases[src] + key[len(src):]
    return key


def _set_path(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def torch_to_pytree(flat, aliases=None, strip_prefix="module."):
    """Convert a flat torch state_dict (numpy values) to (params, state)."""
    params, state = {}, {}
    for key, value in flat.items():
        if key.startswith(strip_prefix):
            key = key[len(strip_prefix):]
        key = _apply_aliases(key, aliases)
        *path, leaf = key.split(".")
        value = np.asarray(value)
        if leaf == "num_batches_tracked":
            continue
        if leaf == "running_mean":
            _set_path(state, path + ["mean"], value.astype(np.float32))
        elif leaf == "running_var":
            _set_path(state, path + ["var"], value.astype(np.float32))
        elif leaf == "weight":
            if value.ndim == 4:
                _set_path(params, path + ["kernel"], np.transpose(value, (2, 3, 1, 0)))
            elif value.ndim == 2:
                _set_path(params, path + ["kernel"], value.T)
            elif value.ndim == 1:
                _set_path(params, path + ["scale"], value.astype(np.float32))
            else:
                raise ValueError(f"Unhandled weight rank for {key}: {value.shape}")
        elif leaf == "bias":
            _set_path(params, path + ["bias"], value)
        elif leaf == "lut":
            # the OIM lookup table buffer
            _set_path(state, path + ["lut"], value)
        else:
            raise ValueError(f"Unhandled state_dict leaf: {key}")
    return params, state


def _fetch_path(tree, path):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            raise KeyError(f"path {'.'.join(path)} not in pytree (missing {p!r})")
        node = node[p]
    return node


def pytree_to_torch_state(params, state, torch_keys, aliases=None):
    """Inverse of :func:`torch_to_pytree`: a flat torch-style state_dict
    (numpy values) covering exactly ``torch_keys``, the key list of the
    target torch module's state_dict. ``num_batches_tracked`` counters,
    which ``torch_to_pytree`` drops, come out as zeros."""
    flat = {}
    for tkey in torch_keys:
        *path, leaf = _apply_aliases(tkey, aliases).split(".")
        if leaf == "num_batches_tracked":
            flat[tkey] = np.asarray(0, dtype=np.int64)
        elif leaf == "running_mean":
            flat[tkey] = np.asarray(_fetch_path(state, path + ["mean"]))
        elif leaf == "running_var":
            flat[tkey] = np.asarray(_fetch_path(state, path + ["var"]))
        elif leaf == "weight":
            node = _fetch_path(params, path)
            if "kernel" in node:
                v = np.asarray(node["kernel"])
                flat[tkey] = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
            else:
                flat[tkey] = np.asarray(node["scale"])
        elif leaf == "bias":
            flat[tkey] = np.asarray(_fetch_path(params, path + ["bias"]))
        elif leaf == "lut":
            flat[tkey] = np.asarray(_fetch_path(state, path + ["lut"]))
        else:
            raise ValueError(f"Unhandled state_dict leaf: {tkey}")
    return flat


def merge_pytree(base, overlay):
    """Recursively overlay converted leaves onto an initialized pytree.
    Raises on a key ``base`` lacks and on a shape mismatch, so a partial
    load cannot pass unnoticed."""
    out = dict(base)
    for k, v in overlay.items():
        if k not in base:
            raise KeyError(f"Converted key {k!r} not present in target tree (have {sorted(base.keys())})")
        if isinstance(v, dict):
            out[k] = merge_pytree(base[k], v)
        else:
            if np.shape(base[k]) != np.shape(v):
                raise ValueError(f"Shape mismatch at {k}: {np.shape(base[k])} vs {np.shape(v)}")
            out[k] = np.asarray(v, dtype=np.asarray(base[k]).dtype)
    return out


def load_grl_checkpoint(params, state, flat):
    """Overlay a reference cnn checkpoint onto ``GRLModel`` pytrees."""
    p, s = torch_to_pytree(flat, aliases=GRL_ALIASES)
    return merge_pytree(params, p), merge_pytree(state, s)


def _main():
    """CLI: flatten a torch .pth/.pth.tar into a numpy .npz that
    --pretrained-trunk / load_grl_checkpoint can consume.

    python -m grl_tpu_torch.utils.convert_torch --src resnet50-19c8e357.pth \
        --out resnet50_imagenet.npz
    """
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=_main.__doc__.split("\n")[0])
    ap.add_argument("--src", required=True, help="torch checkpoint (.pth / .pth.tar)")
    ap.add_argument("--out", required=True, help="output .npz of numpy arrays")
    args = ap.parse_args()

    blob = torch.load(args.src, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    flat = {k: np.asarray(v.detach().numpy() if hasattr(v, "detach") else v) for k, v in state.items()}
    np.savez(args.out, **flat)
    print(f"wrote {len(flat)} arrays to {args.out}")


def __getattr__(name):
    # grl_tpu keeps its ImageNet loader in this module; the port's lives in
    # utils/convert.py (it loads into a module, through torch_to_pytree
    # above) and is found here too
    if name == "load_imagenet_resnet50":
        from .convert import load_imagenet_resnet50

        return load_imagenet_resnet50
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["GRL_ALIASES", "load_grl_checkpoint", "load_imagenet_resnet50", "merge_pytree",
           "pytree_to_torch_state", "torch_to_pytree"]


if __name__ == "__main__":
    _main()
