"""Weight bridge: grl_tpu ``(params, state)`` trees -> a torch state_dict,
grl_tpu's whole train state -> the port's ``TrainState``, and torchvision
ImageNet ResNet-50 weights -> the port's trunk (3 or 6 input channels).

The port names its submodules after grl_tpu's param-tree keys
(``backbone.base.layer1.0.conv1``, ``temporal_learning_block.fwd.atte.2``
...), so every state_dict key maps to a tree path with no alias table.
The layout rules are those of ``grl_tpu/utils/convert_torch.py``, written
again here because the port imports nothing of the JAX package:

- 4-D conv kernels HWIO -> OIHW;
- 2-D linear kernels ``(in, out)`` -> ``(out, in)``;
- norm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
- state ``mean``/``var`` -> ``running_mean``/``running_var``;
- ``num_batches_tracked`` (which grl_tpu does not keep) -> 0;
- optax's momentum trace (a tree shaped like the params) -> each
  parameter's ``momentum_buffer`` in ``torch.optim.SGD``.
"""

from __future__ import annotations

import numpy as np
import torch


def _fetch(tree, path):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            raise KeyError(f"path {'.'.join(path)} not in the tree (missing {p!r})")
        node = node[p]
    return node


def _leaf(params, state, path, leaf):
    if leaf == "running_mean":
        return np.asarray(_fetch(state, path + ["mean"]))
    if leaf == "running_var":
        return np.asarray(_fetch(state, path + ["var"]))
    if leaf == "weight":
        node = _fetch(params, path)
        if "kernel" in node:
            v = np.asarray(node["kernel"])
            return np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
        return np.asarray(node["scale"])
    if leaf == "bias":
        return np.asarray(_fetch(params, path + ["bias"]))
    raise ValueError(f"unhandled state_dict leaf {leaf!r} at {'.'.join(path)}")


def state_dict_from_jax(params, state, module):
    """State_dict for ``module`` from grl_tpu's trees (nested dicts of numpy
    arrays), ready for ``module.load_state_dict(sd, strict=True)``. Each
    value takes the dtype and device of the module's own entry."""
    out = {}
    for key, ref in module.state_dict().items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros_like(ref)
            continue
        value = _leaf(params, state, path, leaf)
        if value.shape != tuple(ref.shape):
            raise ValueError(f"shape mismatch at {key}: {value.shape} vs {tuple(ref.shape)}")
        out[key] = torch.tensor(value, dtype=ref.dtype, device=ref.device)
    return out


def _momentum_trace(opt_state):
    """The trace tree of optax's ``chain(add_decayed_weights, trace)`` state."""
    for entry in opt_state:
        if hasattr(entry, "trace"):
            return entry.trace
    raise KeyError("no momentum trace in the optimizer state")


def train_state_from_jax(tree, state):
    """Load grl_tpu's ``train_state`` (nested numpy trees: ``params``,
    ``model_state``, ``luts``, ``opt``, ``step``) into the port's
    ``TrainState`` in place, so the port continues from that step; returns
    ``state``."""
    trace = _momentum_trace(tree["opt"])
    for key, module in state.models.items():
        module.load_state_dict(
            state_dict_from_jax(tree["params"][key], tree["model_state"][key], module), strict=True)
        for name, p in module.named_parameters():
            *path, leaf = name.split(".")
            buf = torch.tensor(_leaf(trace[key], None, path, leaf), dtype=p.dtype, device=p.device)
            state.optimizer.state[p]["momentum_buffer"] = buf
    state.luts = {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=state.luts[k].device)
                  for k, v in tree["luts"].items()}
    state.step = int(tree["step"])
    return state


@torch.no_grad()
def load_imagenet_resnet50(trunk, flat):
    """Load torchvision ImageNet ``resnet50`` weights into ``trunk`` (a
    ``ResNetTrunk``) in place; the counterpart of
    ``grl_tpu/utils/convert_torch.py::load_imagenet_resnet50``.

    ``flat`` maps torchvision's state_dict names to numpy arrays (the npz
    that ``python -m grl_tpu.utils.convert_torch`` writes). The trunk uses
    torchvision's names and layouts, so each entry loads as it is: ``fc.*``
    is dropped, ``num_batches_tracked`` too (grl_tpu keeps no such
    counter), and a name the trunk lacks or a shape that differs raises.
    A trunk whose conv1 takes k×3 input channels (``--use-flow``: 6) gets
    the 3-channel kernel tiled k times along the input axis and divided by
    k, as grl_tpu inflates it; a width that is not a multiple raises.
    Returns ``trunk``."""
    own = trunk.state_dict()
    for key, value in flat.items():
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        if key not in own:
            raise KeyError(f"{key!r} is not in the trunk")
        value = np.asarray(value)
        if key == "conv1.weight" and value.shape[1] != own[key].shape[1]:
            tgt, src = own[key].shape[1], value.shape[1]
            if tgt % src:
                raise ValueError(f"trunk conv1 expects {tgt} input channels; cannot inflate the "
                                 f"{src}-channel ImageNet kernel to a non-multiple")
            value = np.tile(value, (1, tgt // src, 1, 1)) / (tgt // src)
        if value.shape != tuple(own[key].shape):
            raise ValueError(f"shape mismatch at {key}: {value.shape} vs {tuple(own[key].shape)}")
        own[key].copy_(torch.from_numpy(value))
    return trunk
