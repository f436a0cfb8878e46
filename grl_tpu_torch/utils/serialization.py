"""JSON helpers and checkpoints in grl_tpu's format.

The JSON helpers and the flat-npz tree helpers are copies of
``grl_tpu/utils/serialization.py``. Train-state checkpoints are written
and read in grl_tpu's own format, so either package resumes or evaluates
the other's checkpoint:

- ``leaf_00000``, ``leaf_00001`` ... : the leaves of grl_tpu's train-state
  tree in ``jax.tree_util`` flatten order;
- ``treedef``: a string rendering of that tree (neither package reads it);
- ``extra_<name>``: scalar extras (``epoch``, ``best_top1``).

grl_tpu's train state is the dict ``{lr_mults, luts, model_state, opt,
params, step}``, and ``jax.tree_util`` flattens dicts in sorted key order,
so the leaves come in that order, each subtree's keys sorted too. The port
derives the same order from its ``TrainState`` (``_entries``):

- ``params/<module>/<path>/{bias, kernel}`` for a conv or linear layer,
  ``{bias, scale}`` for a norm; kernels in grl_tpu's layouts (HWIO for
  convs, ``(in, out)`` for linears);
- ``model_state/<module>/<path>/{mean, var}``: BN running statistics;
- ``opt``: optax's ``(EmptyState(), TraceState(trace=<params-shaped>))``,
  so only the momentum trace has leaves; a torch ``momentum_buffer`` that
  is still ``None`` is written as zeros, as optax's trace is at init;
- ``lr_mults``: params-shaped float64 0-d multipliers; ``luts``: ``corr``,
  ``uncorr``; ``step``: int32 0-d.

Reading checks the leaf count, every shape and every dtype (the
multipliers', which grl_tpu's template holds as Python floats, excepted),
and that the saved ``lr_mults`` equal the port's own; any mismatch raises.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import time

import numpy as np
import torch


def mkdir_if_missing(path):
    os.makedirs(path, exist_ok=True)


def read_json(fpath):
    with open(fpath) as f:
        return json.load(f)


def write_json(obj, fpath):
    mkdir_if_missing(osp.dirname(fpath) or ".")
    with open(fpath, "w") as f:
        json.dump(obj, f, indent=4, separators=(",", ": "))


# -- nested dicts <-> flat npz ------------------------------------------


def flatten_tree(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def unflatten_tree(flat):
    tree = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _atomic_savez(fpath, payload):
    """np.savez to a temp file in the same directory, then os.replace: a
    kill or a failure mid-write leaves the previous checkpoint intact."""
    mkdir_if_missing(osp.dirname(fpath) or ".")
    if not fpath.endswith(".npz"):
        fpath = fpath + ".npz"  # np.savez appends it; mirror for the rename
    tmp = fpath + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, fpath)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return fpath


def _copy_best(fpath, best_name):
    best = osp.join(osp.dirname(fpath), best_name)
    tmp = best + f".tmp{os.getpid()}"
    shutil.copy(fpath, tmp)
    os.replace(tmp, best)


def save_checkpoint(state, fpath, is_best=False, best_name=None):
    """Save a nested dict of arrays to ``fpath`` (.npz)."""
    fpath = _atomic_savez(fpath, flatten_tree(state))
    if is_best and best_name:
        _copy_best(fpath, best_name)


def load_checkpoint(fpath):
    if not osp.isfile(fpath):
        raise ValueError(f"=> No checkpoint found at '{fpath}'")
    with np.load(fpath, allow_pickle=False) as data:
        return unflatten_tree({k: data[k] for k in data.files})


# -- the train state in grl_tpu's leaf order ----------------------------


def _module_entries(models):
    """``(params, stats)``: sorted ``(path, name, tensor, layout)`` of every
    parameter and BN running statistic, ``path`` being grl_tpu's key path
    below ``params`` / ``model_state``."""
    params, stats = [], []
    for key, module in models.items():
        for name, p in module.named_parameters():
            *path, leaf = name.split(".")
            layout = None
            if leaf == "weight":
                layout = {4: "conv", 2: "linear"}.get(p.dim())
                leaf = "kernel" if layout else "scale"
            elif leaf != "bias":
                raise ValueError(f"no grl_tpu leaf for parameter {key}.{name}")
            params.append(((key, *path, leaf), f"{key}.{name}", p, layout))
        for name, b in module.named_buffers():
            *path, leaf = name.split(".")
            if leaf == "num_batches_tracked":  # grl_tpu keeps no such counter
                continue
            leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf)
            if leaf is None:
                raise ValueError(f"no grl_tpu leaf for buffer {key}.{name}")
            stats.append(((key, *path, leaf), f"{key}.{name}", b, None))
    return sorted(params, key=lambda e: e[0]), sorted(stats, key=lambda e: e[0])


def _entries(state):
    """Every leaf of grl_tpu's train-state tree, in its flatten order, as
    ``(path, value, layout)``: ``value`` is the port's live tensor (torch
    layout) or a numpy scalar, ``layout`` is ``"conv"``, ``"linear"`` or
    None (how the tensor maps to grl_tpu's layout)."""
    params, stats = _module_entries(state.models)
    opt = state.optimizer
    mult = {id(p): g["lr_mult"] for g in opt.param_groups for p in g["params"]}

    def momentum(p):
        buf = opt.state.get(p, {}).get("momentum_buffer")
        return torch.zeros_like(p) if buf is None else buf

    return (
        [(("lr_mults", *path), np.asarray(mult[id(p)], np.float64), None) for path, _, p, _ in params]
        + [(("luts", k), state.luts[k], None) for k in sorted(state.luts)]
        + [(("model_state", *path), b, None) for path, _, b, _ in stats]
        + [(("opt", "1", "trace", *path), momentum(p), lay) for path, _, p, lay in params]
        + [(("params", *path), p, lay) for path, _, p, lay in params]
        + [(("step",), np.asarray(state.step, np.int32), None)]
    )


def leaf_paths(state):
    """grl_tpu's key path of every checkpoint leaf, in file order."""
    return ["/".join(path) for path, _, _ in _entries(state)]


def to_grl_layout(array, layout):
    """A torch-layout numpy array -> grl_tpu's layout."""
    if layout == "conv":
        return np.ascontiguousarray(array.transpose(2, 3, 1, 0))  # OIHW -> HWIO
    if layout == "linear":
        return np.ascontiguousarray(array.T)  # (out, in) -> (in, out)
    return array


def from_grl_layout(array, layout):
    if layout == "conv":
        return np.ascontiguousarray(array.transpose(3, 2, 0, 1))  # HWIO -> OIHW
    if layout == "linear":
        return np.ascontiguousarray(array.T)
    return array


def _grl_shape(value, layout):
    shape = tuple(value.shape)
    if layout == "conv":
        return (shape[2], shape[3], shape[1], shape[0])
    if layout == "linear":
        return shape[::-1]
    return shape


def _np_dtype(value):
    if isinstance(value, torch.Tensor):
        return torch.empty((), dtype=value.dtype).numpy().dtype
    return value.dtype


def _treedef(paths):
    """The flatten order's tree as a string, in ``PyTreeDef`` notation
    (without grl_tpu's empty subtrees)."""
    tree = {}
    for path in paths:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = None

    def render(node):
        if node is None:
            return "*"
        return "{" + ", ".join(f"'{k}': {render(v)}" for k, v in node.items()) + "}"

    top = [f"'{k}': (EmptyState(), TraceState(trace={render(v['1']['trace'])}))" if k == "opt"
           else f"'{k}': {render(v)}" for k, v in tree.items()]
    return "PyTreeDef({" + ", ".join(top) + "})"


def snapshot(state):
    """A copy of every leaf that later in-place updates cannot reach.

    Leaves of one dtype are packed into one flat buffer by ``torch.cat`` on
    the state's device, on its current stream: on a card the copy is queued
    before any later step's in-place optimizer update. Returns a
    ``Snapshot`` for ``Snapshot.write`` (or ``AsyncCheckpointer``)."""
    entries = _entries(state)
    groups = {}  # dtype -> leaf indices
    for i, (_, value, _) in enumerate(entries):
        if isinstance(value, torch.Tensor):
            groups.setdefault(value.dtype, []).append(i)
    packed = {dt: torch.cat([entries[i][1].detach().reshape(-1) for i in ixs])
              for dt, ixs in groups.items()}
    return Snapshot(entries, groups, packed)


class Snapshot:
    def __init__(self, entries, groups, packed):
        self.paths = [path for path, _, _ in entries]
        self.layouts = [layout for _, _, layout in entries]
        self.shapes = [tuple(value.shape) for _, value, _ in entries]
        self.host = [None if isinstance(v, torch.Tensor) else v for _, v, _ in entries]
        self.groups = groups
        self.packed = packed
        self.ready = None
        devices = {buf.device for buf in packed.values()}
        if any(d.type == "cuda" for d in devices):
            (self.device,) = devices
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(self.device))

    def _pull(self):
        """The packed buffers on the host. On a card the copy runs on a
        stream of its own behind the snapshot's event, so it waits for the
        snapshot and not for the steps queued after it."""
        if self.ready is None:
            return {dt: buf.numpy() for dt, buf in self.packed.items()}
        stream = torch.cuda.Stream(self.device)
        stream.wait_event(self.ready)
        with torch.cuda.stream(stream):
            return {dt: buf.cpu().numpy() for dt, buf in self.packed.items()}

    def leaves(self):
        """Every leaf as a numpy array in grl_tpu's layout, in file order."""
        out = list(self.host)
        for dt, flat in self._pull().items():
            offset = 0
            for i in self.groups[dt]:
                size = int(np.prod(self.shapes[i], dtype=np.int64))
                out[i] = to_grl_layout(flat[offset : offset + size].reshape(self.shapes[i]), self.layouts[i])
                offset += size
        return out

    def write(self, extras, fpath, is_best=False, best_name=None):
        payload = {f"leaf_{i:05d}": leaf for i, leaf in enumerate(self.leaves())}
        payload["treedef"] = np.asarray(_treedef(self.paths))
        for k, v in extras.items():
            payload[f"extra_{k}"] = np.asarray(v)
        fpath = _atomic_savez(fpath, payload)
        if is_best and best_name:
            _copy_best(fpath, best_name)
        return fpath


def save_train_state(state, extras, fpath, is_best=False, best_name=None):
    """Write ``state`` (a ``TrainState``) and scalar ``extras`` to one .npz
    in grl_tpu's format; ``is_best`` also copies it to ``best_name`` in the
    same directory."""
    return snapshot(state).write(extras, fpath, is_best, best_name)


class AsyncCheckpointer:
    """Checkpoint writer that does not hold up the training loop.

    ``save`` snapshots the state (``snapshot``: one ``torch.cat`` per dtype
    on the training stream, ordered before the next step's in-place update)
    and hands the pull to the host and the npz write to one worker thread.
    A worker that read the live parameters instead would race the in-place
    ``SGD`` update of the steps queued meanwhile.

    One save is in flight at a time; a second ``save`` waits for the first,
    so files appear in submission order. Call ``wait()`` before reading a
    checkpoint back or exiting; a worker's exception re-raises there.
    ``last_save_seconds`` is how long the caller's thread spent in the last
    ``save`` (its wait on the previous write included), ``last_write_seconds``
    how long the worker took for the last finished write, ``last_bytes`` the
    size of that file.
    """

    def __init__(self):
        self._pending = None
        self._executor = None
        self.last_save_seconds = None
        self.last_write_seconds = None
        self.last_bytes = None

    def save(self, state, extras, fpath, is_best=False, best_name=None):
        import concurrent.futures

        t0 = time.perf_counter()
        self.wait()
        snap = snapshot(state)
        extras = dict(extras)

        def write():
            t = time.perf_counter()
            path = snap.write(extras, fpath, is_best, best_name)
            self.last_write_seconds = time.perf_counter() - t
            self.last_bytes = os.path.getsize(path)

        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending = self._executor.submit(write)
        self.last_save_seconds = time.perf_counter() - t0

    def wait(self):
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()


def load_train_state(state, fpath):
    """Restore a checkpoint of either package into ``state`` (a
    ``TrainState``, whose modules, optimizer and luts give the expected
    leaves) in place; returns the extras as numpy scalars. Raises on a
    missing file, a leaf count, shape or dtype that differs, or saved
    ``lr_mults`` that are not ``state``'s."""
    if not osp.isfile(fpath):
        raise ValueError(f"=> No checkpoint found at '{fpath}'")
    entries = _entries(state)
    with np.load(fpath, allow_pickle=False) as data:
        keys = sorted(k for k in data.files if k.startswith("leaf_"))
        if len(keys) != len(entries):
            raise ValueError(f"checkpoint has {len(keys)} leaves, the train state expects {len(entries)}")
        values = []
        for k, (path, ref, layout) in zip(keys, entries):
            v = data[k]
            where = f"{k} ({'/'.join(path)})"
            if v.shape != _grl_shape(ref, layout):
                raise ValueError(f"shape mismatch at {where}: {_grl_shape(ref, layout)} vs {v.shape}")
            if path[0] == "lr_mults":
                # grl_tpu's template holds Python floats (no dtype; a state
                # that went through its jitted step saves them as float32)
                if v != ref:
                    raise ValueError(f"lr multiplier mismatch at {where}: {float(ref)} vs {float(v)}")
            elif v.dtype != _np_dtype(ref):
                raise ValueError(f"dtype mismatch at {where}: {_np_dtype(ref)} vs {v.dtype}")
            values.append(v)
        extras = {k[len("extra_"):]: data[k] for k in data.files if k.startswith("extra_")}

    params, _ = _module_entries(state.models)
    by_path = dict(zip((path for path, _, _ in entries), values))
    opt = state.optimizer
    with torch.no_grad():
        for (path, ref, layout), v in zip(entries, values):
            if path[0] in ("params", "model_state"):
                ref.copy_(torch.from_numpy(from_grl_layout(v, layout)))
        for path, _, p, layout in params:
            trace = from_grl_layout(by_path[("opt", "1", "trace", *path)], layout)
            opt.state[p]["momentum_buffer"] = torch.from_numpy(trace).to(p.device)
    state.luts = {k: torch.from_numpy(by_path[("luts", k)]).to(v.device) for k, v in state.luts.items()}
    state.step = int(by_path[("step",)])
    return extras
