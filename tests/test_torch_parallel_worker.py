"""Jobs that run on each rank of a gloo group, launched by
``tests/test_torch_parallel.py`` through ``grl_tpu_torch.parallel.launch``.

Each job takes one picklable payload, runs on its rank (torch and the port
only: a rank imports no JAX), and returns numpy values that the test, in
the parent process, holds against one process (the port's, or grl_tpu's).
"""

import threading

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from grl_tpu_torch import models as tm
from grl_tpu_torch import parallel
from grl_tpu_torch.data import get_data
from grl_tpu_torch.engine import Evaluator, Trainer, init_train_state, make_train_step, metrics, rerank
from grl_tpu_torch.nn import GlobalBatchNorm

WIDTH = 4


def port_models():
    """test_torch_train.py's tiny models."""
    cnn = tm.GRLModel(trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH))
    return cnn, tm.Siamese(input_num=cnn.num_feat, output_num=16), tm.SiameseVideo(input_num=cnn.num_feat)


def state_payload(state):
    """A port TrainState as numpy: every module's state_dict and the luts."""
    return {"models": {k: {n: v.detach().cpu().numpy().copy() for n, v in m.state_dict().items()}
                       for k, m in state.models.items()},
            "luts": {k: v.cpu().numpy().copy() for k, v in state.luts.items()}}


def state_from_payload(payload, dtype=torch.float32):
    """A fresh port TrainState (tiny models, CPU) holding ``payload``."""
    state = init_train_state(*port_models(), payload["luts"]["corr"].shape[0], num_feat=8 * WIDTH * 4,
                             device="cpu")
    for k, m in state.models.items():
        m.load_state_dict({n: torch.from_numpy(v) for n, v in payload["models"][k].items()}, strict=True)
    state.models.to(dtype)
    state.luts = {k: torch.from_numpy(v).to(dtype) for k, v in payload["luts"].items()}
    return state


def job_group_steps(payload):
    """The group step on this rank's slice of each batch; the state and
    metrics after every step."""
    mesh = parallel.data_mesh()
    dtype = getattr(torch, payload["dtype"])
    state = parallel.sharded_train_state(state_from_payload(payload["state"], dtype), mesh)
    step = make_train_step(device="cpu", mesh=mesh)
    out = []
    for clips, ids, lr in payload["batches"]:
        clips = torch.from_numpy(parallel.shard_batch(clips, mesh)).to(dtype)
        state, m = step(state, clips, parallel.shard_batch(ids, mesh), lr)
        out.append((state_payload(state), {k: float(v) for k, v in m.items()}))
    return out


def job_batchnorm(payload):
    """A GlobalBatchNorm in train mode on this rank's rows: output, input
    gradient, this rank's parameter gradients (of its share of the loss
    ``Σ y·w``) and the running statistics."""
    mesh = parallel.data_mesh()
    x = torch.from_numpy(parallel.shard_batch(payload["x"], mesh)).to(getattr(torch, payload["dtype"]))
    w = torch.from_numpy(parallel.shard_batch(payload["w"], mesh))
    bn = GlobalBatchNorm(x.shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in payload["bn"].items()})
    x.requires_grad_(True)
    y = bn(x)
    (y.float() * w).sum().backward()
    return {"y": y.detach().float().numpy(), "y_dtype": str(y.dtype), "x_grad": x.grad.float().numpy(),
            "w_grad": bn.weight.grad.numpy(), "b_grad": bn.bias.grad.numpy(),
            "stats": {k: v.numpy() for k, v in bn.state_dict().items()}}


class RecordingLoader:
    """Pass-through loader wrapper keeping the batches it yields, capped at
    ``limit`` steps (equally on every rank)."""

    def __init__(self, loader, limit):
        self.loader, self.dataset, self.limit = loader, loader.dataset, limit
        self.batches = []

    def __len__(self):
        return min(len(self.loader), self.limit)

    def __iter__(self):
        for i, (clips, pids, camids) in enumerate(self.loader):
            if i >= self.limit:
                break
            self.batches.append((np.array(clips), np.array(pids)))
            yield clips, pids, camids


class StepLosses:
    """The ScalarWriter surface, keeping each step's loss."""

    def __init__(self):
        self.steps = []

    def add_scalar(self, tag, value, step):
        if tag == "train/total_loss_step":
            self.steps.append(float(value))

    def flush(self):
        pass


def job_multiprocess_train(payload):
    """grl_tpu's multi-process regime (ranks launched with multihost=True):
    this rank's identity shard at the local batch, ``Trainer`` with the
    group step; the batches it loaded and the state it
    ended with."""
    mesh = parallel.data_mesh()
    assert mesh.multihost
    _, _, loader, _, _ = get_data("synthetic", batch_size=payload["local_batch"], seq_len=payload["seq_len"],
                                  workers=1, seed=0, dataset_kwargs=payload["catalog"], process_shard=True)
    rec = RecordingLoader(loader, payload["steps"])
    state = parallel.sharded_train_state(state_from_payload(payload["state"]), mesh)
    losses = StepLosses()
    trainer = Trainer(make_train_step(device="cpu", mesh=mesh), losses, seed=0, print_freq=1000, mesh=mesh)
    state, stats = trainer.train(0, state, rec, payload["lr"])
    return {"batches": rec.batches, "epoch_len": len(loader), "state": state_payload(state),
            "step_losses": losses.steps, "loss": stats["loss"]}


def record_data_path(loader, epochs, mesh=None):
    """``Trainer.train`` for ``epochs`` epochs of ``loader`` with a step that
    records what it is given: the augmented clips and the ids of each step."""
    record = []

    def step(state, clips, targets, lr):
        record.append((clips.numpy().copy(), np.asarray(targets).copy()))
        return state, {k: torch.zeros(()) for k in ("loss", "prec_uncorr", "prec_vid", "prec_frame")}

    trainer = Trainer(step, seed=0, print_freq=1000, device="cpu", mesh=mesh)
    for epoch in range(epochs):
        trainer.train(epoch, None, loader, 1e-3)
    return record


def job_data_path(payload):
    """The single-host data path of ``cli.train --devices N`` on this rank:
    ``get_data(batch_slice=)`` at the global batch (the CLI's seeding
    first), then the ``Trainer``'s augmentation of the slice
    (``augment(rows=)``); what each step received."""
    mesh = parallel.data_mesh()
    np.random.seed(0)
    b = payload["batch"] // mesh.size
    _, _, loader, _, _ = get_data("synthetic", batch_size=payload["batch"], seq_len=payload["seq_len"], workers=2,
                                  seed=0, dataset_kwargs=payload["catalog"],
                                  batch_slice=slice(mesh.rank * b, (mesh.rank + 1) * b))
    return record_data_path(loader, payload["epochs"], mesh)


class _Batches:
    def __init__(self, n, b):
        self.n, self.b, self.dataset = n, b, None

    def __len__(self):
        return self.n

    def __iter__(self):
        for _ in range(self.n):
            yield np.zeros((self.b, 1, 2, 2, 3), np.uint8), np.zeros(self.b, np.int32), np.zeros(self.b, np.int32)


def job_stop(payload):
    """``Trainer.train`` with a step that counts; rank ``payload["rank"]``
    sets its stop flag after step ``payload["after"]``. The steps each rank
    took, and whether its stop flag ended set."""
    mesh = parallel.data_mesh()
    stop = threading.Event()
    steps = []

    def step(state, clips, targets, lr):
        steps.append(len(steps))
        if mesh.rank == payload["rank"] and len(steps) == payload["after"]:
            stop.set()
        return state, {k: torch.zeros(()) for k in ("loss", "prec_uncorr", "prec_vid", "prec_frame")}

    trainer = Trainer(step, seed=0, stop_event=stop, print_freq=1000, mesh=mesh)
    epochs = 0
    for epoch in range(payload["epochs"]):
        trainer.train(epoch, None, _Batches(payload["steps"], 2), 1e-3)
        epochs += 1
        if stop.is_set():
            break
    return {"steps": len(steps), "epochs": epochs, "stopped": stop.is_set()}


def eval_models():
    cnn = tm.create("resnet50_grl", device="cpu", seed=0, trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), width=WIDTH))
    sia = tm.create("siamese", device="cpu", seed=1, input_num=cnn.num_feat, output_num=16)
    return cnn, sia


def job_evaluate(payload):
    """The striped ``Evaluator.evaluate`` (re-ranked) of this rank's stripes."""
    mesh = parallel.data_mesh()
    dataset, _, _, q, g = get_data("synthetic", seq_len=2, workers=1, only_eval=True,
                                   dataset_kwargs=payload["catalog"], eval_stripe=True)
    meta = {"query": parallel.eval_catalog_meta(dataset.query), "gallery": parallel.eval_catalog_meta(dataset.gallery)}
    res = Evaluator(*eval_models(), micro_batch=4, device="cpu", mesh=mesh, **payload["evaluator"]).evaluate(
        q, g, multihost=meta)
    return {"distmat": res.distmat.numpy(), "cmc": res.cmc, "mAP": res.mAP, "qf": res.qf.numpy(),
            "stripe": len(q.dataset)}


def job_collectives(payload):
    """The mesh's helpers on this rank: host gather and any, the store
    barrier, ``replicate`` and ``gather_striped_rows``."""
    mesh = parallel.data_mesh()
    out = {"gather": mesh.gather_host(np.array([mesh.rank, 10 + mesh.rank])),
           "any": [mesh.any_host(mesh.rank == 1), mesh.any_host(False)]}
    for _ in range(2):
        parallel.coordination_barrier("test", timeout_s=60)
    module = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(module.weight, float(mesh.rank))
    out["replicated"] = parallel.replicate(module, mesh).weight.detach().numpy()
    gf = torch.from_numpy(payload["gf"])
    stripe, n, _ = parallel.stripe_catalog(list(range(len(payload["gf"]))))
    out["striped"] = parallel.gather_striped_rows(gf[stripe], n, mesh).numpy()
    return out


def job_fail(payload):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    mesh = parallel.data_mesh()
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()


class ShapeSpy(TorchDispatchMode):
    """Records the shape of every tensor that an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes.update(tuple(t.shape) for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        return out


def job_rerank_sharded(payload):
    """On this rank: ``re_ranking(mesh=)`` of each case (its columns of c,
    the case's slab and block widths) with the shapes of every tensor the
    builder made; ``evaluate_device(mesh=)`` of each protocol case on its
    query rows; both blocks of ``sharded_cosine_distance``."""
    mesh = parallel.data_mesh()
    out = {"rerank": [], "protocol": []}
    for case in payload["rerank"]:
        rerank._MINPLUS_CHUNK, rerank._STAGE_BLOCK = case["chunk"], case["block"]
        c = case["c"]
        start, stop, _ = parallel.row_block(c.shape[0], mesh)
        box = [torch.from_numpy(np.ascontiguousarray(c[:, start:stop].T))]
        with ShapeSpy() as spy:
            got = rerank.re_ranking(inputs_box=box, query_num=case["q"], mesh=mesh, k1=case["k1"], k2=case["k2"],
                                    valid=case["valid"])
        out["rerank"].append({"distmat": got.numpy(), "shapes": spy.shapes, "box_emptied": box == []})
    for distmat, ids in payload["protocol"]:
        start, stop, _ = parallel.row_block(distmat.shape[0], mesh)
        out["protocol"].append(metrics.evaluate_device(torch.from_numpy(distmat[start:stop]), *ids, max_rank=20,
                                                       mesh=mesh))
    qf, gf = (torch.from_numpy(x) for x in payload["cosine"])
    out["cosine"] = [parallel.sharded_cosine_distance(qf, gf, mesh, axis=axis).numpy() for axis in (0, 1)]
    return out
