"""Typed experiment configuration with per-entry presets (a copy of
``grl_tpu/config.py``: the same dataclasses, fields, defaults and presets).

The CLIs are thin argparse façades over ``ExperimentConfig``: their flag
defaults come from here, and ``ExperimentConfig.from_args`` reads a parsed
namespace back into it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class DataConfig:
    dataset: str = "mars"
    data_dir: str = ""
    split: int = 0
    batch_size: int = 16          # anchor+positive pairs x 8 (mars_train.py:151)
    eval_batch_size: int = 30     # rrs_test loader (dataloader.py:65)
    seq_len: int = 8
    seq_srd: int = 4
    workers: int = 8
    height: int = 256
    width: int = 128


@dataclass
class ModelConfig:
    arch1: str = "resnet50_grl"
    arch2: str = "siamese"
    features: int = 2048
    dropout: float = 0.0
    bf16: bool = False
    tiny: bool = False


@dataclass
class LossConfig:
    oim_scalar: float = 30.0
    oim_momentum: float = 0.5
    verif_weight: float = 20.0    # trainer.py:165
    triplet_margin: str = "soft"


@dataclass
class OptimConfig:
    lr: float = 1e-3
    lr_step: int = 15             # x0.1 every 15 epochs (mars_train.py:110-114)
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = True
    backbone_lr_mult: float = 1.0
    new_params_lr_mult: float = 2.0


@dataclass
class EvalConfig:
    micro_batch: int = 96         # descriptor chunking (the reference fixes 8, attevaluator.py:74)
    rerank: bool = False
    rerank_k1: int = 20
    rerank_k2: int = 6
    rerank_lambda: float = 0.3
    cmc_topk: tuple = (1, 5, 10, 20)


@dataclass
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    epochs: int = 60
    start_epoch: int = 0
    seed: int = 0
    logs_dir: str = "log/grl"

    def replace(self, **sections):
        return dataclasses.replace(self, **sections)

    @classmethod
    def from_args(cls, args):
        """Build a typed config from a CLI argparse namespace (unknown
        attributes are ignored)."""
        cfg = cls()
        a = vars(args)

        def take(obj, field_name):
            if field_name in a:
                setattr(obj, field_name, a[field_name])

        for name in ("dataset", "data_dir", "split", "batch_size", "seq_len", "seq_srd", "workers"):
            take(cfg.data, name)
        for name in ("arch1", "arch2", "features", "dropout", "bf16", "tiny"):
            take(cfg.model, name)
        for name in ("oim_scalar", "oim_momentum"):
            take(cfg.loss, name)
        for name in ("lr", "lr_step", "momentum", "weight_decay"):
            take(cfg.optim, name)
        take(cfg.eval, "rerank")
        for name in ("epochs", "start_epoch", "seed", "logs_dir"):
            take(cfg, name)
        return cfg


def mars_train_preset():
    """Reference mars_train.py defaults."""
    return ExperimentConfig()


def test_all_preset():
    """Reference test_all.py *intended* defaults (bugs fixed)."""
    cfg = ExperimentConfig(seed=1)
    cfg.data.batch_size = 1
    return cfg


def duke_preset():
    cfg = ExperimentConfig()
    cfg.data.dataset = "duke"
    return cfg


def synthetic_smoke_preset():
    cfg = ExperimentConfig(epochs=5)
    cfg.data.dataset = "synthetic"
    cfg.data.batch_size = 4
    cfg.data.seq_len = 4
    cfg.model.tiny = True
    return cfg


PRESETS = {
    "mars": mars_train_preset,
    "test_all": test_all_preset,
    "duke": duke_preset,
    "synthetic_smoke": synthetic_smoke_preset,
}
