"""Config loading compatible with the reference ``config.yaml`` schema.

The port's copy of ``audio_to_sheet_music_tpu/config.py`` (the port imports
nothing of the JAX package): the same dataclasses, defaults and aliases.
PyYAML is imported inside ``load_config`` only, so the package imports
where it is not installed.

The reference loads a YAML file into a plain dict (`utils.py:18-23`) and reads
fields with per-callsite ``.get(key, default)`` (`src/train.py:308-353`).  We
keep the same on-disk schema (``data`` / ``model`` / ``training`` / ``wandb``
sections, see reference `config.yaml:1-48`) so existing configs drop in, but
centralise the defaults in one typed view instead of scattering them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Mapping


def load_config(path: str | Path) -> dict:
    """YAML file -> dict (reference `utils.py:18-23`)."""
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def _get(cfg: Mapping[str, Any], path: str, default: Any,
         allow_none: bool = False) -> Any:
    """Dotted-path lookup; missing keys -> ``default``.

    An explicit YAML ``null`` also maps to ``default`` unless
    ``allow_none=True`` (needed where null is meaningful, e.g.
    ``grad_clip: null`` disables clipping per the reference config's
    comment)."""
    node: Any = cfg
    for key in path.split("."):
        if not isinstance(node, Mapping) or key not in node:
            return default
        node = node[key]
    if node is None:
        return None if allow_none else default
    return node


@dataclasses.dataclass(frozen=True)
class DataConfig:
    train_dir: str = ""
    test_dir: str = ""
    segment_seconds: float = 6.0
    pct_train: float = 1.0
    pct_test: float = 1.0
    overlap: float = 0.1          # seconds, chunked-inference overlap
    sample_rate: int = 44100
    channels: int = 2
    # The reference hardcodes random segments for train datasets and ignores
    # its own config key (`src/train.py:431` vs `config.yaml:10`); we honor
    # the key, defaulting to the reference's effective behavior (True).
    random_segments: bool = True
    augment: bool = True
    cache_dir: str = ""           # decode-once cache of per-track arrays (new)

    @property
    def segment_samples(self) -> int:
        return int(self.segment_seconds * self.sample_rate)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "Audio-Text-HTDemucs"
    model_dim: int = 384
    text_dim: int = 512
    num_heads: int = 8
    device: str = "tpu"           # read by the JAX package only
    use_amp: bool = False         # reference flag; bf16 compute is below
    compute_dtype: str = "bfloat16"   # "bfloat16" | "float32"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "AdamW"
    lr: float = 1e-4
    weight_decay: float = 1e-2
    grad_clip: float | None = 5.0


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    batch_size: int = 8
    num_workers: int = 0
    num_epochs: int = 20
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    sdr_weight: float = 0.9
    sisdr_weight: float = 0.1
    use_L1_comb_loss: bool = False
    l1_sdr_weight: float = 1.0
    l1_weight: float = 0.1
    resume_from: str | None = None


@dataclasses.dataclass(frozen=True)
class WandbConfig:
    use_wandb: bool = False
    project: str = "audio-text-htdemucs"
    run_name: str | None = None
    log_every: int = 50
    validate_every: int = 1
    save_every: int = 5
    checkpoint_dir: str = "checkpoints"
    output_dir: str = "results"


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    wandb: WandbConfig = dataclasses.field(default_factory=WandbConfig)

    @staticmethod
    def from_dict(cfg: Mapping[str, Any]) -> "Config":
        d = DataConfig(
            train_dir=_get(cfg, "data.train_dir", ""),
            test_dir=_get(cfg, "data.test_dir", ""),
            segment_seconds=float(_get(cfg, "data.segment_seconds", 6.0)),
            pct_train=float(_get(cfg, "data.pct_train", 1.0)),
            pct_test=float(_get(cfg, "data.pct_test", 1.0)),
            overlap=float(_get(cfg, "data.overlap", 0.1)),
            sample_rate=int(_get(cfg, "data.sample_rate", 44100)),
            channels=int(_get(cfg, "data.channels", 2)),
            random_segments=bool(_get(cfg, "data.random_segments", True)),
            augment=bool(_get(cfg, "data.augment", True)),
            cache_dir=_get(cfg, "data.cache_dir", ""),
        )
        m = ModelConfig(
            name=_get(cfg, "model.name", "Audio-Text-HTDemucs"),
            model_dim=int(_get(cfg, "model.model_dim", 384)),
            text_dim=int(_get(cfg, "model.text_dim", 512)),
            num_heads=int(_get(cfg, "model.num_heads", 8)),
            device=_get(cfg, "model.device", "tpu"),
            use_amp=bool(_get(cfg, "model.use_amp", False)),
            compute_dtype=_get(cfg, "model.compute_dtype", "bfloat16"),
        )
        grad_clip = _get(cfg, "training.optimizer.grad_clip", 5.0,
                         allow_none=True)
        o = OptimizerConfig(
            name=_get(cfg, "training.optimizer.name", "AdamW"),
            lr=float(_get(cfg, "training.optimizer.lr", 1e-4)),
            weight_decay=float(_get(cfg, "training.optimizer.weight_decay", 1e-2)),
            grad_clip=None if grad_clip is None else float(grad_clip),
        )
        t = TrainingConfig(
            batch_size=int(_get(cfg, "training.batch_size", 8)),
            num_workers=int(_get(cfg, "training.num_workers", 0)),
            num_epochs=int(_get(cfg, "training.num_epochs", 20)),
            optimizer=o,
            # the reference schema's own (asymmetric) key names, with the
            # symmetric spellings accepted as aliases
            sdr_weight=float(_get(cfg, "training.loss_weights.sdr",
                                  _get(cfg, "training.loss_weights.sdr_weight",
                                       0.9))),
            sisdr_weight=float(_get(cfg, "training.loss_weights.sisdr_weight",
                                    _get(cfg, "training.loss_weights.sisdr",
                                         0.1))),
            use_L1_comb_loss=bool(_get(cfg, "training.use_L1_comb_loss", False)),
            l1_sdr_weight=float(_get(cfg, "training.L1_comb_loss.sdr_weight", 1.0)),
            l1_weight=float(_get(cfg, "training.L1_comb_loss.l1_weight", 0.1)),
            resume_from=_get(cfg, "training.resume_from", None) or None,
        )
        w = WandbConfig(
            use_wandb=bool(_get(cfg, "wandb.use_wandb", False)),
            project=_get(cfg, "wandb.project", "audio-text-htdemucs"),
            run_name=_get(cfg, "wandb.run_name", None) or None,
            log_every=int(_get(cfg, "wandb.log_every", 50)),
            validate_every=int(_get(cfg, "wandb.validate_every", 1)),
            save_every=int(_get(cfg, "wandb.save_every", 5)),
            checkpoint_dir=_get(cfg, "wandb.checkpoint_dir", "checkpoints"),
            output_dir=_get(cfg, "wandb.output_dir", "results"),
        )
        return Config(data=d, model=m, training=t, wandb=w)

    @staticmethod
    def from_yaml(path: str | Path) -> "Config":
        return Config.from_dict(load_config(path))
