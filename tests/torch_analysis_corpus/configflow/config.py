# corpus-rules: configflow
"""Corpus twin of the port's config module: a miniature dataclass tree
the configflow checker resolves sections and fields from, seeded with a
dead knob, an undocumented knob (absent from the sibling
docs/ANALYSIS.md table) and a preset typo."""

from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    use_pallas_sampler: bool = False
    use_pallas_beam: bool = False
    stale_knob: int = 3  # expect: CST-CFG-002


@dataclass
class TrainConfig:
    learning_rate: float = 2e-4
    beta1: float = 0.9
    grad_clip: float = 10.0
    undocumented_rate: float = 0.5  # expect: CST-CFG-003


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def preset_typo():
    c = Config()
    c.train.grad_clip = 5.0            # declared: fine
    c.train.learnig_rate = 1e-3  # expect: CST-CFG-004
    return c
