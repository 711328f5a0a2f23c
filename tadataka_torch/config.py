"""Configuration tree for every pipeline (counterpart of
``tadataka_tpu/config.py``, the same classes, defaults and JSON text).

The reference has no config system — every knob is a constructor kwarg with
a hardcoded default scattered across modules (SURVEY.md §5).  Here one
serializable dataclass tree owns them; pipelines accept a config object and
everything round-trips through JSON for experiment tracking.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class FeatureConfig:
    max_keypoints: int = 512
    fast_threshold: float = 50.0 / 255.0
    brief_patch_size: int = 64
    brief_descriptor_size: int = 512
    match_max_ratio: float = 0.8
    ransac_trials: int = 128
    ransac_residual_threshold: float = 1.0


@dataclass
class DvoConfig:
    n_coarse_to_fine: int = 5
    max_iter: int = 20
    layer_size_ratio: float = 1.5
    weights: Optional[str] = "huber"  # none|tukey|student-t|huber


@dataclass
class SemiDenseConfig:
    min_depth: float = 60.0
    max_depth: float = 1000.0
    geo_coeff: float = 0.01
    photo_coeff: float = 0.01
    ref_step_size: float = 0.01
    min_gradient: float = 0.2
    n_ref_samples: int = 64
    default_depth: float = 200.0
    default_variance: float = 100.0
    uncertainty_bias: float = 1.0
    history_size: int = 8
    regularize: bool = True


@dataclass
class BaConfig:
    max_iter: int = 5
    initial_mu: float = 1.0
    nu: float = 100.0
    absolute_error_threshold: float = 1e-9
    relative_error_threshold: float = 0.20


@dataclass
class FeatureVOConfig:
    window_size: int = 8
    min_matches: int = 60
    pnp_threshold: float = 0.005
    features: FeatureConfig = field(default_factory=FeatureConfig)
    ba: BaConfig = field(default_factory=BaConfig)


@dataclass
class PipelineConfig:
    """Root config."""
    dvo: DvoConfig = field(default_factory=DvoConfig)
    semi_dense: SemiDenseConfig = field(default_factory=SemiDenseConfig)
    feature_vo: FeatureVOConfig = field(default_factory=FeatureVOConfig)

    def to_json(self, path=None):
        text = json.dumps(dataclasses.asdict(self), indent=2)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_json(cls, path_or_text):
        try:
            data = json.loads(path_or_text)
        except (json.JSONDecodeError, ValueError):
            with open(path_or_text) as f:
                data = json.load(f)
        return _from_dict(cls, data)


def _from_dict(cls, data):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(value, dict):
            value = _from_dict(f.type, value)
        elif isinstance(value, dict) and f.default_factory is not dataclasses.MISSING:  # noqa: E501
            value = _from_dict(type(f.default_factory()), value)
        kwargs[f.name] = value
    return cls(**kwargs)
