from .feature_store import (  # noqa: F401
    DynamicTieredFeatureSource,
    HBMFeatureSource,
    LabelSource,
    TieredFeatureSource,
)
