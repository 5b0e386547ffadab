from .feature_store import HBMFeatureSource, LabelSource  # noqa: F401
