from morphganformer_tpu_torch.metrics.core import (  # noqa: F401
    compute_fid_from_stats,
    compute_is_from_probs,
    compute_kid_from_features,
    compute_pr_from_features,
    frechet_distance,
    lerp,
    slerp,
)
from morphganformer_tpu_torch.metrics.feature_stats import FeatureStats  # noqa: F401
from morphganformer_tpu_torch.metrics.registry import (  # noqa: F401
    compute_metric,
    is_valid_metric,
    list_valid_metrics,
    register_metric,
    report_metric,
)
